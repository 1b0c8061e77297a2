"""Host replicas and the summary codec: the oracle merge tree, the
obliterate-place validator and the DocState <-> summary converters."""
