"""Runtime layer: the scribe's summary-ack records (``summary``)."""
