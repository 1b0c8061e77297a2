"""SharedTree's host algebra and fold, as the tree fleet engine uses them.

The port's copies of the JAX package's JAX-free ``dds/tree`` modules:
``forest`` (object forest, ``Node``, ``UniformChunk``), ``changeset`` (marks,
rebase, compose, apply, the wire codec), ``field_kinds``, ``mark_pool`` (the
pooled columnar fold), ``editmanager`` (trunk construction) and the leaf
helpers of ``schema``.  The device half is ``ops/tree_kernel.py``.
"""
