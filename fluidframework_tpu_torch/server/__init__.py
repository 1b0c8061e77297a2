"""Server-side durability: the per-document checkpoint store."""
