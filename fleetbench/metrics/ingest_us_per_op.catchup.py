from fleetbench.readers import ingest_us_per_op as read  # noqa: F401
