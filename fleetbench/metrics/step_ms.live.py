from fleetbench.readers import step_ms as read  # noqa: F401
