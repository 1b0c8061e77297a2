from fleetbench.readers import window_rate as read  # noqa: F401
