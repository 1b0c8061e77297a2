from fleetbench.readers import program_roofline as read  # noqa: F401
