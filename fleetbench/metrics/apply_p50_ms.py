from fleetbench.readers import latency_ms

read = latency_ms(0.50)
