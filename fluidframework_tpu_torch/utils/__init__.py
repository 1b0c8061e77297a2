"""Host-side health counters and latency histograms."""
