"""Driver layer: the local-service provider seam (``service_registry``).
The drivers of ``fluidframework_tpu/driver/`` are not ported (ROADMAP
queue 1 item 7)."""
