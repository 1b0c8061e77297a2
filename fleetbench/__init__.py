"""The benchmark of fluidframework_tpu_torch: one command, cells made of
data files (``configs/``, ``traffic/``, ``workloads/``), one reader a
metric (``metrics/``), plain references (``reference/``).  See
``run.py``."""
