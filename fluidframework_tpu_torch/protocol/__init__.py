"""Wire and stamp contracts (the port's own copies)."""
