"""Device kernels of the port: the merge-tree fleet program and K1."""
