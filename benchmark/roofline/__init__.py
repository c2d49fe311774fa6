"""Operation and byte counts of the kernels, and the peaks."""
