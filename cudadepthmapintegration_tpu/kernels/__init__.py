"""Hand-written GPU kernels for the hot ops."""
