"""Pallas kernels (Triton route, GPU) for the hot ops."""
