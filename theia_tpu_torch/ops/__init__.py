"""Geometry kernels and math helpers of the PyTorch port."""
