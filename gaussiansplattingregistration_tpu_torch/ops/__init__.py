"""Geometry, SH and rasterizer ops (torch) and the CUDA compositor."""
