"""Renderers: the plain BEV rasterizer and its CUDA kernel."""
