"""Layers, attention and the dense decoder of the port."""
