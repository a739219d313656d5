"""The plain reference: the served models' forward pass in float32 plain
PyTorch, independent of the port (it imports nothing of ``repro_torch``,
``repro`` or ``jax``)."""
