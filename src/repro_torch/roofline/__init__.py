"""Three-term roofline of the port: hardware models and per-device op costs."""
