"""Tier specs, offload runtime and the MIKU control plane of the port."""
