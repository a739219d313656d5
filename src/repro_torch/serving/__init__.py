"""Serving engine, tiered cluster and samplers of the port."""
