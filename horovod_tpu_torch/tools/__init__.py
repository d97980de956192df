"""Tooling: the online autotuner."""
