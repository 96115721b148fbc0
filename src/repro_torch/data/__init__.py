"""Synthetic training data (the port of ``repro.data``)."""
