"""Checkpointing (the port of ``repro.checkpoint``)."""
