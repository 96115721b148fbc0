"""The optimizer (the port of ``repro.optim``)."""
