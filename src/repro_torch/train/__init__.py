"""The training loop (the port of ``repro.train``)."""
