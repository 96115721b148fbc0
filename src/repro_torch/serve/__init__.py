"""Serving subsystem: static-batch reference engine, continuous-batching
engine, and the slot and page allocators they share."""

from repro_torch.serve.engine import (ContinuousEngine, Engine, Request,
                                      ServeConfig)
from repro_torch.serve.slots import SlotPool

__all__ = ["ContinuousEngine", "Engine", "Request", "ServeConfig",
           "SlotPool"]
