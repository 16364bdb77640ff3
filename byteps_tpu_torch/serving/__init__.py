"""Paged continuous-batching serving (the port's first slice)."""

from .blocks import (BlockAllocator, BlocksExhaustedError, BlockTable,
                     PagedSlotPool, init_paged_cache)
from .engine import Request, RequestState, ServingEngine, resolve_device
from .frontend import (RemoteServeClient, ServeClient, ServeConnectionError,
                       ServeFrontend, ServeReplyError, serve, serve_from_env)
from .metrics import ServeMetrics, get_serve_metrics
from .scheduler import AdmissionError, QueueFullError, ServeScheduler
from .slots import SlotPool

__all__ = ["AdmissionError", "BlockAllocator", "BlockTable",
           "BlocksExhaustedError", "PagedSlotPool", "QueueFullError",
           "RemoteServeClient", "Request", "RequestState", "ServeClient",
           "ServeConnectionError", "ServeFrontend", "ServeMetrics",
           "ServeReplyError", "ServeScheduler", "ServingEngine", "SlotPool",
           "get_serve_metrics", "init_paged_cache", "resolve_device",
           "serve", "serve_from_env"]
