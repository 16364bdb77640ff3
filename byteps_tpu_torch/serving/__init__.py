"""Paged continuous-batching serving: the engine, its fp / int8 /
tensor-parallel block pools, the radix prefix cache, speculative
decoding and the TCP tier."""

from .blocks import (BlockAllocator, BlocksExhaustedError, BlockTable,
                     PagedSlotPool, init_paged_cache)
from .engine import Request, RequestState, ServingEngine, resolve_device
from .frontend import (RemoteServeClient, ServeClient, ServeConnectionError,
                       ServeFrontend, ServeReplyError, serve, serve_from_env)
from .metrics import ServeMetrics, get_serve_metrics
from .prefix import PagedPrefixCache, weights_fingerprint
from .scheduler import AdmissionError, QueueFullError, ServeScheduler
from .slots import SlotPool
from .spec import NgramProposer

__all__ = ["AdmissionError", "BlockAllocator", "BlockTable",
           "BlocksExhaustedError", "NgramProposer", "PagedPrefixCache",
           "PagedSlotPool", "QueueFullError",
           "RemoteServeClient", "Request", "RequestState", "ServeClient",
           "ServeConnectionError", "ServeFrontend", "ServeMetrics",
           "ServeReplyError", "ServeScheduler", "ServingEngine", "SlotPool",
           "get_serve_metrics", "init_paged_cache", "resolve_device",
           "serve", "serve_from_env", "weights_fingerprint"]
