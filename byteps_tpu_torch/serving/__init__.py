"""Continuous-batching serving: the engine over dense slot rows or its
fp / int8 / tensor-parallel block pools, the row-copy and radix prefix
caches, speculative decoding, the TCP tier (cancel, router epochs) and
the disaggregated prefill/decode KV ship."""

from .blocks import (BlockAllocator, BlocksExhaustedError, BlockTable,
                     PagedSlotPool, init_paged_cache)
from .disagg import (KVShipAbortedError, KVShipDigestError, KVShipError,
                     KVShipGeometryError, KVShipSequenceError, KVStager,
                     pool_geometry, ship_parked)
from .engine import (EpochFencedError, Request, RequestState, ServingEngine,
                     resolve_device)
from .frontend import (OP_CANCEL, OP_JOURNAL, OP_KV_BLOCKS, OP_PING,
                       OP_STATS, OP_STREAM, OP_SUBMIT, RemoteServeClient,
                       ServeClient, ServeConnectionError, ServeFrontend,
                       ServeReplyError, serve, serve_from_env)
from .metrics import ServeMetrics, get_serve_metrics
from .prefix import PagedPrefixCache, PrefixCache, weights_fingerprint
from .scheduler import AdmissionError, QueueFullError, ServeScheduler
from .slots import SlotPool
from .spec import NgramProposer

__all__ = ["AdmissionError", "BlockAllocator", "BlockTable",
           "BlocksExhaustedError", "EpochFencedError", "KVShipAbortedError",
           "KVShipDigestError", "KVShipError", "KVShipGeometryError",
           "KVShipSequenceError", "KVStager", "NgramProposer", "OP_CANCEL",
           "OP_JOURNAL", "OP_KV_BLOCKS", "OP_PING", "OP_STATS", "OP_STREAM",
           "OP_SUBMIT", "PagedPrefixCache", "PagedSlotPool", "PrefixCache",
           "QueueFullError", "RemoteServeClient", "Request", "RequestState",
           "ServeClient", "ServeConnectionError", "ServeFrontend",
           "ServeMetrics", "ServeReplyError", "ServeScheduler",
           "ServingEngine", "SlotPool", "get_serve_metrics",
           "init_paged_cache", "pool_geometry", "resolve_device", "serve",
           "serve_from_env", "ship_parked", "weights_fingerprint"]
