"""Horovod-style process API — the port's single-process subset of
``byteps_tpu/api.py``.

``init``, ``shutdown``, ``size``, ``rank``, ``local_rank``,
``local_size`` and ``broadcast_parameters`` for one process driving one
GPU: the world has one worker, so ``size() == 1`` and broadcasting is
the identity.  A multi-worker launch (``DMLC_NUM_WORKER > 1``) and
launcher local ranks other than 0 of 1 are refused until the port has
its collectives slice (``torch.distributed``); push_pull,
declare and the eager engine come with them.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from .common import logging as bps_log
from .common.config import get_config, reset_config
from .common.device import resolve_device

__all__ = ["init", "shutdown", "size", "rank", "local_rank", "local_size",
           "device", "broadcast_parameters"]


class _GlobalState:
    def __init__(self):
        self.initialized = False
        self.device: Optional[torch.device] = None
        self.lock = threading.Lock()


_state = _GlobalState()


def init(device=None) -> None:
    """Initialize the process (idempotent).  ``device`` defaults to
    ``cuda`` and raises without a GPU unless the caller passes
    ``device="cpu"``.  Refuses the multi-worker knobs this slice does
    not port."""
    with _state.lock:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if _state.initialized:
            if dev != _state.device:
                raise ValueError(f"already initialized on {_state.device}, "
                                 f"not {dev}; call shutdown() first")
            return
        cfg = get_config()
        if cfg.num_worker > 1:
            raise NotImplementedError(
                f"DMLC_NUM_WORKER={cfg.num_worker}: the port runs one "
                f"worker until its collectives slice (torch.distributed) "
                f"lands; use byteps_tpu for multi-worker runs")
        if cfg.local_rank not in (None, 0):
            raise ValueError(
                f"BYTEPS_LOCAL_RANK={cfg.local_rank} but this run has a "
                f"single process. Unset BYTEPS_LOCAL_RANK (or set it to 0).")
        if cfg.local_size not in (None, 1):
            raise ValueError(
                f"BYTEPS_LOCAL_SIZE={cfg.local_size}: the port drives one "
                f"GPU per process and has no colocated workers yet")
        _state.device = dev
        _state.initialized = True
        bps_log.info("byteps_tpu_torch initialized: 1 worker on %s", dev)


def shutdown() -> None:
    with _state.lock:
        _state.initialized = False
        _state.device = None
        reset_config()


def _require_init() -> None:
    if not _state.initialized:
        raise RuntimeError("call byteps_tpu_torch.api.init() first")


def size() -> int:
    """World size: one worker."""
    _require_init()
    return 1


def rank() -> int:
    _require_init()
    return 0


def local_rank() -> int:
    _require_init()
    return 0


def local_size() -> int:
    _require_init()
    return 1


def device() -> torch.device:
    """The device this worker runs on."""
    _require_init()
    return _state.device


def broadcast_parameters(params, root_rank: int = 0):
    """Root's parameters on every worker: with one worker, ``params``
    itself (a module, a state dict or any tree of tensors)."""
    _require_init()
    if root_rank != 0:
        raise ValueError(f"root_rank {root_rank} is not a worker of this "
                         f"1-worker world")
    return params
