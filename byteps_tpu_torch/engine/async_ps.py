"""Asynchronous parameter-server mode (reference ``BYTEPS_ENABLE_ASYNC``)
— the port of ``byteps_tpu/engine/async_ps.py``.

Reference semantics (torch/__init__.py:174-189, docs/env.md
"Asynchronous training"): each worker runs its *local* optimizer step,
pushes the resulting **weight delta** (new - last pulled) to server
processes which add it into the global weights, and pulls back the
current global state — no global barrier, so fast workers never wait
for stragglers; gradients are applied stale.

Three deployment shapes, as in the JAX package:

  * in-process: ``AsyncParameterServer`` (one shard) for threads sharing
    a process;
  * in-process sharded: ``ShardedParameterStore`` splits the keyspace
    over ``DMLC_NUM_SERVER`` shards with the reference's key->server
    placement (global.cc:305-334, ``common.context.ServerSharder``);
  * cross-process: ``engine.ps_server`` runs a shard as a TCP server
    process (the launcher's ``server`` role) and ``RemoteStore`` is the
    client with the same interface as the in-process stores.

The summation runs in the port's native C++ reducer (``native/``,
OpenMP; the reference's cpu_reducer.cc role).  ``use_native=True``
raises when the library cannot be built; ``use_native=False`` is the
explicit numpy path.

The store holds numpy arrays, and bfloat16 tensors as CPU
``torch.Tensor`` (numpy has no bfloat16 in the port); both sum through
the same library loops as the JAX package's store.

Staleness contract: after any sequence of interleaved worker push_pulls,
global_state == initial + sum of all pushed deltas; a worker's pull
reflects at least its own past pushes (read-your-writes).
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..common import logging as bps_log

__all__ = ["AsyncParameterServer", "ShardedParameterStore", "AsyncWorker",
           "get_async_store", "set_async_store", "reset_async_store",
           "close_async_store"]


def _host(x):
    """A value as the store holds it: numpy, or a CPU tensor when bf16."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.cpu()
        return x.cpu().numpy()
    return np.asarray(x)


def _copy(x):
    return x.clone() if isinstance(x, torch.Tensor) else np.array(x,
                                                                  copy=True)


def _like(delta, dst):
    """``delta`` in ``dst``'s dtype and kind (numpy's cast, or torch's
    round-to-nearest-even to bf16, as ``ml_dtypes`` casts)."""
    if isinstance(dst, torch.Tensor):
        d = delta if isinstance(delta, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(delta))
        return d.to(dst.dtype)
    if isinstance(delta, torch.Tensor):
        delta = delta.float().numpy()
    return np.asarray(delta, dst.dtype)


class AsyncParameterServer:
    """Host-side global parameter store summing weight deltas.

    One buffer per declared tensor; ``push_pull`` is atomic per tensor
    (mutex), matching the reference server's per-key atomic updates.
    ``sum_bytes`` / ``sum_seconds`` count the bytes summed and the time
    the sums took (the shard's summation rate)."""

    def __init__(self, use_native: bool = True):
        self._store: Dict[str, Any] = {}
        self._locks: Dict[str, threading.Lock] = {}
        self._global_lock = threading.Lock()
        self._version: Dict[str, int] = {}
        self._reducer = None
        if use_native:
            from ..native import reducer as native_reducer

            native_reducer.load()  # raises when it cannot be built
            self._reducer = native_reducer
        self.sum_bytes = 0
        self.sum_seconds = 0.0
        self._sum_lock = threading.Lock()

    @property
    def reducer(self) -> str:
        """``native`` (the C++ OpenMP loops) or ``numpy``."""
        return "native" if self._reducer is not None else "numpy"

    # -------------------------------------------------------------- tensors

    def init_tensor(self, name: str, value) -> int:
        """First-push-wins initialization (reference InitTensor's blocking
        initial push, operations.cc:262-284).  Returns the tensor's
        version (0 when this call created it)."""
        return self.init_tensor_info(name, value)[0]

    def init_tensor_info(self, name: str, value):
        """(version, created): a first-push-wins loser must be told the
        winning value, and the creator need not be echoed its own."""
        with self._global_lock:
            created = name not in self._store
            if created:
                self._store[name] = _copy(_host(value))
                self._locks[name] = threading.Lock()
                self._version[name] = 0
            return self._version[name], created

    def set_tensor(self, name: str, value) -> int:
        """Force-overwrite — the failover/failback re-seed (OP_SET).
        Creates the tensor when absent (version 0); otherwise advances
        the version with the overwrite."""
        with self._global_lock:
            if name not in self._store:
                self._store[name] = _copy(_host(value))
                self._locks[name] = threading.Lock()
                self._version[name] = 0
                return 0
            lock = self._locks[name]
        with lock:
            self._store[name] = _copy(_host(value))
            self._version[name] += 1
            return self._version[name]

    def _accumulate(self, dst, delta) -> None:
        t0 = time.perf_counter()
        if self._reducer is not None:
            self._reducer.sum_into(dst, delta)
        else:
            dst += delta
        dt = time.perf_counter() - t0
        with self._sum_lock:
            self.sum_seconds += dt
            self.sum_bytes += dst.nbytes

    def push_delta(self, name: str, delta) -> int:
        """Add a delta; returns the post-push version (atomic with the
        add — the wire tier's idempotence guard needs the two paired)."""
        with self._locks[name]:
            dst = self._store[name]
            self._accumulate(dst, _like(delta, dst))
            self._version[name] += 1
            return self._version[name]

    def pull(self, name: str):
        with self._locks[name]:
            return _copy(self._store[name])

    def push_pull(self, name: str, delta):
        """Atomic add-then-read (the reference's paired ZPush/ZPull per
        key, core_loops.cc:430-502)."""
        return self.push_pull_versioned(name, delta)[0]

    def push_pull_versioned(self, name: str, delta):
        """(global value, post-op version) under one lock acquisition."""
        with self._locks[name]:
            dst = self._store[name]
            self._accumulate(dst, _like(delta, dst))
            self._version[name] += 1
            return _copy(dst), self._version[name]

    def version(self, name: str) -> int:
        with self._locks[name]:
            return self._version[name]

    def names(self) -> List[str]:
        with self._global_lock:
            return list(self._store)


class ShardedParameterStore:
    """Keyspace-sharded store: ``num_shards`` independent
    ``AsyncParameterServer`` shards with reference-compatible placement
    (``(((key>>16)+key%65536)*9973) % num_shards``, or hash under
    ``use_hash`` — global.cc:305-334).  Same interface as one shard."""

    def __init__(self, num_shards: int = 1, use_hash: bool = False,
                 use_native: bool = True):
        from ..common.context import ServerSharder

        self.num_shards = max(1, int(num_shards))
        self._shards = [AsyncParameterServer(use_native=use_native)
                        for _ in range(self.num_shards)]
        self._sharder = ServerSharder(self.num_shards, use_hash=use_hash)

    def shard_of(self, name: str, nbytes: int = 0) -> int:
        """Name-derived key -> shard (load-accounted like the reference's
        per-server byte log); independent of declaration order."""
        from ..common.context import name_key

        return self._sharder.place(name_key(name), nbytes)

    def init_tensor(self, name: str, value) -> int:
        return self._shards[self.shard_of(name)].init_tensor(name, value)

    def set_tensor(self, name: str, value) -> int:
        return self._shards[self.shard_of(name)].set_tensor(name, value)

    def init_tensor_info(self, name: str, value):
        return self._shards[self.shard_of(name)].init_tensor_info(name,
                                                                  value)

    def push_pull_versioned(self, name: str, delta):
        d = _host(delta)
        return self._shards[self.shard_of(name, d.nbytes)] \
            .push_pull_versioned(name, d)

    def push_delta(self, name: str, delta) -> int:
        d = _host(delta)
        return self._shards[self.shard_of(name, d.nbytes)].push_delta(
            name, d)

    def pull(self, name: str):
        return self._shards[self.shard_of(name)].pull(name)

    def push_pull(self, name: str, delta):
        d = _host(delta)
        return self._shards[self.shard_of(name, d.nbytes)].push_pull(
            name, d)

    def version(self, name: str) -> int:
        return self._shards[self.shard_of(name)].version(name)

    def names(self) -> List[str]:
        out: List[str] = []
        for s in self._shards:
            out.extend(s.names())
        return out

    def load(self) -> List[int]:
        """Accumulated bytes per shard (reference global.cc:322-325)."""
        return self._sharder.load()


_default_store: Optional[Any] = None
_default_store_lock = threading.Lock()


def get_async_store():
    """Process-default store for async-PS mode, from the env contract:

    * ``BYTEPS_SERVER_ADDRS`` (or ``DMLC_PS_ROOT_URI`` + ``DMLC_NUM_SERVER``
      under ``BYTEPS_ENABLE_ASYNC``) set -> ``RemoteStore`` over the TCP
      server tier (engine.ps_server);
    * otherwise -> an in-process ``ShardedParameterStore`` with
      ``DMLC_NUM_SERVER`` shards and ``BYTEPS_USE_HASH_KEY`` placement.
    """
    global _default_store
    with _default_store_lock:
        if _default_store is None:
            from ..common.config import get_config

            cfg = get_config()
            addrs = _server_addrs_from_env()
            if addrs:
                from .ps_server import RemoteStore

                _default_store = RemoteStore(addrs,
                                             use_hash=cfg.use_hash_key)
            else:
                _default_store = ShardedParameterStore(
                    num_shards=cfg.num_server, use_hash=cfg.use_hash_key)
        return _default_store


def set_async_store(store) -> None:
    global _default_store
    with _default_store_lock:
        _default_store = store


def reset_async_store() -> None:
    set_async_store(None)


def close_async_store() -> None:
    """Detach AND close the process-default store atomically: a
    ``RemoteStore`` owns per-shard wire workers and a heartbeat thread,
    which dropping the reference would leak.  Swap-then-close under the
    lock, so a concurrent ``get_async_store`` sees the old (still open)
    store or builds a fresh one, never a closed one."""
    global _default_store
    with _default_store_lock:
        store, _default_store = _default_store, None
    if store is not None and hasattr(store, "close"):
        try:
            store.close()
        except Exception as e:  # never mask shutdown on a dead server
            bps_log.debug("async store close: %s", e)


def _server_addrs_from_env() -> List[str]:
    """Worker-side server discovery: ``BYTEPS_SERVER_ADDRS``
    ("host:port,host:port"), else derived from the DMLC contract the way
    the reference's ps-lite rendezvous hands out server ports (root port
    + 100 + server index) when async mode is on."""
    import os

    from ..common.config import get_config

    cfg = get_config()
    if cfg.server_addrs:
        return [a.strip() for a in cfg.server_addrs.split(",")
                if a.strip()]
    uri = os.environ.get("DMLC_PS_ROOT_URI", "")
    nserver = int(os.environ.get("DMLC_NUM_SERVER", "0") or "0")
    if uri and nserver > 0 and cfg.enable_async:
        root = int(os.environ.get("DMLC_PS_ROOT_PORT", "1234"))
        return [f"{uri}:{root + 100 + i}" for i in range(nserver)]
    return []


def _leaves(params) -> list:
    """An ``nn.Module``'s parameters in module order, or a list of
    tensors / arrays as given."""
    if hasattr(params, "parameters") and callable(params.parameters):
        return list(params.parameters())
    return list(params)


class AsyncWorker:
    """Per-worker view implementing the reference's async training loop.

    Usage (mirrors torch/__init__.py:174-189)::

        worker = AsyncWorker(server, model)        # registers + pulls
        for step:
            local_optimizer_step(model, batch)
            pulled = worker.push_pull(model)       # delta push, global pull

    ``params`` is an ``nn.Module`` (its parameters, in module order) or a
    list of tensors or arrays; the leaves are named ``param_{i}`` in that
    order, as the JAX ``AsyncWorker`` names a flax tree's leaves in
    flax's order — so a JAX worker and a port worker do not share one
    store (the names would pair different tensors).  Values on the wire
    and in the store are host arrays: fp32 leaves as numpy, bf16 leaves
    as CPU tensors.
    """

    def __init__(self, server, params, worker_id: int = 0):
        self.server = server
        self.worker_id = worker_id
        leaves = [_host(l) for l in _leaves(params)]
        self._names = [f"param_{i}" for i in range(len(leaves))]
        for name, leaf in zip(self._names, leaves):
            server.init_tensor(name, leaf)
        # the state this worker last pulled: deltas are taken against it
        self._snapshot = [_copy(l) for l in leaves]
        self.params = self._snapshot
        # pipelined exchange (begin_push_pull / take_result)
        self._thread: Optional[threading.Thread] = None
        self._jobs: Optional[queue_mod.Queue] = None
        self._job: Optional[dict] = None
        self._pinned: Optional[list] = None   # D2H landing buffers
        self._stream = None                   # the exchange's CUDA stream
        self.exchange_seconds: List[float] = []

    def _exchange(self, leaves) -> list:
        pulled = []
        for name, new, snap in zip(self._names, leaves, self._snapshot):
            pulled.append(_host(self.server.push_pull(name, new - snap)))
        # every store hands out fresh buffers, so the pulled leaves are
        # the snapshot itself (callers must not write into them)
        self._snapshot = pulled
        self.params = pulled
        return pulled

    def push_pull(self, new_params) -> list:
        """Push this worker's delta against its last pull, pull the
        global state; returns the pulled leaves (host arrays)."""
        if self._job is not None:
            # both paths read/write the snapshot; mixing them while an
            # exchange flies would double-push the shared delta
            raise RuntimeError("a pipelined exchange is in flight; "
                               "take_result() before a synchronous push_pull")
        return self._exchange([_host(l) for l in _leaves(new_params)])

    # ------------------------------------------------- pipelined exchange

    def begin_push_pull(self, device_params) -> None:
        """Start an exchange in the background: the exchange thread copies
        the given leaves to the host, pushes the delta against the last
        snapshot, pulls the global state, and parks the result for
        :meth:`take_result`.  ``device_params`` must be copies the train
        thread does not mutate (the trainer passes clones); on CUDA the
        copy to the host runs on a stream of the exchange thread's own,
        after an event recorded here on the caller's stream, so the train
        thread never waits on it."""
        if self._job is not None:
            raise RuntimeError("an exchange is already in flight; "
                               "take_result() first")
        self._ensure_thread()
        leaves = _leaves(device_params)
        event = None
        if leaves and isinstance(leaves[0], torch.Tensor) \
                and leaves[0].is_cuda:
            event = torch.cuda.Event()
            event.record()
        job = {"params": leaves, "event": event, "done": threading.Event(),
               "pulled": None, "submitted": None, "delta": None,
               "delta_event": None, "error": None}
        self._job = job
        self._jobs.put(job)

    def exchange_in_flight(self) -> bool:
        return self._job is not None

    def take_result(self, timeout: Optional[float] = 120.0):
        """Wait for the in-flight exchange; returns ``(pulled,
        submitted)`` lists of host arrays, or None when nothing is in
        flight.  ``submitted`` is valid until the next
        :meth:`begin_push_pull` (CUDA leaves land in reused pinned
        buffers).

        The caller adopts with the catch-up rule
        ``params += pulled - submitted``: the worker kept training while
        the exchange flew, so the pulled state lacks its local progress
        since the submit; adding the difference folds the global update
        into the current params without losing that work."""
        job = self._take(timeout)
        return None if job is None else (job["pulled"], job["submitted"])

    def take_delta(self, timeout: Optional[float] = 120.0):
        """Wait for the in-flight exchange; returns the catch-up term
        ``pulled - submitted`` of each leaf, in its dtype (on the host
        for host leaves; for CUDA leaves already on the device, written by the
        exchange thread into the clones it was given, with the current
        stream made to wait for that copy), or None when nothing is in
        flight."""
        job = self._take(timeout)
        if job is None:
            return None
        if job["delta_event"] is not None:
            torch.cuda.current_stream().wait_event(job["delta_event"])
        return job["delta"]

    def _take(self, timeout):
        job, self._job = self._job, None
        if job is None:
            return None
        if not job["done"].wait(timeout):
            self._job = job  # still in flight; the caller may retry
            raise TimeoutError("async-PS exchange did not complete")
        if job["error"] is not None:
            raise job["error"]
        return job

    def _ensure_thread(self) -> None:
        if self._thread is None:
            self._jobs = queue_mod.Queue()
            self._thread = threading.Thread(
                target=self._exchange_loop,
                name=f"bps-async-ps-{self.worker_id}", daemon=True)
            self._thread.start()

    def close(self) -> None:
        """Stop the exchange thread (it holds this worker, and so a full
        host snapshot, until stopped).  Safe to call repeatedly; a job
        still in flight is drained first."""
        if self._job is not None:
            try:
                self._take(120.0)
            except Exception:
                pass
        if self._thread is not None:
            self._jobs.put(None)
            self._thread.join(timeout=10.0)
            self._thread = None
            self._jobs = None
        self._pinned = None

    def _to_host(self, job) -> list:
        """The job's leaves on the host: CUDA leaves through pinned
        buffers on the exchange's own stream."""
        leaves = job["params"]
        if job["event"] is None:
            return [_host(l) for l in leaves]
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=leaves[0].device)
        if self._pinned is None:
            self._pinned = [torch.empty(l.shape, dtype=l.dtype,
                                        pin_memory=True) for l in leaves]
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(job["event"])
            for dst, src in zip(self._pinned, leaves):
                dst.copy_(src, non_blocking=True)
        self._stream.synchronize()
        return [_host(p) for p in self._pinned]

    def _to_device(self, job, delta) -> None:
        """Write the catch-up term into the job's device clones (no longer
        needed once on the host) on the exchange's stream."""
        with torch.cuda.stream(self._stream):
            for dst, d in zip(job["params"], delta):
                src = d if isinstance(d, torch.Tensor) \
                    else torch.from_numpy(d)
                dst.copy_(src, non_blocking=False)
            ev = torch.cuda.Event()
            ev.record()
        job["delta"], job["delta_event"] = job["params"], ev

    def _exchange_loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            try:
                t0 = time.perf_counter()
                leaves = self._to_host(job)
                pulled = self._exchange(leaves)
                job["pulled"], job["submitted"] = pulled, leaves
                delta = [p - s for p, s in zip(pulled, leaves)]
                if job["event"] is not None:
                    self._to_device(job, delta)
                else:
                    job["delta"], job["params"] = delta, None
                self.exchange_seconds.append(time.perf_counter() - t0)
            except Exception as e:  # surfaced at take_result
                job["error"] = e
            finally:
                job["done"].set()
