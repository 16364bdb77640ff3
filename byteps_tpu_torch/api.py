"""Horovod-style process API — the port of ``byteps_tpu/api.py``.

``init / shutdown / size / rank / local_rank / local_size`` (reference
operations.cc:28-91), ``declare / push_pull(_async) / poll /
synchronize`` (torch/ops.py:96-218), ``push_pull_sparse``, ``broadcast``,
``broadcast_parameters`` and ``broadcast_optimizer_state``
(torch/__init__.py:234-381), with the reference's process model: one
process per worker, one GPU per process.  ``push_pull`` takes *this
worker's* contribution and returns the sum (or mean) over the workers,
identically on every worker; the JAX package's single-controller form
stacks the contributions on a leading axis instead.

``init`` brings up ``torch.distributed`` from the DMLC contract
(``DMLC_NUM_WORKER``, ``DMLC_WORKER_ID`` and ``BYTEPS_COORDINATOR_ADDR``
or ``DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT``, as the launcher's worker role
sets them; a world of one rendezvouses on a free loopback port), builds
the process mesh (``BYTEPS_MESH_SHAPE``, data axes only) and starts the
eager engine (engine/dispatcher.py) on a process group of its own.  A
CUDA worker uses ``nccl`` and a CPU worker ``gloo`` unless ``backend=``
names another; nothing switches backends on its own.

Under ``BYTEPS_ENABLE_ASYNC`` the workers share no process group: they
exchange weights through the async parameter-server tier
(engine/async_ps.py), and ``init`` brings up only this worker's own
group of one on a free loopback port, as JAX's ``_maybe_init_distributed``
skips the collective bootstrap there.  ``shutdown`` closes the
process-default async store.

Refused, naming the port's queue-A item 10: the hierarchical PS path
(``hierarchical=True``, ``BYTEPS_HIERARCHICAL``), the metrics scrape,
RPC trace ids and the Unix-socket / shared-memory transports.
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Any, Optional

import torch
import torch.distributed as dist

from .common import logging as bps_log
from .common.config import get_config, reset_config
from .common.device import resolve_device
from .engine import dispatcher as _dispatcher
from .ops.compression import Compression
from .parallel import collectives as _collectives
from .parallel import mesh as _mesh_mod

__all__ = ["init", "shutdown", "size", "rank", "local_rank", "local_size",
           "device", "mesh", "declare", "push_pull", "push_pull_async",
           "push_pull_sparse", "poll", "synchronize", "broadcast",
           "broadcast_parameters", "broadcast_optimizer_state",
           "DistributedOptimizer"]


class _GlobalState:
    def __init__(self):
        self.initialized = False
        self.device: Optional[torch.device] = None
        self.backend: Optional[str] = None
        self.mesh: Optional[_mesh_mod.ProcessMesh] = None
        self.owns_group = False   # init started torch.distributed
        self.lock = threading.Lock()


_state = _GlobalState()


def _validate_local_contract(cfg, world: int, rank_: int) -> None:
    """Launcher-injected ``BYTEPS_LOCAL_RANK``/``BYTEPS_LOCAL_SIZE`` must
    match the process reality (the JAX package's check, with one process
    per worker): a wrong local rank would make a hierarchical push ship
    the wrong slice, so mismatches raise at init."""
    lr, ls = cfg.local_rank, cfg.local_size
    if ls is not None and ls < 1:
        raise ValueError(f"BYTEPS_LOCAL_SIZE={ls} must be >= 1")
    if lr is not None and ls is not None and not 0 <= lr < ls:
        raise ValueError(
            f"BYTEPS_LOCAL_RANK={lr} is out of range for "
            f"BYTEPS_LOCAL_SIZE={ls}. Fix the launcher's injected values.")
    if lr is not None and ls is None and world > 1 and lr >= world:
        raise ValueError(
            f"BYTEPS_LOCAL_RANK={lr} exceeds the {world}-worker world. Fix "
            f"the launcher env (or set BYTEPS_LOCAL_SIZE explicitly).")
    if world == 1:
        if lr not in (None, 0):
            raise ValueError(
                f"BYTEPS_LOCAL_RANK={lr} but this run has a single "
                f"process. Unset BYTEPS_LOCAL_RANK (or set it to 0).")
        if ls not in (None, 1):
            raise ValueError(
                f"BYTEPS_LOCAL_SIZE={ls} but this run has a single process")
    else:
        if ls is not None and world % ls != 0:
            raise ValueError(
                f"BYTEPS_LOCAL_SIZE={ls} does not divide the {world}-worker "
                f"world — hosts would disagree on the slice layout.")
        if lr is not None and ls is not None and ls > 1 \
                and lr != rank_ % ls:
            raise ValueError(
                f"BYTEPS_LOCAL_RANK={lr} contradicts rank {rank_} under "
                f"local_size {ls} (expected {rank_ % ls}). Fix the "
                f"launcher env.")


def _refuse_unported(cfg) -> None:
    if cfg.metrics_port:
        raise NotImplementedError(
            f"BYTEPS_METRICS_PORT={cfg.metrics_port}: the worker's /metrics "
            f"scrape belongs to the port's PS-tier and observability "
            f"slice (queue A item 10); unset it")
    if cfg.trace_rpc:
        raise NotImplementedError(
            "BYTEPS_TRACE_RPC: RPC trace ids belong to the port's PS-tier "
            "slice (queue A item 10); unset it")
    if cfg.hierarchical:
        raise NotImplementedError(
            "BYTEPS_HIERARCHICAL=1: hierarchical push/pull comes with the "
            "port of hierarchical.py (queue A item 10); unset it")
    from .common.config import check_transport

    check_transport(cfg.transport)


def _rendezvous(world: int, local: bool = False) -> str:
    addr = None if local else os.environ.get("BYTEPS_COORDINATOR_ADDR")
    if not addr and not local and os.environ.get("DMLC_PS_ROOT_URI"):
        addr = (os.environ["DMLC_PS_ROOT_URI"] + ":"
                + os.environ.get("DMLC_PS_ROOT_PORT", "1234"))
    if not addr:
        if world > 1:
            raise ValueError(
                f"DMLC_NUM_WORKER={world} needs a rendezvous address: "
                f"BYTEPS_COORDINATOR_ADDR=host:port or DMLC_PS_ROOT_URI and "
                f"DMLC_PS_ROOT_PORT (python -m byteps_tpu_torch.launcher "
                f"sets them)")
        from .engine.transport import free_port

        addr = f"127.0.0.1:{free_port()}"
    return f"tcp://{addr}"


def init(device=None, backend: Optional[str] = None) -> None:
    """Initialize the process (reference byteps_init; idempotent).

    ``device`` defaults to ``cuda`` and raises without a GPU unless the
    caller passes ``device="cpu"``.  ``backend`` defaults to ``nccl`` on
    CUDA and ``gloo`` on the CPU; ``gloo`` over CUDA tensors must be
    asked for by name (NCCL refuses two ranks on one GPU).  A process
    group the caller already initialized is adopted as it is."""
    with _state.lock:
        dev = resolve_device(device)
        if _state.initialized:
            want = dev if dev.index is not None or dev.type != "cuda" \
                else torch.device("cuda", torch.cuda.current_device())
            if want != _state.device:
                raise ValueError(f"already initialized on {_state.device}, "
                                 f"not {dev}; call shutdown() first")
            return
        cfg = get_config()
        _refuse_unported(cfg)
        if cfg.enable_async:
            # async-PS workers meet only at the server tier: a group of
            # one each (DMLC_PS_ROOT_URI names the servers' host here)
            world, rank_ = 1, 0
        else:
            world = int(os.environ.get("BYTEPS_NUM_PROCESSES",
                                       cfg.num_worker))
            rank_ = int(os.environ.get("BYTEPS_PROCESS_ID", cfg.worker_id))
        if not 0 <= rank_ < world:
            raise ValueError(f"DMLC_WORKER_ID={rank_} is not a rank of the "
                             f"{world}-worker world")
        _validate_local_contract(cfg, world, rank_)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError("the nccl backend needs device='cuda'")
        if backend == "nccl" and world > 1 and \
                (cfg.local_size or 1) > torch.cuda.device_count():
            raise ValueError(
                f"BYTEPS_LOCAL_SIZE={cfg.local_size} ranks on "
                f"{torch.cuda.device_count()} GPU(s) under nccl: NCCL "
                f"refuses two ranks on one GPU (the eager engine runs one "
                f"GPU a rank, queue A item 7); pass backend='gloo' to share "
                f"a card")
        shape = _mesh_mod.parse_mesh_shape(cfg.mesh_shape)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(dev)
        owns = not dist.is_initialized()
        if owns:
            dist.init_process_group(
                backend, init_method=_rendezvous(world, cfg.enable_async),
                world_size=world, rank=rank_,
                timeout=datetime.timedelta(minutes=10))
        elif (dist.get_world_size(), dist.get_rank()) != (world, rank_):
            raise ValueError(
                f"torch.distributed is already initialized as rank "
                f"{dist.get_rank()} of {dist.get_world_size()}, not "
                f"{rank_} of {world}")
        try:
            _state.mesh = _mesh_mod.build_mesh(
                shape or None, force_distributed=cfg.force_distributed)
            group = dist.new_group(list(range(world)))
            control = (dist.new_group(list(range(world)), backend="gloo")
                       if world > 1 else None)
            _dispatcher.start_engine(group, control, dev)
        except Exception:
            if owns:
                dist.destroy_process_group()
            raise
        _state.device = dev
        _state.backend = dist.get_backend()
        _state.owns_group = owns
        _state.initialized = True
        bps_log.info("byteps_tpu_torch initialized: rank %d of %d on %s "
                     "(%s), mesh %s", rank_, world, dev, _state.backend,
                     dict(_state.mesh.shape))


def shutdown() -> None:
    """Reference byteps_shutdown: stop the engine, flush the trace, and
    tear down the process group if ``init`` started it."""
    with _state.lock:
        if _state.initialized:
            _dispatcher.stop_engine()
            if _state.owns_group and dist.is_initialized():
                dist.destroy_process_group()
        # the process-default async-PS store owns wire workers and a
        # heartbeat: live threads, closed here
        from .engine.async_ps import close_async_store

        close_async_store()
        _state.initialized = False
        _state.device = None
        _state.backend = None
        _state.mesh = None
        _state.owns_group = False
        from .common.tracing import reset_tracer

        reset_tracer()  # flushes the chrome trace if enabled
        reset_config()


def _require_init() -> None:
    if not _state.initialized:
        raise RuntimeError("call byteps_tpu_torch.api.init() first")


def size() -> int:
    """World size: the product of the mesh's data axes (the number of
    worker processes)."""
    _require_init()
    return _mesh_mod.world_size(_state.mesh)


def rank() -> int:
    _require_init()
    return dist.get_rank()


def local_rank() -> int:
    """Launcher-injected BYTEPS_LOCAL_RANK wins, else 0: one worker per
    process, one process per GPU."""
    _require_init()
    cfg = get_config()
    return cfg.local_rank if cfg.local_rank is not None else 0


def local_size() -> int:
    """Launcher-injected BYTEPS_LOCAL_SIZE wins, else 1."""
    _require_init()
    cfg = get_config()
    return cfg.local_size if cfg.local_size is not None else 1


def device() -> torch.device:
    """The device this worker runs on."""
    _require_init()
    return _state.device


def backend() -> str:
    """The process group's backend (``nccl`` or ``gloo``)."""
    _require_init()
    return _state.backend


def mesh() -> _mesh_mod.ProcessMesh:
    _require_init()
    return _state.mesh


def _engine() -> _dispatcher.Engine:
    _require_init()
    return _dispatcher.get_engine()


def declare(name: str) -> int:
    """Reference byteps_torch_declare_tensor / ops.py:185-192."""
    return _engine().declare(name)


_name_counter = [0]


def _auto_name(prefix: str = "byteps_push_pull") -> str:
    _name_counter[0] += 1
    return f"{prefix}_{_name_counter[0]}"


_roundtrip_counter = [0]


def _maybe_roundtrip(tensor: torch.Tensor, compression,
                     name: str = "") -> torch.Tensor:
    """Apply a biased registry scheme's compress->decompress to this
    worker's contribution before the collective (cast schemes ride the
    engine's wire dtype instead): per-contribution scales, as each worker
    would put on a real wire.

    Seeded schemes fold (config seed, tensor name, per-process call
    counter) like the wire path's ``derive_seed``, so successive pushes
    of the same tensor move the random-k mask instead of freezing one
    coordinate subset; every worker calling in the same order draws the
    same seeds.  Stateless (no error feedback): one-shot reductions only;
    training loops carry the unsent mass through the
    DistributedOptimizer's error feedback."""
    scheme = getattr(compression, "scheme", None)
    if scheme is None or not scheme.biased:
        return tensor
    cfg = get_config()
    seed = None
    if scheme.seeded:
        from .compression import derive_seed

        _roundtrip_counter[0] += 1
        seed = derive_seed(cfg.compression_seed, name,
                           _roundtrip_counter[0])
    return scheme.roundtrip(tensor, seed=seed, ratio=cfg.compression_ratio)


def push_pull(tensor: torch.Tensor, average: bool = True,
              name: Optional[str] = None, version: int = 0,
              priority: int = 0, compression: Any = Compression.none,
              hierarchical: Optional[bool] = None) -> torch.Tensor:
    """Sum (or average) this worker's ``tensor`` across the workers;
    blocks until the result is ready (reference torch/ops.py:96-141: the
    result equals the elementwise sum over every worker's contribution,
    identically on all workers).  Every worker calls it with the same
    ``name`` — the engine matches partitions across workers by name.
    ``compression`` is a Compressor class or a registry scheme name: a
    cast (``"fp16"``, ``"bf16"``) rides the wire dtype, a biased scheme
    (``"onebit"``, ``"topk"``, ``"randomk"``, ``"int8"``) rounds this
    worker's contribution first, without error feedback."""
    handle = push_pull_async(tensor, average=average, name=name,
                             version=version, priority=priority,
                             compression=compression,
                             hierarchical=hierarchical)
    return synchronize(handle)


def push_pull_async(tensor: torch.Tensor, average: bool = True,
                    name: Optional[str] = None, version: int = 0,
                    priority: int = 0, compression: Any = Compression.none,
                    hierarchical: Optional[bool] = None) -> int:
    """Async :func:`push_pull`; returns a handle (reference
    torch/ops.py:144-183).  The hierarchical PS path
    (``hierarchical=True``, ``BYTEPS_HIERARCHICAL``) is refused (queue A
    item 10)."""
    engine = _engine()
    if hierarchical:
        raise NotImplementedError(
            "hierarchical push_pull rides the async parameter-server tier, "
            "which belongs to the port's PS-tier slice (queue A item 10)")
    comp = Compression.resolve(compression)
    if not isinstance(tensor, torch.Tensor):
        raise TypeError(f"push_pull takes a torch.Tensor, not "
                        f"{type(tensor).__name__}")
    if tensor.device != _state.device:
        raise ValueError(f"tensor on {tensor.device}, worker on "
                         f"{_state.device}")
    tensor = _maybe_roundtrip(tensor, comp, name=name or "")
    return engine.push_pull_async(tensor, name or _auto_name(),
                                  average=average, priority=priority,
                                  version=version,
                                  wire_dtype=comp.wire_dtype)


def push_pull_sparse(indices: torch.Tensor, values: torch.Tensor,
                     num_rows: int, average: bool = False) -> torch.Tensor:
    """Row-sparse push_pull: this worker contributes ``values [k, d]`` for
    rows ``indices [k]`` (every worker the same ``k``) and every worker
    receives the dense ``[num_rows, d]`` sum (or mean) over the workers
    (parallel/collectives.sparse_push_pull over the mesh's data axes)."""
    _require_init()
    m = _state.mesh
    return _collectives.sparse_push_pull(
        indices, values, num_rows,
        groups=m.groups(_mesh_mod.reduce_axes(m)), average=average)


def poll(handle: int) -> bool:
    """Reference torch/ops.py:185-196 (poll)."""
    return _engine().poll(handle)


def synchronize(handle: int):
    """Reference torch/ops.py:204-218 (synchronize)."""
    return _engine().synchronize(handle)


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None) -> torch.Tensor:
    """Worker ``root_rank``'s value on every worker (reference broadcast
    contract, tests/test_mxnet.py:116-158); a new tensor."""
    del name
    _require_init()
    if not 0 <= root_rank < size():
        raise ValueError(f"root_rank {root_rank} is not a worker of this "
                         f"{size()}-worker world")
    return _collectives.broadcast_shard(tensor, root_rank,
                                        _state.mesh.group(None))


def broadcast_parameters(params, root_rank: int = 0):
    """Give every worker the root's parameters, in place (reference
    torch/__init__.py:234-262): ``params`` is an ``nn.Module``, a state
    dict, or any dict/list of tensors; tensors are overwritten with the
    root's values and ``params`` is returned."""
    _require_init()
    if not 0 <= root_rank < size():
        raise ValueError(f"root_rank {root_rank} is not a worker of this "
                         f"{size()}-worker world")
    tensors = _tensors_of(params)
    if size() > 1:
        g = _state.mesh.group(None)
        src = dist.get_global_rank(g, root_rank)
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data if isinstance(t, torch.nn.Parameter)
                               else t, src=src, group=g)
    return params


def _tensors_of(params) -> list:
    if isinstance(params, torch.nn.Module):
        return list(params.state_dict(keep_vars=True).values())
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, dict):
        return [t for k in sorted(params, key=str)
                for t in _tensors_of(params[k])]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in _tensors_of(v)]
    return []


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Give every worker the root's optimizer state, in place (reference
    torch/__init__.py:265-381): every state tensor is broadcast, and the
    numeric scalars of the state and the param groups (``lr``,
    ``momentum``, ...) ride one float64 tensor.  Every worker must hold
    state of the same structure (the same optimizer over the same
    parameters, stepped alike or not at all)."""
    _require_init()
    if not 0 <= root_rank < size():
        raise ValueError(f"root_rank {root_rank} is not a worker of this "
                         f"{size()}-worker world")
    if size() == 1:
        return
    sd = optimizer.state_dict()
    dev = _state.device
    g = _state.mesh.group(None)
    src = dist.get_global_rank(g, root_rank)

    def is_num(v):
        return isinstance(v, (int, float)) and not isinstance(v, bool)

    scalars = [("g", gi, k) for gi, group in enumerate(sd["param_groups"])
               for k in sorted(group) if is_num(group[k])]
    for pid in sorted(sd["state"]):
        for k in sorted(sd["state"][pid]):
            v = sd["state"][pid][k]
            if isinstance(v, torch.Tensor):
                # scalar state such as Adam's step may live on the host
                t = v if v.device == dev else v.to(dev)
                dist.broadcast(t, src=src, group=g)
                if t is not v:
                    v.copy_(t)
            elif is_num(v):
                scalars.append(("s", pid, k))
    if scalars:
        def holder(w, i):
            return sd["param_groups"][i] if w == "g" else sd["state"][i]

        vals = torch.tensor([float(holder(w, i)[k]) for w, i, k in scalars],
                            dtype=torch.float64, device=dev)
        dist.broadcast(vals, src=src, group=g)
        for (w, i, k), v in zip(scalars, vals.tolist()):
            holder(w, i)[k] = type(holder(w, i)[k])(v)
    optimizer.load_state_dict(sd)


def __getattr__(name):
    # the reference's bps.DistributedOptimizer, without a circular import
    if name == "DistributedOptimizer":
        from .training.optimizer import DistributedOptimizer

        return DistributedOptimizer
    raise AttributeError(name)
