"""Multi-process harness of the port's CPU tests: N spawned worker
processes on ``gloo`` over loopback, each running one function of this
module (which imports no jax, so the children stay light) and handing
its result back to the test through a queue.

``run_workers(world, fn, *args)`` sets the DMLC contract in each child
(``DMLC_NUM_WORKER``, ``DMLC_WORKER_ID``, ``BYTEPS_COORDINATOR_ADDR`` on a
fresh ``free_port()``), pins torch to one thread (six test workers share
the host's cores) and returns ``[fn(rank, world, *args) for rank]``.  A
child that raises fails the call with its traceback; a child that hangs
past ``timeout`` is killed and fails it too.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import traceback

import numpy as np

DEFAULT_TIMEOUT = 90.0


def _child(fn, rank, world, port, env, args, q):
    try:
        os.environ.update({"DMLC_NUM_WORKER": str(world),
                           "DMLC_WORKER_ID": str(rank),
                           "BYTEPS_COORDINATOR_ADDR": f"127.0.0.1:{port}",
                           **env})
        import torch

        torch.set_num_threads(1)
        q.put((rank, "ok", fn(rank, world, *args)))
    except BaseException:  # report anything, the parent raises it
        q.put((rank, "error", traceback.format_exc()))
    finally:
        try:
            from byteps_tpu_torch import api

            api.shutdown()
        except Exception:
            pass


def run_workers(world: int, fn, *args, env=None,
                timeout: float = DEFAULT_TIMEOUT) -> list:
    from byteps_tpu_torch.engine.transport import free_port

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child,
                         args=(fn, r, world, port, dict(env or {}), args, q),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, status, value = q.get(timeout=timeout)
            if status == "ok":
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    except queue.Empty:
        errors.append(f"timed out after {timeout}s with ranks "
                      f"{sorted(results)} done")
    finally:
        for p in procs:
            p.join(timeout=10 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    if errors:
        raise AssertionError("worker failed: " + "\n".join(errors))
    return [results[r] for r in range(world)]


def rank_rng(seed: int, rank: int) -> np.random.RandomState:
    """The inputs of ``rank``: the test rebuilds the same for the JAX
    side's stacked call."""
    return np.random.RandomState(seed * 1000 + rank)


def np_of(t) -> np.ndarray:
    """A torch tensor as numpy (bf16 widened to fp32, exactly)."""
    import torch

    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


# ----------------------------------------------------------- collectives

SPARSE_ROWS, SPARSE_K, SPARSE_D = 10, 6, 4


def collective_inputs(seed: int, rank: int) -> dict:
    """This rank's inputs of :func:`collective_cases` (numpy)."""
    rng = rank_rng(seed, rank)
    idx = rng.randint(0, SPARSE_ROWS, SPARSE_K)
    idx[1] = idx[0]          # a duplicate row on every rank
    idx[2] = SPARSE_ROWS + 2  # out of range: dropped
    return {
        "odd": rng.randn(1001).astype(np.float32),
        "small": rng.randn(777).astype(np.float32),
        "spans": rng.randn(1003).astype(np.float32),
        "even": rng.randn(1000).astype(np.float32),
        "sparse_idx": idx.astype(np.int64),
        "sparse_val": rng.randn(SPARSE_K, SPARSE_D).astype(np.float32),
        "tree": [("a", rng.randn(7, 5).astype(np.float32)),
                 ("b", rng.randn(300).astype(np.float32)),
                 ("c", rng.randn(2, 3).astype(np.float32))],
    }


def collective_cases(rank, world, seed):
    """Every collective of parallel/collectives.py on this rank's inputs,
    over the one-axis mesh ``api.init`` builds (``dp`` = the world); at
    world 4 also the hierarchical form over a ``dcn=2,dp=2`` mesh
    (reduce-scatter over ``dp``, sum over ``dcn``)."""
    import torch

    from byteps_tpu_torch import api
    from byteps_tpu_torch.parallel import collectives as C
    from byteps_tpu_torch.parallel.mesh import build_mesh

    api.init(device="cpu")
    m = api.mesh()
    g = m.group("dp")
    x = {k: (v if k in ("tree",) else torch.from_numpy(v))
         for k, v in collective_inputs(seed, rank).items()}
    out = {
        "sum": C.push_pull_shard(x["odd"], g),
        "avg": C.push_pull_shard(x["odd"], g, average=True),
        "bf16": C.push_pull_shard(x["small"], g, average=True,
                                  wire_dtype=torch.bfloat16),
        "fp16": C.push_pull_shard(x["small"], g,
                                  wire_dtype=torch.float16),
        "sum_only": C.push_pull_shard(x["odd"], sum_groups=[g],
                                      scatter=False),
        "bcast": C.broadcast_shard(x["odd"], 1, g),
        "sparse": C.sparse_push_pull(x["sparse_idx"], x["sparse_val"],
                                     SPARSE_ROWS, groups=[g]),
        "spans": C.reduce_scatter_spans(x["spans"], g),
        "lrs": C.local_reduce_scatter(x["even"], g),
    }
    out["lag"] = C.local_all_gather(out["lrs"], g)
    tree = [(n, torch.from_numpy(a)) for n, a in x["tree"]]
    for i, t in enumerate(C.push_pull_tree(tree, scatter_group=g,
                                           average=True,
                                           partition_bytes=400)):
        out[f"tree{i}"] = t
    from byteps_tpu_torch.training.optimizer import push_pull_gradients

    for i, t in enumerate(push_pull_gradients(tree, partition_bytes=400)):
        out[f"ppg{i}"] = t
    if world == 4:
        h = build_mesh({"dcn": 2, "dp": 2})
        dp, dcn = h.group("dp"), [h.group("dcn")]
        out["h_sum"] = C.push_pull_shard(x["odd"], dp, dcn)
        out["h_avg"] = C.push_pull_shard(x["odd"], dp, dcn, average=True)
        out["h_bf16"] = C.push_pull_shard(x["small"], dp, dcn, average=True,
                                          wire_dtype=torch.bfloat16)
        out["h_sparse"] = C.sparse_push_pull(
            x["sparse_idx"], x["sparse_val"], SPARSE_ROWS,
            groups=[h.group("dcn"), h.group("dp")])
        out["h_coords"] = h.coords()
    return {k: (np_of(v) if hasattr(v, "detach") else v)
            for k, v in out.items()}


# ------------------------------------------------------------------- api

API_NAMES = ["w", "b", "multi", "emb"]


def api_inputs(seed: int, rank: int) -> dict:
    rng = rank_rng(seed, rank)
    return {
        "w": rng.randn(33, 7).astype(np.float32),
        "b": rng.randn(5).astype(np.float32),
        # 3000 fp32 = 12000 bytes: three partitions at 4096-byte bounds
        "multi": rng.randn(3000).astype(np.float32),
        "emb": rng.randn(4, 9).astype(np.float32),
        "bf": rng.randn(1000).astype(np.float32),
        "sparse_idx": np.array([1, 1, 7, 3], np.int64) + rank,
        "sparse_val": rng.randn(4, 6).astype(np.float32),
        "order": [rng.randn(700 + 300 * i).astype(np.float32)
                  for i in range(6)],
    }


def api_cases(rank, world, seed, trace_dir):
    """The eager API at ``world`` workers; the first calls (declares and
    the three traced push_pulls) run in the order the JAX side repeats."""
    import time

    import torch

    os.environ["BYTEPS_TRACE_PATH"] = os.path.join(trace_dir,
                                                   f"rank{rank}.json")
    from byteps_tpu_torch import api
    from byteps_tpu_torch.common.tracing import get_tracer
    from byteps_tpu_torch.engine.dispatcher import get_engine

    api.init(device="cpu")
    x = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in api_inputs(seed, rank).items()}
    out = {"keys": [api.declare(n) for n in API_NAMES],
           "size": api.size(), "rank": api.rank(),
           "local": (api.local_rank(), api.local_size())}
    out["avg_w"] = api.push_pull(x["w"], average=True, name="w")
    out["sum_b"] = api.push_pull(x["b"], average=False, name="b")
    h = api.push_pull_async(x["multi"], average=True, name="multi")
    polls = 0
    while not api.poll(h):
        polls += 1
        time.sleep(0.001)
    out["multi"] = api.synchronize(h)
    get_tracer().flush()
    out["bf16"] = api.push_pull(x["bf"], average=True, name="bf",
                                compression="bf16")
    out["fp16"] = api.push_pull(x["bf"], average=False, name="fp16w",
                                compression="fp16")
    out["sparse"] = api.push_pull_sparse(x["sparse_idx"], x["sparse_val"],
                                         12)
    out["bcast"] = api.broadcast(x["emb"], root_rank=1)
    # the issue order across ranks: the same six tensors enqueued in
    # opposite orders, rank 1 late and slowly
    order = list(range(6)) if rank == 0 else list(range(5, -1, -1))
    handles = {}
    for i in order:
        if rank == 1:
            time.sleep(0.02)
        handles[i] = api.push_pull_async(torch.from_numpy(x["order"][i]),
                                         average=False,
                                         name=f"ord{i}")
    for i in range(6):
        out[f"ord{i}"] = api.synchronize(handles[i])
    eng = get_engine()
    out["grants"] = [g[0] for g in eng.grants]
    out["counts"] = dict(eng.counts)
    out["partition_bytes"] = os.environ.get("BYTEPS_PARTITION_BYTES")
    return {k: (np_of(v) if hasattr(v, "detach") else v)
            for k, v in out.items()}


# -------------------------------------------------------------- training

TRAIN_COMBOS = [(1, "none"), (2, "none"), (1, "bf16"), (2, "bf16")]


def _port_model(cfg_kw, state_dict):
    import torch

    from byteps_tpu_torch.models import transformer as pt

    model = pt.Transformer(pt.TransformerConfig(dtype=torch.float32,
                                                **cfg_kw))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()}, strict=True)
    return model


def train_cases(rank, world, cfg_kw, state_dict, batches):
    """``make_data_parallel_step`` for each of TRAIN_COMBOS (three
    SGD-momentum steps, this rank taking its rows of each global batch);
    then the broadcast of parameters and optimizer state from rank 1, and
    ``Trainer.fit``."""
    import torch

    from byteps_tpu_torch import api
    from byteps_tpu_torch.models import transformer as pt
    from byteps_tpu_torch.training import (Trainer, lm_loss_fn,
                                           make_data_parallel_step)
    from byteps_tpu_torch.training.optimizer import DistributedOptimizer

    api.init(device="cpu")
    per = batches[0].shape[0] // world

    def mine(b):
        return {"tokens": torch.from_numpy(b[rank * per:(rank + 1) * per])}

    out = {}
    for bpps, wire in TRAIN_COMBOS:
        model = _port_model(cfg_kw, state_dict)
        step = make_data_parallel_step(
            lm_loss_fn(model), torch.optim.SGD(model.parameters(), lr=0.1,
                                               momentum=0.9),
            compression=wire, backward_passes_per_step=bpps)
        state = step.init_state(model)
        losses = []
        for b in batches:
            state, m = step(state, mine(b))
            losses.append(m["loss"].item())
        out[(bpps, wire)] = (losses, {n: np_of(p) for n, p in
                                      model.named_parameters()})
    # the DistributedOptimizer used directly: named parameters, an
    # explicit synchronize(), then accumulation over two passes
    data = [torch.from_numpy(rank_rng(9, r).randn(4, 6).astype(np.float32))
            for r in range(world)]

    def grads_of(x):
        torch.manual_seed(0)
        ref = torch.nn.Linear(6, 3)
        ref(x).square().sum().backward()
        return [p.grad.clone() for p in ref.parameters()]

    local = [grads_of(x) for x in data]      # every rank's, computed here
    want = [sum(g[i] for g in local) / world for i in range(2)]
    torch.manual_seed(0)
    lin = torch.nn.Linear(6, 3)
    dopt = DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.5),
                                named_parameters=lin.named_parameters(),
                                partition_bytes=32)
    dopt.zero_grad()
    lin(data[rank]).square().sum().backward()
    dopt.synchronize()
    out["dopt_grads"] = ([np_of(p.grad) for p in lin.parameters()],
                         [np_of(w) for w in want])
    dopt.step()
    out["dopt_buckets"] = dopt._bps_plan.num_buckets
    dopt.set_backward_passes_per_step(2)
    before = [np_of(p) for p in lin.parameters()]
    for n in range(2):
        dopt.zero_grad()
        lin(data[rank] * (n + 1)).square().sum().backward()
        stepped = dopt.step()
        if n == 0:
            out["dopt_first_pass"] = (stepped, [np_of(p) for p in
                                                lin.parameters()], before)
    out["dopt_after"] = [np_of(p) for p in lin.parameters()]
    dopt.zero_grad()
    lin(data[rank]).sum().backward()
    try:
        lin(data[rank]).sum().backward()   # a second pass before step()
        dopt.step()
        out["dopt_twice"] = None
    except AssertionError as e:
        out["dopt_twice"] = str(e)
    # rank-dependent weights and optimizer state, then rank 1's on both
    model = pt.Transformer(pt.TransformerConfig(dtype=torch.float32,
                                                **cfg_kw))
    pt.init_weights(model, 100 + rank)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3 * (rank + 1),
                            weight_decay=1e-4)
    loss, _ = lm_loss_fn(model)(model, {}, mine(batches[rank]))
    loss.backward()
    opt.step()

    def snap():
        sd = opt.state_dict()
        return ({n: np_of(p) for n, p in model.named_parameters()},
                {(pid, k): (np_of(v) if torch.is_tensor(v) else v)
                 for pid, st in sd["state"].items() for k, v in st.items()},
                sd["param_groups"][0]["lr"])

    before = snap()
    assert api.broadcast_parameters(model, root_rank=1) is model
    api.broadcast_optimizer_state(opt, root_rank=1)
    out["bcast"] = (before, snap())
    # the Trainer: rank 0's weights broadcast at start, averaged losses
    model = pt.Transformer(pt.TransformerConfig(dtype=torch.float32,
                                                **cfg_kw))
    pt.init_weights(model, 7 + rank)
    trainer = Trainer(lm_loss_fn(model),
                      torch.optim.SGD(model.parameters(), lr=0.1),
                      device="cpu", log_every=1)
    losses = []
    for b in batches:
        trainer.fit(model, {}, [{k: v.numpy() for k, v in mine(b).items()}])
        losses.append(trainer.metrics["loss"].item())
    ev = trainer.evaluate(
        lambda st, bt: {"loss": lm_loss_fn(st.model)(st.model, {}, bt)[0]},
        [{k: v.numpy() for k, v in mine(batches[0]).items()}])
    out["trainer"] = (losses, ev, {n: np_of(p) for n, p in
                                   model.named_parameters()})
    return out


# ------------------------------------------------- compression / EF

EF_COMBOS = [(1, "onebit"), (2, "onebit"), (1, "topk"), (2, "topk")]
EF_SHAPES = [(7, 5), (300,), (2, 3)]


def ef_grads(seed: int, rank: int, step: int) -> list:
    """This rank's gradient leaves at ``step`` (numpy)."""
    rng = rank_rng(seed * 10 + step, rank)
    return [rng.randn(*s).astype(np.float32) for s in EF_SHAPES]


def ef_transform_cases(rank, world, seed, steps):
    """The stateless bf16 roundtrip and the int8 error feedback, each
    followed by ``push_pull_gradients``, and the top-k EF push_pull, over
    ``steps`` steps of this rank's gradients: the updates and residuals
    of each step."""
    import torch

    from byteps_tpu_torch import api
    from byteps_tpu_torch.compression import compression_roundtrip
    from byteps_tpu_torch.ops.quantization import \
        error_feedback_quantize_gradients
    from byteps_tpu_torch.ops.sparsification import \
        topk_ef_push_pull_gradients
    from byteps_tpu_torch.training.optimizer import push_pull_gradients

    api.init(device="cpu")
    out = {}
    for name, tx, chain in (
            ("bf16", compression_roundtrip("bf16"), True),
            ("int8", error_feedback_quantize_gradients(), True),
            ("topk", topk_ef_push_pull_gradients(ratio=0.1), False)):
        grads = [[torch.from_numpy(g) for g in ef_grads(seed, rank, s)]
                 for s in range(steps)]
        state = tx.init(grads[0])
        rows = []
        for g in grads:
            up, state = tx.update(g, state)
            if chain:
                up = push_pull_gradients(up, partition_bytes=512)
            err = getattr(state, "error", None) or []
            rows.append(([np_of(u) for u in up], [np_of(e) for e in err]))
        out[name] = rows
    x = torch.from_numpy(ef_grads(seed, rank, 9)[1])
    out["push_pull"] = {
        n: np_of(api.push_pull(x, average=True, name=f"pp_{n}",
                               compression=n))
        for n in ("onebit", "topk", "randomk")}
    return out


def ef_train_cases(rank, world, cfg_kw, state_dict, batches):
    """``make_data_parallel_step`` under each of EF_COMBOS (three
    SGD-momentum steps, this rank's rows of each global batch): the
    averaged losses and the weights; then the DistributedOptimizer's
    residuals through ``state_dict`` / ``load_state_dict``."""
    import torch

    from byteps_tpu_torch import api
    from byteps_tpu_torch.training import lm_loss_fn, make_data_parallel_step

    api.init(device="cpu")
    per = batches[0].shape[0] // world

    def mine(b):
        return {"tokens": torch.from_numpy(b[rank * per:(rank + 1) * per])}

    out = {}
    for bpps, scheme in EF_COMBOS:
        model = _port_model(cfg_kw, state_dict)
        step = make_data_parallel_step(
            lm_loss_fn(model), torch.optim.SGD(model.parameters(), lr=0.1,
                                               momentum=0.9),
            compression=scheme, backward_passes_per_step=bpps)
        state = step.init_state(model)
        losses = []
        for b in batches:
            state, m = step(state, mine(b))
            losses.append(m["loss"].item())
        opt = step.optimizer
        sd = opt.state_dict()
        fresh = _port_model(cfg_kw, state_dict)
        twin = make_data_parallel_step(
            lm_loss_fn(fresh), torch.optim.SGD(fresh.parameters(), lr=0.1,
                                               momentum=0.9),
            compression=scheme, backward_passes_per_step=bpps).optimizer
        twin.load_state_dict(sd)
        out[(bpps, scheme)] = (
            losses, {n: np_of(p) for n, p in model.named_parameters()},
            [np_of(e) for e in opt.ef_state.error], opt.ef_state.count,
            all(torch.equal(a, b) for a, b in zip(opt.ef_state.error,
                                                  twin.ef_state.error))
            and twin.ef_state.count == opt.ef_state.count
            and sd["bps_compression"]["count"] == opt.ef_state.count)
    return out


# ------------------------------------- overlap, checkpoints, callbacks

def extras_cases(rank, world, cfg_kw, state_dict, batches, ckpt_root):
    """At ``world`` workers: ``make_delayed_grad_step`` (3 SGD-momentum
    steps and a flush) and ``Trainer(overlap=True)``; ``average_metrics``;
    ``BroadcastGlobalVariablesCallback`` from rank 1; a Trainer
    checkpointing every step on rank 0's directory (rank 1's stays
    empty), then resumed on fresh rank-dependent weights."""
    import torch

    from byteps_tpu_torch import api
    from byteps_tpu_torch.models import transformer as pt
    from byteps_tpu_torch.training import (BroadcastGlobalVariablesCallback,
                                           Trainer, TrainState,
                                           average_metrics, lm_loss_fn,
                                           make_delayed_grad_step)

    api.init(device="cpu")
    per = batches[0].shape[0] // world

    def mine(b):
        return {"tokens": torch.from_numpy(b[rank * per:(rank + 1) * per])}

    def weights(m):
        return {n: np_of(p) for n, p in m.named_parameters()}

    out = {}
    model = _port_model(cfg_kw, state_dict)
    step = make_delayed_grad_step(
        lm_loss_fn(model), torch.optim.SGD(model.parameters(), lr=0.1,
                                           momentum=0.9))
    state = step.init_state(model)
    losses = []
    for b in batches:
        state, m = step(state, mine(b))
        losses.append(m["loss"].item())
    before_flush = weights(model)
    state = step.flush(state)
    out["delayed"] = (losses, before_flush, weights(model), state.step)
    model = _port_model(cfg_kw, state_dict)
    trainer = Trainer(lm_loss_fn(model), torch.optim.SGD(
        model.parameters(), lr=0.1, momentum=0.9), device="cpu",
        overlap=True, log_every=0)
    losses = []
    trainer.callbacks.append(
        lambda st: losses.append(trainer.metrics["loss"].item()))
    trainer.fit(model, {}, [mine(b) for b in batches])
    out["trainer_overlap"] = (losses, weights(model))
    out["metrics"] = average_metrics({"loss": 1.5 + rank,
                                      "acc": torch.tensor(0.25 * rank)})
    # the callback: rank-dependent weights, optimizer and model state,
    # then rank 1's everywhere
    model = pt.Transformer(pt.TransformerConfig(dtype=torch.float32,
                                                **cfg_kw))
    pt.init_weights(model, 50 + rank)
    opt = torch.optim.SGD(model.parameters(), lr=0.1 * (rank + 1),
                          momentum=0.9)
    loss, _ = lm_loss_fn(model)(model, {}, mine(batches[0]))
    loss.backward()
    opt.step()
    st = TrainState(model, opt, {"bn": torch.full((3,), float(rank))}, 0)
    cb = BroadcastGlobalVariablesCallback(root_rank=1)
    assert cb(st) is st and cb(st) is st
    out["callback"] = (weights(model), st.model_state["bn"].tolist(),
                       opt.param_groups[0]["lr"],
                       {n: np_of(opt.state[p]["momentum_buffer"])
                        for n, p in model.named_parameters()})
    # checkpoints: rank 0 saves every step; rank 1 names a directory of
    # its own, which stays empty; a resume on fresh weights gets rank 0's
    import os

    d = os.path.join(ckpt_root, f"rank{rank}")
    model = pt.Transformer(pt.TransformerConfig(dtype=torch.float32,
                                                **cfg_kw))
    pt.init_weights(model, 60 + rank)
    trainer = Trainer(lm_loss_fn(model), torch.optim.AdamW(
        model.parameters(), lr=1e-3, weight_decay=1e-4), device="cpu",
        compression="onebit", checkpoint_dir=d, checkpoint_every=1,
        checkpoint_keep=2, log_every=0)
    trainer.fit(model, {}, [mine(b) for b in batches])
    saved = weights(model)
    res = trainer.state.optimizer.ef_state.error
    listing = sorted(os.listdir(d))
    model = pt.Transformer(pt.TransformerConfig(dtype=torch.float32,
                                                **cfg_kw))
    pt.init_weights(model, 70 + rank)
    fresh = Trainer(lm_loss_fn(model), torch.optim.AdamW(
        model.parameters(), lr=1e-3, weight_decay=1e-4), device="cpu",
        compression="onebit", checkpoint_dir=d, log_every=0)
    resumed = fresh.init_state(model)
    out["checkpoint"] = (saved, listing, weights(model), resumed.step,
                         [np_of(e) for e in res],
                         [np_of(e) for e in
                          resumed.optimizer.ef_state.error])
    return out
