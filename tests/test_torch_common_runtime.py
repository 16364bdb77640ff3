"""The port's common runtime (byteps_tpu_torch.common: types, context,
partition, ready_table, scheduler, tracing; the metrics' tracer mirror)
held against the JAX package's on the same inputs, in one process.

Everything here is host bookkeeping with no arithmetic of its own, so
every comparison is exact: the same keys for the same declare order,
the same partition offsets, bucket plans and schedule order for the
same named sizes and dtypes, the same ready-table answers and grant
order for the same tasks and credits, and the same chrome-trace events
(name, stage, phase and args; timestamps aside) for the same calls.
Bucket payloads are compared bit for bit.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.common import context as jctx
from byteps_tpu.common import partition as jpart
from byteps_tpu.common import ready_table as jrt
from byteps_tpu.common import scheduler as jsched
from byteps_tpu.common import tracing as jtr
from byteps_tpu.common import types as jtypes
from byteps_tpu.observability import metrics as jmetrics
from byteps_tpu_torch.common import context as pctx
from byteps_tpu_torch.common import partition as ppart
from byteps_tpu_torch.common import ready_table as prt
from byteps_tpu_torch.common import scheduler as psched
from byteps_tpu_torch.common import tracing as ptr
from byteps_tpu_torch.common import types as ptypes
from byteps_tpu_torch.observability import metrics as pmetrics

_DTYPES = [("float32", torch.float32, jnp.float32),
           ("bfloat16", torch.bfloat16, jnp.bfloat16),
           ("float16", torch.float16, jnp.float16),
           ("int32", torch.int32, jnp.int32)]


def test_types_match_the_jax_enums():
    for e in ("DataType", "StatusType", "QueueType", "RequestType"):
        assert {m.name: int(m) for m in getattr(ptypes, e)} == \
            {m.name: int(m) for m in getattr(jtypes, e)}
    for name, tdt, jdt in _DTYPES:
        d = ptypes.DataType.from_dtype(tdt)
        assert d == jtypes.DataType.from_dtype(jdt)
        assert d == ptypes.DataType.from_dtype(name) == \
            ptypes.DataType.from_dtype(np.dtype(name) if name != "bfloat16"
                                       else name)
        assert d.torch_dtype == tdt and d.itemsize == tdt.itemsize
        assert d.itemsize == jtypes.DataType.from_dtype(jdt).itemsize
    with pytest.raises(ValueError):
        ptypes.DataType.from_dtype(torch.complex64)
    for r in ptypes.RequestType:
        for d in ptypes.DataType:
            assert ptypes.get_command_type(r, d) == jtypes.get_command_type(
                jtypes.RequestType(int(r)), jtypes.DataType(int(d)))
    for ctor in ("OK", "InProgress"):
        assert getattr(ptypes.Status, ctor)().type.name == \
            getattr(jtypes.Status, ctor)().type.name
    s = ptypes.Status.Aborted("x")
    assert (s.ok(), s.in_progress(), s.type.name, s.reason) == \
        (False, False, "ABORTED", "x")


def test_declared_keys_and_the_keyspace_match_jax():
    names = ["w", "b", "layer.0.w", "w", "emb", "b", "z"]
    preg, jreg = pctx.TensorRegistry(), jctx.TensorRegistry()
    assert [preg.declare(n).declared_key for n in names] == \
        [jreg.declare(n).declared_key for n in names]
    assert preg.names() == jreg.names()
    assert preg.get("emb").declared_key == jreg.get("emb").declared_key
    with pytest.raises(KeyError):
        preg.get("nope")
    for n in names + ["Gradient.layer.3.mlp"]:
        assert pctx.name_key(n) == jctx.name_key(n)
    for dk, p in ((0, 0), (3, 7), (65535, 65535), (12, 1)):
        k = pctx.partition_key(dk, p)
        assert k == jctx.partition_key(dk, p)
        assert pctx.split_key(k) == jctx.split_key(k) == (dk, p)
    for bad in (-1, 1 << 16):
        with pytest.raises(ValueError):
            pctx.partition_key(0, bad)
    preg.reset()
    assert preg.declare("q").declared_key == 0


@pytest.mark.parametrize("nbytes,bound", [
    (0, 4), (1, 4), (4, 4), (10, 4), (4_096_000, 4_096_000),
    (10_000_001, 4_096_000), (7, 1000)])
def test_partition_offsets_match_jax(nbytes, bound):
    assert ppart.partition_offsets(nbytes, bound) == \
        jpart.partition_offsets(nbytes, bound)


_PLANS = {
    "small_fused": ([(4, 5), (3,), (7, 2), (1,), (5, 5)], ["float32"] * 5,
                    1024),
    "split_large": ([(300,), (10,), (64, 8), (2,)], ["float32"] * 4, 400),
    "mixed_dtypes": ([(16,), (16,), (40,), (8,), (100,)],
                     ["float32", "bfloat16", "bfloat16", "float32",
                      "float16"], 96),
    "one_leaf": ([(1000,)], ["float32"], 4_096_000),
}


def _both_trees(shapes, dtypes, seed=0):
    rng = np.random.RandomState(seed)
    named, tree = [], {}
    for i, (shape, dt) in enumerate(zip(shapes, dtypes)):
        a = rng.randn(*shape).astype(np.float32)
        tdt = dict((n, t) for n, t, _ in _DTYPES)[dt]
        jdt = dict((n, j) for n, _, j in _DTYPES)[dt]
        name = f"p{i:02d}"           # JAX flattens dict keys sorted
        named.append((name, torch.from_numpy(a).to(tdt)))
        tree[name] = jnp.asarray(a).astype(jdt)
    return named, tree


@pytest.mark.parametrize("case", sorted(_PLANS))
@pytest.mark.parametrize("reverse", [True, False])
def test_bucket_plans_and_schedule_order_match_jax(case, reverse):
    shapes, dtypes, pb = _PLANS[case]
    named, tree = _both_trees(shapes, dtypes)
    pp = ppart.plan_buckets(named, pb, reverse=reverse)
    jp = jpart.plan_buckets(tree, pb, reverse=reverse)
    assert [(l.index, l.name, l.shape, l.size, l.nbytes) for l in pp.leaves] \
        == [(l.index, l.name, l.shape, l.size, l.nbytes) for l in jp.leaves]
    assert len(pp.buckets) == len(jp.buckets)
    for a, b in zip(pp.buckets, jp.buckets):
        assert (a.bucket_id, a.size, a.priority, a.nbytes) == \
            (b.bucket_id, b.size, b.priority, b.nbytes)
        assert str(a.dtype).split(".")[-1] == jnp.dtype(b.dtype).name
        assert [(s.leaf_index, s.leaf_start, s.bucket_start, s.length)
                for s in a.slices] == \
            [(s.leaf_index, s.leaf_start, s.bucket_start, s.length)
             for s in b.slices]
    assert pp.schedule_order() == jp.schedule_order()


@pytest.mark.parametrize("case", sorted(_PLANS))
def test_bucket_payloads_and_their_inverse_match_jax(case):
    """``gather_buckets`` packs the same bytes as JAX's, and
    ``scatter_buckets`` rebuilds every leaf exactly."""
    shapes, dtypes, pb = _PLANS[case]
    named, tree = _both_trees(shapes, dtypes, seed=1)
    pp = ppart.plan_buckets(named, pb)
    jp = jpart.plan_buckets(tree, pb)
    pb_ = ppart.gather_buckets(named, pp)
    jb = jpart.gather_buckets(tree, jp)
    for a, b in zip(pb_, jb):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)))
    back = ppart.scatter_buckets(pb_, pp)
    for (_, t), r in zip(named, back):
        assert r.dtype == t.dtype and r.shape == t.shape
        assert torch.equal(r, t)


def test_ready_table_answers_match_jax():
    p, j = prt.ReadyTable(expected=2), jrt.ReadyTable(expected=2)
    ops = [("set_expected", 7, 3), ("add_ready_count", 1, 1),
           ("is_key_ready", 1), ("add_and_check", 1, 1), ("is_key_ready", 1),
           ("add_and_check", 7, 2), ("add_and_check", 7, 1),
           ("add_and_check", 7, 1), ("is_key_ready", 7),
           ("clear_ready_count", 7), ("is_key_ready", 7), ("clear_key", 7),
           ("add_and_check", 7, 2), ("add_ready_count", 9, 5)]
    for name, *args in ops:
        assert getattr(p, name)(*args) == getattr(j, name)(*args), name


def _tasks(mod, specs):
    return [mod.TensorTaskEntry(name=f"t{i}", key=key, priority=prio,
                                length=length)
            for i, (prio, key, length) in enumerate(specs)]


@pytest.mark.parametrize("credit", [0, 100, 250, 1000])
def test_scheduler_grant_order_matches_jax(credit):
    """The same tasks added in the same order, the same credits: the same
    grants, the same skips of tasks too long for the credit left, and the
    same order once finished tasks return their credit."""
    rng = np.random.RandomState(credit)
    specs = [(int(rng.randint(-3, 3)), int(rng.randint(0, 1 << 20)),
              int(rng.choice([50, 100, 150, 400]))) for _ in range(12)]
    pq = psched.ScheduledQueue(scheduled=credit > 0, credit_bytes=credit)
    jq = jsched.ScheduledQueue(scheduled=credit > 0, credit_bytes=credit)
    for t in _tasks(ptypes, specs):
        pq.add_task(t)
    for t in _tasks(jtypes, specs):
        jq.add_task(t)
    pgot, jgot = [], []
    for _ in range(40):
        pt, jt = pq.get_task(), jq.get_task()
        assert (pt and pt.name) == (jt and jt.name)
        assert pq.credits == jq.credits
        if pt is None:
            if not pgot:
                break
            pq.report_finish(pgot.pop(0))
            jq.report_finish(jgot.pop(0))
        else:
            pgot.append(pt)
            jgot.append(jt)
    assert pq.pending() == jq.pending()
    # a task by key, and the blocking forms
    pq.add_task(_tasks(ptypes, [(0, 5, 1)])[0])
    assert pq.wait_task(timeout=0.1).key == 5
    assert pq.wait_task(timeout=0.01) is None
    pq.close()
    assert pq.wait_grantable(0.01) is False


def _calls(tracer, keyed_counter):
    with tracer.span("w_0", "dispatch", key=65536, bytes=400):
        pass
    with tracer.span("w_0", "push_pull", key=65536, bytes=400):
        pass
    tracer.complete("b", "wire", 1.0, 0.25, key=3)
    tracer.counter("queue.depth", 5)
    tracer.instant("fence", "router", epoch=2)
    keyed_counter("engine.retry", n=2, name="w", key=65536)
    keyed_counter("engine.retry", n=1, name="b", key=0)


def _events(path):
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid")}
            for e in evs]


def test_trace_events_match_jax(tmp_path, monkeypatch):
    """The same spans, completes, counters, instants and mirrored counter
    bumps give the same chrome-trace events; a rollover (buffer of 3)
    keeps the file valid JSON with every event."""
    got = {}
    for pkg, tr, mx in (("port", ptr, pmetrics), ("jax", jtr, jmetrics)):
        path = str(tmp_path / f"{pkg}.json")
        tracer = tr.Tracer(path=path, max_events=3)
        reg = mx.MetricsRegistry() if pkg == "port" else \
            mx.MetricsRegistry(tracer=tracer)
        if pkg == "port":
            monkeypatch.setattr(pmetrics, "_tracer", lambda: tracer)

        def bump(metric, n, **args):
            reg.counter(metric).inc(n, **args)

        _calls(tracer, bump)
        reg.gauge("serve.occupancy").set(0.5)
        reg.counter("wire.bytes", instants=False).inc(10)
        reg.counter("quiet", mirror=False).inc(1)
        tracer.flush()
        tracer._stop_writer()
        got[pkg] = _events(path)
    assert got["port"] == got["jax"]
    assert len(got["port"]) == 11


def test_the_process_tracer_follows_byteps_trace_path(tmp_path, monkeypatch):
    from byteps_tpu_torch.common.config import reset_config

    path = tmp_path / "trace.json"
    monkeypatch.setenv("BYTEPS_TRACE_PATH", str(path))
    reset_config()
    ptr.reset_tracer()
    try:
        t = ptr.get_tracer()
        assert t.enabled and t.path == str(path)
        with ptr.annotate("step"):
            with t.span("x", "stage", key=1):
                pass
    finally:
        ptr.reset_tracer()   # flushes
        monkeypatch.delenv("BYTEPS_TRACE_PATH")
        reset_config()
    assert [e["name"] for e in json.load(open(path))["traceEvents"]] == ["x"]
    assert not ptr.get_tracer().enabled
