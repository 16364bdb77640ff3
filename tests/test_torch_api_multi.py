"""The port's Horovod API beyond one worker (byteps_tpu_torch.api, the
eager engine, the launcher's worker role) held against the JAX
package's, and the refusals of what the port does not have yet.

The port runs two ``gloo`` processes on loopback, each pushing its own
contribution made by numpy from a seed (tests/torch_dist_workers.py);
the JAX side initializes ``byteps_tpu`` on a 2-device CPU mesh and
pushes the same contributions stacked on a leading worker axis.  At
world 2 every sum, average, wire cast, sparse sum and broadcast is
bit-identical, as are the declared keys and the engine's trace events
(name, stage, phase, key and bytes of every partition's dispatch and
push_pull span) for the same calls.  The engine's cross-rank issue
order is held by enqueueing the same six tensors in opposite orders,
one rank late, and checking the sums and that both ranks launched the
same sequence.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import byteps_tpu as bps
from byteps_tpu.common import config as jconfig
from byteps_tpu_torch import api, launcher
from byteps_tpu_torch.common.config import reset_config
from byteps_tpu_torch.engine.transport import free_port
from byteps_tpu_torch.ops.compression import Compression
from torch_dist_workers import API_NAMES, api_cases, api_inputs, run_workers

SEED = 5
PARTITION_BYTES = "4096"
TRACED = {"w", "b", "multi_0", "multi_1", "multi_2"}


@pytest.fixture(autouse=True)
def _fresh_api():
    yield
    api.shutdown()


@pytest.fixture(scope="module")
def trace_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("traces")


@pytest.fixture(scope="module")
def port(trace_dir):
    return run_workers(2, api_cases, SEED, str(trace_dir),
                       env={"BYTEPS_PARTITION_BYTES": PARTITION_BYTES})


def _stack(key):
    return np.stack([api_inputs(SEED, r)[key] for r in range(2)])


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's eager API on a 2-device mesh: the same declares and calls."""
    path = str(tmp_path_factory.mktemp("jtrace") / "jax.json")
    saved = {k: os.environ.get(k) for k in ("BYTEPS_PARTITION_BYTES",
                                            "BYTEPS_TRACE_PATH")}
    os.environ["BYTEPS_PARTITION_BYTES"] = PARTITION_BYTES
    os.environ["BYTEPS_TRACE_PATH"] = path
    jconfig.reset_config()
    from byteps_tpu.common.tracing import get_tracer, reset_tracer

    reset_tracer()
    try:
        bps.init(mesh=Mesh(np.array(jax.devices()[:2]), ("dp",)))
        out = {"keys": [bps.declare(n) for n in API_NAMES], "size": bps.size()}
        out["avg_w"] = bps.push_pull(jnp.asarray(_stack("w")), average=True,
                                     name="w")
        out["sum_b"] = bps.push_pull(jnp.asarray(_stack("b")),
                                     average=False, name="b")
        out["multi"] = bps.push_pull(jnp.asarray(_stack("multi")),
                                     average=True, name="multi")
        get_tracer().flush()
        with open(path) as f:
            out["trace"] = json.load(f)["traceEvents"]
        out["bf16"] = bps.push_pull(jnp.asarray(_stack("bf")), average=True,
                                    name="bf", compression="bf16")
        out["fp16"] = bps.push_pull(jnp.asarray(_stack("bf")),
                                    average=False, name="fp16w",
                                    compression="fp16")
        out["sparse"] = bps.push_pull_sparse(
            jnp.asarray(_stack("sparse_idx").astype(np.int32)),
            jnp.asarray(_stack("sparse_val")), 12)
        out["bcast"] = bps.broadcast(jnp.asarray(_stack("emb")),
                                     root_rank=1)
        return {k: (np.asarray(v) if k not in ("trace", "keys", "size")
                    else v) for k, v in out.items()}
    finally:
        bps.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jconfig.reset_config()
        reset_tracer()


def test_declared_keys_and_world_match_jax(port, jax_side):
    for r, res in enumerate(port):
        assert res["keys"] == jax_side["keys"]
        assert (res["size"], res["rank"], res["local"]) == (2, r, (0, 1))


@pytest.mark.parametrize("key", ["avg_w", "sum_b", "multi", "bf16", "fp16",
                                 "sparse", "bcast"])
def test_push_pull_sparse_and_broadcast_match_jax_bit_for_bit(port,
                                                              jax_side, key):
    """Sum and mean (a three-partition tensor through poll/synchronize),
    bf16 and fp16 wires, the row-sparse sum with a duplicate row, and a
    broadcast from rank 1: the same bits on both ranks as JAX's."""
    for res in port:
        np.testing.assert_array_equal(res[key], jax_side[key])


def _spans(events):
    return sorted((e["name"], e["cat"], e["ph"], e["args"]["key"],
                   e["args"]["bytes"]) for e in events
                  if e.get("name") in TRACED and e["ph"] == "X")


def test_engine_trace_events_match_jax(port, jax_side, trace_dir):
    want = _spans(jax_side["trace"])
    assert len(want) == 2 * len(TRACED)
    for r in range(2):
        with open(trace_dir / f"rank{r}.json") as f:
            assert _spans(json.load(f)["traceEvents"]) == want


def test_ranks_enqueueing_in_different_orders_get_the_sums(port):
    """Rank 0 enqueues ord0..ord5, rank 1 ord5..ord0, 20 ms apart and
    late: both ranks agree on one launch sequence (the same on both, by
    name) and every sum is right (two terms: exact)."""
    for i in range(6):
        want = sum(api_inputs(SEED, r)["order"][i] for r in range(2))
        for res in port:
            np.testing.assert_array_equal(res[f"ord{i}"], want)
    assert port[0]["grants"] == port[1]["grants"]
    ords = [g for g in port[0]["grants"] if g.startswith("ord")]
    assert len(ords) == sum(-(-(700 + 300 * i) * 4 // 4096)
                            for i in range(6))
    assert port[0]["counts"]["cycles"] == port[1]["counts"]["cycles"]


_CHILD = r"""
import sys, torch
torch.set_num_threads(1)
from byteps_tpu_torch import api
api.init(device="cpu")
r = api.push_pull(torch.full((3,), float(api.rank() + 1)), average=False,
                  name="x")
print("RESULT", api.rank(), api.size(), r.tolist())
api.shutdown()
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "byteps_tpu" or m.startswith("byteps_tpu.")]
assert not bad, bad
"""


def test_launcher_worker_role_runs_two_workers():
    """``python -m byteps_tpu_torch.launcher python -c ...`` twice, with
    ``DMLC_WORKER_ID`` 0 and 1: the launcher hands each child the
    rendezvous, the children sum across each other, and neither imports
    jax or the JAX package."""
    port_ = free_port()
    procs = []
    for wid in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("BYTEPS_", "DMLC_"))}
        env.update(DMLC_ROLE="worker", DMLC_NUM_WORKER="2",
                   DMLC_WORKER_ID=str(wid), DMLC_PS_ROOT_URI="127.0.0.1",
                   DMLC_PS_ROOT_PORT=str(port_))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.launcher",
             sys.executable, "-c", _CHILD], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = sorted(line.split(" ", 1)[1] for o in outs
                 for line in o.splitlines() if line.startswith("RESULT"))
    assert got == ["0 2 [3.0, 3.0, 3.0]", "1 2 [3.0, 3.0, 3.0]"]


def test_launcher_builds_the_child_env_as_jax_does():
    from byteps_tpu import launcher as jlauncher

    env = {"DMLC_ROLE": "worker", "DMLC_NUM_WORKER": "4",
           "DMLC_WORKER_ID": "3", "DMLC_PS_ROOT_URI": "10.0.0.1",
           "DMLC_PS_ROOT_PORT": "9999"}
    mine = launcher.build_child_env(env)
    theirs = jlauncher.build_child_env(env)
    for k in ("BYTEPS_COORDINATOR_ADDR", "BYTEPS_NUM_PROCESSES",
              "BYTEPS_PROCESS_ID", "BYTEPS_LOCAL_RANK"):
        assert mine[k] == theirs[k]
    assert "BYTEPS_DISTRIBUTED_INIT" not in mine   # JAX's, not read here
    for bad in ({"DMLC_ROLE": "worker", "DMLC_NUM_WORKER": "2"},
                {"DMLC_NUM_WORKER": "1"}):
        with pytest.raises(SystemExit, match="missing required env"):
            launcher._check_env(bad)


def test_launcher_refuses_the_server_role(monkeypatch, capsys):
    """The server role is ported: without async mode it prints JAX's
    notice (the port's name for the launcher) and exits 0, and with it
    serves a shard (test_torch_ps_server.py); an unknown role exits 2."""
    from byteps_tpu import launcher as jax_launcher

    monkeypatch.delenv("BYTEPS_ENABLE_ASYNC", raising=False)
    monkeypatch.setenv("DMLC_ROLE", "server")
    assert launcher.main([]) == 0
    mine = capsys.readouterr().out
    assert jax_launcher.main([]) == 0
    theirs = capsys.readouterr().out
    assert mine.startswith("byteps_tpu_torch.launcher: role 'server' is "
                           "only needed for async-PS mode")
    assert theirs.startswith("byteps_tpu.launcher: role 'server' is only "
                             "needed for async-PS mode")
    monkeypatch.setenv("DMLC_ROLE", "bogus")
    assert launcher.main([]) == 2
    assert "unknown role 'bogus'" in capsys.readouterr().err
    monkeypatch.setenv("DMLC_ROLE", "scheduler")
    assert launcher.main([]) == 0


def test_one_worker_api_is_the_identity_on_gloo():
    api.init(device="cpu")
    assert (api.size(), api.rank(), api.backend()) == (1, 0, "gloo")
    x = torch.randn(5, 3)
    assert torch.equal(api.push_pull(x, name="a"), x)
    assert torch.equal(api.push_pull(x, average=False, name="a2",
                                     compression="bf16"), x)
    h = api.push_pull_async(x, name="c")
    assert torch.equal(api.synchronize(h), x)
    assert torch.equal(api.broadcast(x), x)
    model = torch.nn.Linear(3, 2)
    assert api.broadcast_parameters(model) is model
    with pytest.raises(ValueError, match="root_rank"):
        api.broadcast(x, root_rank=1)
    with pytest.raises(NotImplementedError, match="item 10"):
        api.push_pull(x, name="h", hierarchical=True)
    # a biased scheme rounds the one contribution (no error feedback)
    from byteps_tpu_torch.compression import get_scheme

    assert torch.equal(api.push_pull(x, name="t", compression="topk"),
                       get_scheme("topk").roundtrip(x))
    api.init(device="cpu")   # idempotent


@pytest.mark.parametrize("knob,value,item", [
    ("BYTEPS_METRICS_PORT", "9091", "item 10"),
    ("BYTEPS_TRACE_RPC", "1", "item 10"),
    ("BYTEPS_HIERARCHICAL", "1", "item 10"),
    ("BYTEPS_TRANSPORT", "shm", "item 10"),
    ("BYTEPS_MESH_SHAPE", "tp=2", "item 12")])
def test_init_refuses_knobs_the_port_lacks(monkeypatch, knob, value, item):
    monkeypatch.setenv(knob, value)
    if knob == "BYTEPS_HIERARCHICAL":   # refused under async mode too
        monkeypatch.setenv("BYTEPS_ENABLE_ASYNC", "1")
    reset_config()
    with pytest.raises(NotImplementedError, match=item):
        api.init(device="cpu")
    assert not torch.distributed.is_initialized()


def test_init_under_async_mode_joins_no_worker_group(monkeypatch):
    """``BYTEPS_ENABLE_ASYNC``: the workers meet at the server tier only,
    so ``init`` starts a group of one even when the launcher's variables
    name a two-worker world (as JAX's ``_maybe_init_distributed`` returns
    early), and the PS tier's ``BYTEPS_COMPRESSION`` is taken;
    ``shutdown`` closes the process-default async store."""
    from byteps_tpu_torch.engine import async_ps

    for k, v in {"BYTEPS_ENABLE_ASYNC": "1", "DMLC_NUM_WORKER": "2",
                 "DMLC_WORKER_ID": "1", "BYTEPS_NUM_PROCESSES": "2",
                 "BYTEPS_PROCESS_ID": "1",
                 "BYTEPS_COORDINATOR_ADDR": "127.0.0.1:1",
                 "BYTEPS_COMPRESSION": "onebit"}.items():
        monkeypatch.setenv(k, v)
    reset_config()
    api.init(device="cpu")
    assert (api.size(), api.rank()) == (1, 0)
    closed = []

    class _Store:
        def close(self):
            closed.append(1)

    async_ps.set_async_store(_Store())
    api.shutdown()
    assert closed == [1] and not torch.distributed.is_initialized()


def test_compression_registry_names_are_refused():
    """Unknown registry names are refused (``KeyError`` listing the
    schemes), and so is an object that is no Compressor; the registry's
    names resolve to stateless roundtrip Compressors."""
    assert Compression.resolve("bf16") is Compression.bf16
    assert Compression.resolve(None) is Compression.none
    x = torch.randn(8)
    c, ctx = Compression.fp16.compress(x)
    assert c.dtype == torch.float16
    assert torch.equal(Compression.fp16.decompress(c, ctx),
                       x.half().float())
    for name in ("onebit", "topk", "randomk", "int8"):
        comp = Compression.resolve(name)
        assert comp is Compression.resolve(name)   # one class a scheme
        assert comp.scheme.name == name and comp.wire_dtype is None
        y, ctx = comp.compress(x)
        assert comp.decompress(y, ctx) is y and y.shape == x.shape
    with pytest.raises(KeyError, match="available"):
        Compression.resolve("twobit")
    with pytest.raises(TypeError, match="Compressor"):
        Compression.resolve(object())


def test_nccl_refuses_two_local_ranks_on_one_gpu(monkeypatch):
    """Two launcher ranks on a one-GPU host under the default ``nccl``
    are refused at init, naming ``backend='gloo'`` (checked before any
    CUDA call, so it runs on this CPU host with the device count
    stubbed)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    monkeypatch.setenv("BYTEPS_LOCAL_SIZE", "2")
    reset_config()
    with pytest.raises(ValueError, match="backend='gloo'.*item 7|item 7"):
        api.init()
    assert not torch.distributed.is_initialized()


def test_a_second_worker_needs_a_rendezvous(monkeypatch):
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    monkeypatch.setenv("DMLC_WORKER_ID", "1")
    for k in ("BYTEPS_COORDINATOR_ADDR", "DMLC_PS_ROOT_URI"):
        monkeypatch.delenv(k, raising=False)
    reset_config()
    with pytest.raises(ValueError, match="rendezvous"):
        api.init(device="cpu")


def test_agreement_grants_what_every_rank_queued_in_rank_0s_order():
    """The grant list of an agreement cycle: only partitions queued on
    every rank (a duplicate as often as every rank has it), in rank 0's
    order, skipping one longer than the smallest rank's credit left."""
    from byteps_tpu_torch.engine.dispatcher import agree

    a, b, c, d = ("a", 0), ("b", 0), ("b", 1), ("d", 0)
    offers = [
        (False, 300, [(a, 0, 0, 100), (b, -1, 65536, 250), (c, -1, 65537, 50),
                      (d, -3, 196608, 100), (d, -3, 196608, 100)]),
        (False, 1000, [(d, -9, 0, 100), (c, -2, 5, 50), (b, -2, 4, 250),
                       (d, -9, 0, 100)]),
    ]
    assert agree(offers) == [b, c]          # a not on rank 1; d: no credit
    offers[0] = (True, 1000, offers[0][2])
    assert agree(offers) == [b, c, d, d]
    assert agree([(False, 10, []), (False, 10, [(a, 0, 0, 1)])]) == []


def test_debug_sample_tensor_logs_first_and_last_values(monkeypatch, caplog):
    """``BYTEPS_DEBUG_SAMPLE_TENSOR`` (reference core_loops.cc:33-63): the
    engine logs a matching partition's first and last values."""
    import logging

    from byteps_tpu_torch.common.logging import get_logger

    monkeypatch.setenv("BYTEPS_DEBUG_SAMPLE_TENSOR", "probe")
    reset_config()
    logger = get_logger()          # the port's logger does not propagate
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(caplog.handler)
    try:
        api.init(device="cpu")
        api.push_pull(torch.arange(4.0), name="probe.w")
        api.push_pull(torch.arange(3.0), name="other")
    finally:
        logger.removeHandler(caplog.handler)
        logger.setLevel(level)
    msgs = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("sample ")]
    assert msgs == ["sample probe.w key=0 first=0.0 last=3.0"]
