"""The port's parameter-server tier (byteps_tpu_torch/engine/ps_server.py)
against the JAX package's, over TCP on loopback.

* **The interop matrix** — {JAX ``RemoteStore``, port ``RemoteStore``} x
  {JAX shard, port shard}, over 1 and 2 shards: one op script (INIT
  first-push-wins with the loser told the winner's value, PUSH,
  PUSH_PULL, PULL, SET, VERSION, NAMES, ``pull_many``; fp32, bf16 and
  int32 tensors; a tensor above a small ``BYTEPS_PARTITION_BYTES``, whose
  ``#p{i}`` keys a fresh client discovers) gives bit-identical values,
  versions and names in every cell, and so does the port's serial client
  (``BYTEPS_WIRE_WINDOW=0``).  ``BYTEPS_COMPRESSION`` at none, bf16, fp16, onebit, topk
  and int8 (no seed): each client's error-feedback pushes are summed bit
  for bit alike by both shards, and the two clients agree bit for bit
  except onebit, whose scale is the float64 mean rounded once in the port
  (within a few ulps of JAX's float32 mean); ``BYTEPS_COMPRESSION_REPLY=
  bf16`` replies are bit-identical too.
* **Resilience on the port's ``FaultInjectingProxy``** — a retried push is
  applied exactly once when its reply is lost and resent when its request
  is, a push_pull recovers its result, the version guard is off beyond
  one worker, a shard's death fails over and a restart re-seeds the state
  bit for bit, a single restarted shard is re-seeded, and
  ``RetryPolicy.from_config`` gives JAX's schedule.
* **The shard's own surface** — STATS names the reducer, its sums, the
  peak RSS and no CUDA context; the per-key profile timeline; the PS
  tier's refusals of what is not ported yet, by name.
* **The server role** — ``python -m byteps_tpu_torch.launcher`` with
  ``DMLC_ROLE=server BYTEPS_ENABLE_ASYNC=1`` in a child process answers a
  JAX ``RemoteStore``, logs its native reducer, creates no CUDA context
  and imports no JAX; ``BYTEPS_SERVER_MAX_RESTARTS=1`` restarts a shard
  whose first start crashed.

The JAX side runs as its own tests run it: in-thread ``serve(...,
in_thread=True)`` shards and its ``RemoteStore``, with
``BYTEPS_TRANSPORT=tcp`` (its ``auto`` would probe local endpoints).
Inputs come from numpy with fixed seeds; one torch thread.
"""

import os
import random
import subprocess
import sys
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from byteps_tpu.common import config as jax_config
from byteps_tpu.engine import ps_server as jps
from byteps_tpu.resilience import RetryPolicy as JaxRetryPolicy
from byteps_tpu_torch.common import config as port_config
from byteps_tpu_torch.engine import ps_server as pps
from byteps_tpu_torch.engine.transport import free_port
from byteps_tpu_torch.resilience import (FaultInjectingProxy,
                                         ResilienceCounters, RetryPolicy,
                                         reset_counters)
from byteps_tpu_torch.resilience import counters as cn

PKG = {"jax": jps, "port": pps}
CELLS = [(c, s) for c in ("jax", "port") for s in ("jax", "port")]
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tcp_env(monkeypatch):
    monkeypatch.setenv("BYTEPS_TRANSPORT", "tcp")
    for k in ("BYTEPS_COMPRESSION", "BYTEPS_COMPRESSION_REPLY",
              "BYTEPS_PARTITION_BYTES", "DMLC_NUM_WORKER"):
        monkeypatch.delenv(k, raising=False)
    _reset()
    yield
    monkeypatch.undo()
    _reset()


def _reset():
    jax_config.reset_config()
    port_config.reset_config()
    reset_counters()


def _fast_policy(pkg="port", **kw):
    kw.setdefault("max_attempts", 6)
    kw.setdefault("backoff_base", 0.01)
    kw.setdefault("jitter", 0.0)
    kw.setdefault("deadline", 20.0)
    return (RetryPolicy if pkg == "port" else JaxRetryPolicy)(**kw)


class _Shards:
    def __init__(self, pkg, n):
        self.servers = [PKG[pkg].serve(0, host="127.0.0.1", use_native=True,
                                       in_thread=True)[0] for _ in range(n)]
        self.addrs = [f"127.0.0.1:{s.server_address[1]}"
                      for s in self.servers]

    def close(self):
        for s in self.servers:
            s.shutdown()
            s.server_close()


def _bf16(pkg, values):
    x = np.asarray(values, np.float32)
    if pkg == "jax":
        return x.astype(ml_dtypes.bfloat16)
    return torch.from_numpy(x).to(torch.bfloat16)


def _bits(x):
    """A value's bytes, bf16 tensors and ml_dtypes arrays alike."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().tobytes()
    return np.asarray(x).tobytes()


def _op_script(client, shards):
    """The interop op script; returns every observable as bytes/ints."""
    C = PKG[client]
    rng = np.random.RandomState(0)
    a = C.RemoteStore(shards.addrs)
    b = C.RemoteStore(shards.addrs)
    out = {}
    w0 = rng.randn(10, 20).astype(np.float32)
    a.init_tensor("w", w0)
    b.init_tensor("w", w0 + 1)            # loses: told the winner's value
    out["loser_seed"] = _bits(b._last_global["w"])
    a.init_tensor("bf", _bf16(client, rng.randn(7)))
    a.init_tensor("i", np.arange(5, dtype=np.int32))
    a.push_delta("w", rng.randn(10, 20).astype(np.float32))
    out["pp_w"] = _bits(a.push_pull("w", rng.randn(10, 20).astype(
        np.float32)))
    out["pp_bf"] = _bits(a.push_pull("bf", _bf16(client, rng.randn(7))))
    b.push_delta("i", np.full(5, 3, np.int32))
    out["pull_w"] = _bits(b.pull("w"))
    out["pull_i"] = _bits(a.pull("i"))
    a.init_tensor("big", rng.randn(1000).astype(np.float32))   # 4 parts
    out["pp_big"] = _bits(a.push_pull("big", rng.randn(1000).astype(
        np.float32)))
    a._rpc(a._shard_of("s"), C.OP_SET, "s", np.ones(3, np.float32))
    a._rpc(a._shard_of("s"), C.OP_SET, "s", np.full(3, 2, np.float32))
    out["versions"] = [a.version(n) for n in ("w", "bf", "i", "s", "big")]
    out["names"] = sorted(a.names())
    many = b.pull_many(["w", "big", "i"])   # "big": a fresh meta here
    out["pull_many"] = [_bits(many[n]) for n in ("w", "big", "i")]
    fresh = C.RemoteStore(shards.addrs)
    out["discovered"] = _bits(fresh.pull("big"))
    out["pull_s"] = _bits(fresh.pull("s"))
    for c in (a, b, fresh):
        c.close()
    return out


def _run(client, server, n):
    shards = _Shards(server, n)
    try:
        return _op_script(client, shards)
    finally:
        shards.close()


@pytest.mark.parametrize("nshards", [1, 2])
@pytest.mark.parametrize("client,server", CELLS[1:])
def test_interop_matrix_bit_identical(monkeypatch, client, server, nshards):
    monkeypatch.setenv("BYTEPS_PARTITION_BYTES", "1024")
    _reset()
    want = _run("jax", "jax", nshards)
    got = _run(client, server, nshards)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    assert [n for n in want["names"] if n.startswith("big#p")] == \
        [f"big#p{i}" for i in range(4)]
    assert want["versions"] == [2, 1, 1, 1, 1]


def test_serial_client_equals_the_pipelined_one(monkeypatch):
    """``BYTEPS_WIRE_WINDOW=0``: the port's serial one-frame-in-flight
    client gives the JAX cell's bits too."""
    monkeypatch.setenv("BYTEPS_PARTITION_BYTES", "1024")
    _reset()
    want = _run("jax", "jax", 2)
    monkeypatch.setenv("BYTEPS_WIRE_WINDOW", "0")
    _reset()
    assert _run("port", "port", 2) == want


def test_server_profile_timeline(tmp_path, monkeypatch):
    """``BYTEPS_SERVER_ENABLE_PROFILE``: a chrome-trace array of B/E
    events a push / pull, keyed by the tensor's declared key, restricted
    by ``BYTEPS_SERVER_KEY_TO_PROFILE``; strict JSON once closed."""
    import json

    from byteps_tpu_torch.common.context import name_key

    path = tmp_path / "server_profile.json"
    monkeypatch.setenv("BYTEPS_SERVER_ENABLE_PROFILE", "1")
    monkeypatch.setenv("BYTEPS_SERVER_PROFILE_OUTPUT_PATH", str(path))
    monkeypatch.setenv("BYTEPS_SERVER_KEY_TO_PROFILE", str(name_key("w")))
    _reset()
    shards = _Shards("port", 1)
    s = pps.RemoteStore(shards.addrs)
    for n in ("w", "other"):
        s.init_tensor(n, np.zeros(8, np.float32))
        s.push_delta(n, np.ones(8, np.float32))
        s.push_pull(n, np.ones(8, np.float32))
        s.pull(n)
    s.close()
    shards.close()
    events = json.loads(path.read_text())
    assert [e["ph"] for e in events] == ["B", "E"] * 3
    assert {e["name"].split("-")[0] for e in events} == {"push", "push_pull",
                                                        "pull"}
    assert all(e["pid"] == name_key("w") for e in events)
    assert events[0]["args"] == {"tensor": "w"}


def _ef_run(client, server, steps=3):
    """Three error-feedback push_pulls of a [64, 33] tensor (and a raw
    small one) through ``client`` onto ``server``: the pulled values."""
    C = PKG[client]
    shards = _Shards(server, 2)
    rng = np.random.RandomState(11)
    try:
        s = C.RemoteStore(shards.addrs)
        s.init_tensor("g", rng.randn(64, 33).astype(np.float32))
        s.init_tensor("tiny", np.zeros(4, np.float32))
        outs = []
        for _ in range(steps):
            outs.append(s.push_pull("g", rng.randn(64, 33).astype(
                np.float32)))
            s.push_delta("tiny", np.ones(4, np.float32))
        outs.append(s.pull("tiny"))
        s.close()
        return [np.asarray(o) for o in outs]
    finally:
        shards.close()


@pytest.mark.parametrize("scheme", ["none", "bf16", "fp16", "onebit",
                                    "topk", "int8"])
def test_compressed_pushes_sum_bit_identically(monkeypatch, scheme):
    monkeypatch.setenv("BYTEPS_COMPRESSION", scheme)
    monkeypatch.setenv("BYTEPS_COMPRESSION_RATIO", "0.05")
    _reset()
    res = {cell: _ef_run(*cell) for cell in CELLS}
    for client in ("jax", "port"):   # the two shards sum alike
        for a, b in zip(res[(client, "jax")], res[(client, "port")]):
            assert a.tobytes() == b.tobytes()
    for a, b in zip(res[("jax", "jax")], res[("port", "port")]):
        if scheme == "onebit":
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
        else:
            assert a.tobytes() == b.tobytes()
    assert not np.array_equal(res[("jax", "jax")][0],
                              res[("jax", "jax")][1])


def test_reply_compression_bit_identical(monkeypatch):
    monkeypatch.setenv("BYTEPS_COMPRESSION_REPLY", "bf16")
    _reset()
    res = {cell: _ef_run(*cell, steps=2) for cell in CELLS}
    want = res[("jax", "jax")]
    for cell, got in res.items():
        for a, b in zip(want, got):
            assert a.dtype == b.dtype == np.float32, cell
            assert a.tobytes() == b.tobytes(), cell
    # the replies really were rounded to bf16 values
    g = want[0].view(np.uint32)
    assert np.all(g & 0xFFFF == 0)


def test_server_stats_name_the_reducer():
    shards = _Shards("port", 1)
    try:
        s = pps.RemoteStore(shards.addrs)
        s.init_tensor("w", np.zeros(1000, np.float32))
        s.push_pull("w", np.ones(1000, np.float32))
        st = s.shard_stats(0)
        assert st["role"] == "ps_server" and st["reducer"] == "native"
        assert st["sum_bytes"] == 4000 and st["omp_threads"] >= 1
        assert st["rss_bytes"] > 0 and st["cuda_initialized"] is False
        assert s.health() == [True] and s.ping()
        offs = s.record_clock_offsets(samples=2)
        assert len(offs) == 1 and abs(offs[0].offset_s) < 1.0
        s.close()
    finally:
        shards.close()


# ---------------------------------------------------------- refusals


@pytest.mark.parametrize("env,match", [
    ({"BYTEPS_HIERARCHICAL": "1"}, "hierarchical.py"),
    ({"BYTEPS_TRANSPORT": "shm"}, "unix / shm"),
    ({"BYTEPS_TRANSPORT": "unix:/tmp/x.sock"}, "unix / shm"),
    ({"BYTEPS_METRICS_PORT": "9091"}, "scrape"),
    ({"BYTEPS_TRACE_RPC": "1"}, "trace")])
def test_ps_tier_refuses_unported_knobs(monkeypatch, env, match):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _reset()
    with pytest.raises(NotImplementedError, match=match):
        pps.RemoteStore(["127.0.0.1:1"])
    if "BYTEPS_HIERARCHICAL" not in env:
        with pytest.raises(NotImplementedError, match=match):
            pps.PSServer(("127.0.0.1", 0))
    monkeypatch.undo()
    monkeypatch.setenv("BYTEPS_TRANSPORT", "tcp")
    _reset()
    with pytest.raises(NotImplementedError, match="hierarchical.py"):
        pps.RemoteStore(["127.0.0.1:1"], hierarchical=True)


def test_make_zero_step_is_refused_by_name():
    from byteps_tpu_torch.training import make_zero_step

    with pytest.raises(NotImplementedError, match="zero.py"):
        make_zero_step(None, None)


# --------------------------------------------------------- resilience


def _spawn_port_shard(port=0):
    srv, _ = pps.serve(port, host="127.0.0.1", use_native=False,
                       in_thread=True)
    return srv, f"127.0.0.1:{srv.server_address[1]}"


def _stop(srv):
    try:
        srv.shutdown()
        srv.server_close()
    except Exception:
        pass


@pytest.mark.parametrize("fault,dedup,op", [
    ("drop_after", 1, "push"),        # applied, reply lost: not resent
    ("drop_before", 0, "push"),       # request lost: resent
    ("drop_after", 1, "push_pull")])  # applied: the result recovered
def test_retried_mutation_applied_exactly_once(fault, dedup, op):
    srv, addr = _spawn_port_shard()
    proxy = FaultInjectingProxy(addr)
    counters = ResilienceCounters()
    try:
        store = pps.RemoteStore([proxy.addr], counters=counters,
                                retry_policy=_fast_policy())
        store.init_tensor("w", np.full(4, 10.0, np.float32))
        proxy.script(fault)
        if op == "push":
            store.push_delta("w", np.ones(4, np.float32))
        else:
            np.testing.assert_array_equal(
                store.push_pull("w", np.ones(4, np.float32)), 11.0)
        np.testing.assert_array_equal(store.pull("w"), 11.0)
        assert counters.get(cn.DEDUP) == dedup
        assert srv.store.version("w") == 1
        store.close()
    finally:
        proxy.close()
        _stop(srv)


def test_version_guard_off_beyond_one_worker(monkeypatch):
    """With DMLC_NUM_WORKER > 1 the version counter cannot attribute an
    advance to our lost push: retries resend (at least once);
    BYTEPS_RETRY_VERSION_GUARD=1 turns the guard back on."""
    monkeypatch.setenv("DMLC_NUM_WORKER", "4")
    _reset()
    srv, addr = _spawn_port_shard()
    proxy = FaultInjectingProxy(addr)
    counters = ResilienceCounters()
    try:
        store = pps.RemoteStore([proxy.addr], counters=counters,
                                retry_policy=_fast_policy())
        store.init_tensor("w", np.zeros(4, np.float32))
        proxy.script("drop_after")
        store.push_delta("w", np.ones(4, np.float32))
        np.testing.assert_array_equal(store.pull("w"), 2.0)
        assert counters.get(cn.DEDUP) == 0
        store.close()
        monkeypatch.setenv("BYTEPS_RETRY_VERSION_GUARD", "1")
        _reset()
        store = pps.RemoteStore([proxy.addr], counters=counters,
                                retry_policy=_fast_policy())
        store.init_tensor("w2", np.zeros(4, np.float32))
        proxy.script("drop_after")
        store.push_delta("w2", np.ones(4, np.float32))
        np.testing.assert_array_equal(store.pull("w2"), 1.0)
        assert counters.get(cn.DEDUP) == 1
        store.close()
    finally:
        proxy.close()
        _stop(srv)


def test_retry_policy_from_config_gives_jax_schedule(monkeypatch):
    for k, v in {"BYTEPS_RETRY_MAX_ATTEMPTS": "7",
                 "BYTEPS_RETRY_BACKOFF_MS": "5",
                 "BYTEPS_RETRY_BACKOFF_MULT": "3",
                 "BYTEPS_RETRY_JITTER": "0.2",
                 "BYTEPS_RETRY_DEADLINE_MS": "1000"}.items():
        monkeypatch.setenv(k, v)
    _reset()
    p = RetryPolicy.from_config()
    j = JaxRetryPolicy.from_config()
    assert (p.max_attempts, p.backoff_base, p.backoff_mult, p.backoff_cap,
            p.jitter, p.deadline) == (j.max_attempts, j.backoff_base,
                                      j.backoff_mult, j.backoff_cap,
                                      j.jitter, j.deadline)
    assert p.max_attempts == 7 and p.deadline == 1.0
    assert [p.backoff(k, random.Random(3)) for k in range(1, 9)] == \
        [j.backoff(k, random.Random(3)) for k in range(1, 9)]
    monkeypatch.setenv("BYTEPS_RETRY_MAX_ATTEMPTS", "0")
    _reset()
    assert RetryPolicy.from_config().max_attempts == 1


def _targets(dim, names):
    return {n: (np.arange(dim, dtype=np.float32) if n in ("w", "c0")
                else np.full(dim, -3.0, np.float32)) for n in names}


def _step(store, state, target):
    for n in state:
        delta = 0.1 * (target[n] - state[n])
        state[n] = store.push_pull(n, delta.astype(np.float32))


def test_shard_death_failover_restart_bitwise_recovery():
    """Kill one of two port shards mid-training: degraded mode re-homes
    its keys, re-seeded from the worker's state; the shard restarts
    (fresh store, same port), the heartbeat sees it and the state
    migrates back; the final values are bit for bit the no-fault run's
    (after tests/test_resilience.py::
    test_shard_death_failover_restart_bitwise_recovery, shorter)."""
    dim, steps, kill_at, restart_at = 8, 12, 4, 8
    names = ("w", "b", "c0", "c1")
    target = _targets(dim, names)
    s1, a1 = _spawn_port_shard()
    s2, a2 = _spawn_port_shard()
    ref_store = pps.RemoteStore([a1, a2], retry_policy=_fast_policy())
    assert {ref_store._shard_of(n) for n in names} == {0, 1}
    ref = {n: np.zeros(dim, np.float32) for n in names}
    for n in names:
        ref_store.init_tensor(n, ref[n])
    for _ in range(steps):
        _step(ref_store, ref, target)
    ref_store.close()
    _stop(s1)
    _stop(s2)

    servers, addrs = [], []
    for _ in range(2):
        srv, addr = _spawn_port_shard()
        servers.append(srv)
        addrs.append(addr)
    counters = ResilienceCounters()
    store = pps.RemoteStore(addrs, counters=counters,
                            retry_policy=_fast_policy(max_attempts=2,
                                                      deadline=5.0),
                            heartbeat=0.05)
    victim = store._shard_of("b")
    port = int(addrs[victim].rsplit(":", 1)[1])
    state = {n: np.zeros(dim, np.float32) for n in names}
    for n in names:
        store.init_tensor(n, state[n])
    try:
        for step in range(steps):
            if step == kill_at:
                servers[victim].kill()
            if step == restart_at:
                servers[victim], _ = _spawn_port_shard(port)
                deadline = time.monotonic() + 15.0
                while store._router.is_down(victim) and \
                        time.monotonic() < deadline:
                    time.sleep(0.02)
                assert not store._router.is_down(victim)
            _step(store, state, target)
        assert counters.get(cn.FAILOVER) >= 1
        assert counters.get(cn.REINIT) >= 1
        assert counters.get(cn.FAILBACK) >= 1
        for n in names:
            assert store.pull(n).tobytes() == ref[n].tobytes(), n
    finally:
        store.close()
        for srv in servers:
            _stop(srv)


def test_single_shard_restart_reseeds_without_failover():
    """A one-shard cluster whose shard restarts with a fresh store keeps
    training: the KeyError triggers a one-shot re-seed from the last-seen
    state.  The restarted shard is pinged until it answers before the next
    op, and the retry budget is generous, so a loaded host does not turn
    the restart's timing into a failure."""
    srv, addr = _spawn_port_shard()
    port = srv.server_address[1]
    counters = ResilienceCounters()
    store = pps.RemoteStore([addr], counters=counters,
                            retry_policy=_fast_policy(max_attempts=8,
                                                      deadline=30.0))
    try:
        store.init_tensor("w", np.zeros(4, np.float32))
        np.testing.assert_array_equal(
            store.push_pull("w", np.ones(4, np.float32)), 1.0)
        srv.kill()
        srv, _ = _spawn_port_shard(port)
        deadline = time.monotonic() + 15.0
        while not store.ping() and time.monotonic() < deadline:
            time.sleep(0.05)
        out = store.push_pull("w", np.full(4, 2.0, np.float32))
        np.testing.assert_array_equal(out, 3.0)
        assert counters.get(cn.REINIT) >= 1
        with pytest.raises(RuntimeError, match="ps_server error"):
            store.pull("never_declared")
    finally:
        store.close()
        _stop(srv)


# ------------------------------------------------------- the server role


SERVER_CHILD = """
import os, sys, threading, time
import numpy as np
import torch
from byteps_tpu_torch import launcher
from byteps_tpu_torch.engine.ps_server import RemoteStore
t = threading.Thread(target=launcher.main, daemon=True)
t.start()
addr = "127.0.0.1:" + os.environ["BYTEPS_SERVER_PORT"]
deadline = time.monotonic() + 60
store = None
while True:
    try:
        store = RemoteStore([addr], timeout=5)
        if store.ping():
            break
    except Exception:
        pass
    if time.monotonic() > deadline:
        raise SystemExit("the shard never answered")
    time.sleep(0.1)
print("SHARD UP", flush=True)
while True:   # the parent's JAX client sets "done" when it is through
    if "done" in store.names():
        break
    if time.monotonic() > deadline:
        raise SystemExit("the parent never finished")
    time.sleep(0.05)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "byteps_tpu" or m.startswith("byteps_tpu.")]
assert not bad, bad
assert not torch.cuda.is_initialized()
print("CHILD OK", flush=True)
"""


def _server_child(port, extra=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BYTEPS_", "DMLC_"))}
    env.update({"DMLC_ROLE": "server", "BYTEPS_ENABLE_ASYNC": "1",
                "BYTEPS_SERVER_PORT": str(port), "BYTEPS_LOG_LEVEL": "INFO",
                "OMP_NUM_THREADS": "2",
                "PYTHONPATH": os.pathsep.join(
                    [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                              if p])})
    env.update(extra or {})
    return subprocess.Popen([sys.executable, "-c", SERVER_CHILD], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _drive_with_jax(port):
    store = jps.RemoteStore([f"127.0.0.1:{port}"],
                            retry_policy=_fast_policy("jax"))
    try:
        x = np.random.RandomState(2).randn(300).astype(np.float32)
        store.init_tensor("w", x)
        out = store.push_pull("w", np.ones(300, np.float32))
        assert out.tobytes() == (x + np.float32(1)).tobytes()
        assert store.version("w") == 1
        store._rpc(0, jps.OP_SET, "done", np.zeros(1, np.float32))
    finally:
        store.close()


def _wait_up(proc, mark="SHARD UP", timeout=60.0):
    """The child's output lines up to the one holding ``mark``."""
    deadline = time.monotonic() + timeout
    lines = []
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if mark in line:
            return lines
    proc.kill()
    raise AssertionError("".join(lines))


def test_server_role_answers_a_jax_client_without_cuda():
    port = free_port()
    proc = _server_child(port)
    try:
        lines = _wait_up(proc)
        _drive_with_jax(port)
        out, _ = proc.communicate(timeout=60)
        text = "".join(lines) + out
        assert proc.returncode == 0, text
        assert "CHILD OK" in text
        assert "reducer native, 2 OpenMP threads" in text
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_server_role_restarts_a_crashed_shard():
    """The shard's first start dies (its port is taken); the supervisor
    restarts it after the backoff and the restarted shard serves."""
    port = free_port()
    import socket

    blocker = socket.socket()
    blocker.bind(("0.0.0.0", port))
    blocker.listen(1)
    proc = _server_child(port, {"BYTEPS_SERVER_MAX_RESTARTS": "1",
                                "BYTEPS_SERVER_RESTART_BACKOFF_MS": "300"})
    try:
        lines = _wait_up(proc, "restart 1/1")
        blocker.close()
        lines += _wait_up(proc)
        _drive_with_jax(port)
        out, _ = proc.communicate(timeout=60)
        text = "".join(lines) + out
        assert proc.returncode == 0, text
        assert "restart 1/1" in text and "CHILD OK" in text
    finally:
        blocker.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
