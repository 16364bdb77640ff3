"""The port's serving router (``byteps_tpu_torch/serving/router.py``),
held against the JAX package's ``ServeRouter`` and ``generate()``.

Weights come from one JAX init carried across with ``from_jax_params``;
prompts from numpy with a fixed seed.  Port replicas are paged engines
(block 8, chunk 16) on the CPU, JAX replicas the JAX dense engine.

* Parity: a port router over port replicas gives the tokens a JAX router
  over JAX replicas gives, and JAX ``generate()`` gives — in process and
  through the port's ``RouterFrontend`` and client; the same ``_digest``
  and rendezvous order (``_hrw_order``) for the same prompts and
  addresses; a port router over JAX replicas equals a JAX router over
  them.
* The typed errors: a mixed JAX + port tier is refused
  ``WeightsMismatchError`` by both routers; the error classes carry the
  same names and client-side ``retryable`` flags.
* Failover mid-stream (a ``FaultInjectingProxy`` cut after k frames),
  greedy and seeded, token-identical; a cut after the last token
  completes without a redispatch; the wire ``resume`` param.
* Affinity, shedding to the next-best replica, a drain with no client
  error, saturation waiting out the deadline, the typed deadline failure.
* The weights handshake: homogeneous, a mismatch at registration, on
  ping and failback, and a pinned fingerprint.
* Tenant fair share (apportionment, debit, return); a cancel through the
  router that reclaims the replica's blocks; a cancel ahead of its
  submit (tombstoned).
* The disaggregated legs, driven by a port router over a prefill and a
  decode port replica: every ship whole, greedy == ``generate()``,
  seeded == the port's colocated engine.
* ``router_from_env``'s refusals carry JAX's messages, with the port's
  launcher named; the router role, run by the port's launcher in a child
  process, serves a request and leaves CUDA uninitialised.
"""

import contextlib
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.common.config import reset_config as jax_reset_config
from byteps_tpu.inference import generate
from byteps_tpu.models.transformer import Transformer as JaxTransformer
from byteps_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from byteps_tpu.observability.metrics import \
    MetricsRegistry as JaxRegistry
from byteps_tpu.resilience.policy import RetryPolicy as JaxRetry
from byteps_tpu.serving import ServeClient as JaxServeClient
from byteps_tpu.serving import ServeMetrics as JaxServeMetrics
from byteps_tpu.serving import ServeReplyError as JaxReplyError
from byteps_tpu.serving import ServeRouter as JaxRouter
from byteps_tpu.serving import ServingEngine as JaxServingEngine
from byteps_tpu.serving import router as jrt
from byteps_tpu.serving.frontend import serve as jax_serve
from byteps_tpu_torch.common.config import reset_config
from byteps_tpu_torch.engine.transport import free_port
from byteps_tpu_torch.models.convert import from_jax_params
from byteps_tpu_torch.models.transformer import Transformer, TransformerConfig
from byteps_tpu_torch.observability.metrics import MetricsRegistry
from byteps_tpu_torch.resilience import FaultInjectingProxy
from byteps_tpu_torch.resilience.policy import RetryPolicy
from byteps_tpu_torch.serving import (OP_STREAM, RemoteServeClient,
                                      ReplicaLostError, ReplicaState,
                                      RouterFrontend, RouterStandbyError,
                                      ServeClient, ServeMetrics,
                                      ServeReplyError, ServeRouter,
                                      ServingEngine, WeightsMismatchError,
                                      router_from_env, serve, serve_router)
from byteps_tpu_torch.serving import metrics as sm
from byteps_tpu_torch.serving import router as rt

M = 8  # new tokens per request
KW = dict(vocab_size=61, num_layers=2, num_heads=2, d_model=32, d_ff=64,
          max_seq_len=64)
LENGTHS = (9, 13, 17)   # 2-3 blocks of 8


def _prompts(lengths=LENGTHS, seed=30):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 61, size=(n,)).astype(np.int32) for n in lengths]


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxTransformerConfig(dtype=jnp.float32, **KW)
    jmodel = JaxTransformer(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(1),
                            jnp.zeros((1, 8), jnp.int32))
    pcfg = TransformerConfig(dtype=torch.float32, **KW)
    state = from_jax_params(jax.tree_util.tree_map(np.asarray, variables),
                            pcfg)
    return jmodel, variables, pcfg, state


@pytest.fixture(scope="module")
def greedy_refs(tiny):
    jmodel, variables, _, _ = tiny
    return [list(np.asarray(generate(jmodel, variables, p[None], M,
                                     temperature=0.0)["tokens"])[0])
            for p in _prompts()]


def _port_engine(tiny, state=None, **kw):
    _, _, pcfg, st = tiny
    model = Transformer(pcfg)
    model.load_state_dict(st if state is None else state)
    kw.setdefault("paged", True)
    kw.setdefault("block", 8)
    kw.setdefault("chunk", 16)
    return ServingEngine(model, n_slots=4, max_seq=64, device="cpu",
                         metrics=ServeMetrics(), **kw)


@contextlib.contextmanager
def _frontends(*engines, serve_fn=serve):
    srvs = [serve_fn(e, 0, host="127.0.0.1", in_thread=True)
            for e in engines]
    try:
        yield ([s for s, _ in srvs],
               [f"127.0.0.1:{s.server_address[1]}" for s, _ in srvs])
    finally:
        for s, t in srvs:
            s.shutdown()
            s.server_close()
            t.join(timeout=10)


@pytest.fixture(scope="module")
def port_pair(tiny):
    engines = [_port_engine(tiny) for _ in range(2)]
    with _frontends(*engines) as (srvs, addrs):
        yield engines, srvs, addrs


@pytest.fixture(scope="module")
def jax_pair(tiny):
    """Two JAX dense replicas on TCP alone (no Unix-socket rendezvous
    file under their ports), each compiled by one request here."""
    jmodel, variables, _, _ = tiny
    old = os.environ.get("BYTEPS_TRANSPORT")
    os.environ["BYTEPS_TRANSPORT"] = "tcp"
    jax_reset_config()
    engines = [JaxServingEngine(jmodel, variables, n_slots=4, max_seq=64,
                                temperature=0.0, metrics=JaxServeMetrics())
               for _ in range(2)]
    try:
        with _frontends(*engines, serve_fn=jax_serve) as (srvs, addrs):
            for e in engines:
                for p in _prompts():
                    JaxServeClient(e).generate(p, M)
            yield engines, srvs, addrs
    finally:
        if old is None:
            os.environ.pop("BYTEPS_TRANSPORT", None)
        else:
            os.environ["BYTEPS_TRANSPORT"] = old
        jax_reset_config()


def _retry(cls=RetryPolicy, **kw):
    kw.setdefault("max_attempts", 5)
    return cls(backoff_base=0.02, jitter=0.0, backoff_cap=0.1, deadline=0.0,
               **kw)


def _router(addrs, **kw):
    kw.setdefault("affinity", False)
    kw.setdefault("stream_timeout", 5.0)
    kw.setdefault("deadline", 30.0)
    kw.setdefault("ping_timeout", 30.0)
    kw.setdefault("registry", MetricsRegistry())
    kw.setdefault("retry", _retry())
    return ServeRouter(addrs, **kw)


def _jax_router(addrs, **kw):
    kw.setdefault("affinity", False)
    kw.setdefault("stream_timeout", 5.0)
    kw.setdefault("deadline", 30.0)
    kw.setdefault("ping_timeout", 30.0)
    kw.setdefault("registry", JaxRegistry())
    kw.setdefault("retry", _retry(JaxRetry))
    return JaxRouter(addrs, **kw)


def _handshake(router):
    """The registration handshake alone (what ``start()`` runs first),
    before a proxy's fault is armed: its STATS round trip is a proxied
    request too."""
    for rep in router._replicas:
        router._verify_replica_weights(rep, raising=True)


def _submitted(engine):
    return engine.metrics.get(sm.SUBMITTED)


def _slow_ticks(engine):
    step = engine.step

    def slow_step():
        time.sleep(0.02)
        return step()

    engine.step = slow_step
    return engine


# ------------------------------------------------------------------ parity


def test_port_router_equals_jax_router_and_generate(tiny, greedy_refs,
                                                    port_pair, jax_pair):
    """Round robin over two replicas, blocking and streamed, in process
    and through the router's own wire: the port tier, the JAX tier and
    ``generate()`` agree token for token."""
    engines, _, addrs = port_pair
    prompts = _prompts()
    router = _router(addrs)
    jrouter = _jax_router(jax_pair[2])
    try:
        for p, want in zip(prompts, greedy_refs):
            assert list(router.generate(p, M)) == want
            assert list(router.stream(p, M)) == want
            assert list(jrouter.stream(p, M)) == want
        assert _submitted(engines[0]) > 0 and _submitted(engines[1]) > 0
        srv, t = serve_router(router, 0, host="127.0.0.1", in_thread=True)
        try:
            c = RemoteServeClient(f"127.0.0.1:{srv.server_address[1]}")
            assert list(c.generate(prompts[0], M)) == greedy_refs[0]
            assert list(c.stream(prompts[1], M)) == greedy_refs[1]
            assert c.ping()
            st = c.stats()
            assert len(st["replicas"]) == 2 and st["role"] == "active"
            assert st[rt.COMPLETED] >= 8 and st[rt.FAILED] == 0
            # STATS carries JAX's keys (poll_router and clients read them)
            assert set(st) == set(jrouter.stats())
            c.close()
        finally:
            srv.shutdown()
            srv.server_close()
            t.join(timeout=10)
    finally:
        router.close()
        jrouter.close()


def test_placement_hash_and_order_match_jax():
    addrs = [f"10.0.0.{i}:{9000 + i}" for i in range(5)]
    rng = np.random.RandomState(4)
    for block in (4, 16):
        a = _router(addrs, affinity=True, affinity_block=block)
        b = _jax_router(addrs, affinity=True, affinity_block=block)
        for n in (1, 3, 16, 40):
            for _ in range(6):
                p = rng.randint(0, 50000, size=(n,)).astype(np.int32)
                d = a._digest(p)
                assert d == b._digest(p)
                assert a._hrw_order(d) == b._hrw_order(d)
                ra, rb = a._acquire(d, set()), b._acquire(d, set())
                assert ra.idx == rb.idx
                a._release(ra)
                b._release(rb)
        a.close()
        b.close()


def test_port_router_over_jax_replicas_equals_jax_router(tiny, greedy_refs,
                                                         jax_pair):
    _, _, addrs = jax_pair
    router = _router(addrs, affinity=True)
    jrouter = _jax_router(addrs, affinity=True)
    try:
        _handshake(router)
        _handshake(jrouter)
        assert router._expected_fp == jrouter._expected_fp is not None
        for p, want in zip(_prompts(), greedy_refs):
            got = list(router.stream(p, M))
            assert got == list(jrouter.stream(p, M)) == want
    finally:
        router.close()
        jrouter.close()


def test_mixed_tier_refused_by_both_routers(port_pair, jax_pair):
    mixed = [port_pair[2][0], jax_pair[2][0]]
    for mk, err in ((_router, WeightsMismatchError),
                    (_jax_router, jrt.WeightsMismatchError)):
        router = mk(mixed)
        try:
            with pytest.raises(err, match="different"):
                router.start()
            assert router._replicas[1].refused
        finally:
            router.close()
    for name in ("WeightsMismatchError", "RouterStandbyError",
                 "ReplicaLostError", "OverloadShedError"):
        a, b = ServeReplyError("m", name), JaxReplyError("m", name)
        assert (a.retryable, a.shed) == (b.retryable, b.shed)
    for mine, ref in ((ReplicaLostError, jrt.ReplicaLostError),
                      (RouterStandbyError, jrt.RouterStandbyError),
                      (WeightsMismatchError, jrt.WeightsMismatchError)):
        assert mine.__name__ == ref.__name__
        assert mine.__mro__[1].__name__ == ref.__mro__[1].__name__
    assert [s.value for s in ReplicaState] == [
        s.value for s in jrt.ReplicaState]


# ---------------------------------------------------------------- failover


def test_failover_mid_stream_greedy(tiny, greedy_refs, port_pair):
    _, _, addrs = port_pair
    proxy = FaultInjectingProxy(addrs[0], serve_stream_op=OP_STREAM)
    router = _router([proxy.addr, addrs[1]])
    _handshake(router)
    proxy.script(("cut_stream", 3))
    try:
        assert list(router.stream(_prompts()[0], M)) == greedy_refs[0]
        st = router.stats()
        assert st[rt.FAILOVERS] == 1 and st[rt.REDISPATCHES] == 1
        assert st[rt.COMPLETED] == 1 and st[rt.FAILED] == 0
    finally:
        router.close()
        proxy.close()


def test_failover_mid_stream_seeded(tiny):
    """Sampling at temperature 0.8: the survivor resumes the sampled
    stream from the received prefix — equal to the stream of one
    uninterrupted replica at the same seed."""
    p = _prompts()[1]
    engines = [_port_engine(tiny, temperature=0.8) for _ in range(2)]
    with _frontends(*engines) as (_, addrs):
        c = RemoteServeClient(addrs[1], timeout=30)
        want = list(c.stream(p, M, seed=7))
        c.close()
        proxy = FaultInjectingProxy(addrs[0], serve_stream_op=OP_STREAM)
        router = _router([proxy.addr, addrs[1]])
        _handshake(router)
        proxy.script(("cut_stream", 2))
        try:
            assert list(router.stream(p, M, seed=7)) == want
            assert router.stats()[rt.REDISPATCHES] == 1
        finally:
            router.close()
            proxy.close()


def test_cut_after_final_token_completes(tiny, greedy_refs, port_pair):
    _, _, addrs = port_pair
    proxy = FaultInjectingProxy(addrs[0], serve_stream_op=OP_STREAM)
    router = _router([proxy.addr, addrs[1]])
    _handshake(router)
    proxy.script(("cut_stream", M))
    try:
        assert list(router.stream(_prompts()[0], M)) == greedy_refs[0]
        st = router.stats()
        assert st[rt.COMPLETED] == 1 and st[rt.REDISPATCHES] == 0
    finally:
        router.close()
        proxy.close()


def test_wire_resume_param_through_the_router(tiny, greedy_refs, port_pair):
    router = _router(port_pair[2])
    srv, t = serve_router(router, 0, host="127.0.0.1", in_thread=True)
    try:
        c = RemoteServeClient(f"127.0.0.1:{srv.server_address[1]}")
        want, k = greedy_refs[0], 3
        assert list(c.stream(_prompts()[0], M, resume=want[:k])) == want[k:]
        assert list(c.generate(_prompts()[0], M, resume=want[:k])) == want
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)


# ----------------------------------------------- placement and backpressure


def test_affinity_steers_shared_prefix(tiny, port_pair):
    engines, _, addrs = port_pair
    shared = np.random.RandomState(99).randint(0, 61, (16,)).astype(np.int32)
    jobs = [np.concatenate([shared, np.asarray([i, i + 1], np.int32)])
            for i in range(3)]
    before = [_submitted(e) for e in engines]
    router = _router(addrs, affinity=True, affinity_block=16)
    try:
        for p in jobs:
            router.generate(p, 4)
        deltas = [_submitted(e) - b for e, b in zip(engines, before)]
        assert sorted(deltas) == [0, 3], deltas
        st = router.stats()
        assert (st[rt.AFFINITY_HITS], st[rt.AFFINITY_MISSES]) == (2, 1)
    finally:
        router.close()


def test_sheds_to_next_best_when_full(port_pair):
    router = _router(port_pair[2], affinity=True, credits=1)
    try:
        digest = router._digest(np.arange(16, dtype=np.int32))
        r1 = router._acquire(digest, set())
        r2 = router._acquire(digest, set())
        assert r1 is not None and r2 is not None and r2.idx != r1.idx
        assert router.stats()[rt.SHEDS] == 1
        assert router._acquire(digest, set()) is None
        router._release(r1)
        router._release(r2)
        r4 = router._acquire(digest, set())
        assert r4.idx == r1.idx   # the transient shed did not re-home
        router._release(r4)
    finally:
        router.close()


def test_drain_zero_client_visible_errors(tiny, greedy_refs, port_pair):
    engines, _, addrs = port_pair
    prompts = _prompts()
    router = _router(addrs)
    try:
        stream = router.stream(prompts[0], M)
        first = next(stream)
        drained = threading.Event()

        def _drain():
            router.drain(0, timeout=30.0)
            drained.set()

        threading.Thread(target=_drain, daemon=True).start()
        assert [first] + list(stream) == greedy_refs[0]
        assert drained.wait(30.0)
        assert router._replicas[0].state is ReplicaState.DRAINING
        before = _submitted(engines[1])
        for p, want in zip(prompts[1:], greedy_refs[1:]):
            assert list(router.generate(p, M)) == want
        assert _submitted(engines[1]) - before == 2
        assert router.stats()[rt.FAILED] == 0
    finally:
        router.close()


def test_saturation_waits_out_the_deadline(tiny, greedy_refs, port_pair):
    router = _router(port_pair[2], credits=1, retry=_retry(max_attempts=3))
    try:
        p = _prompts()[0]
        digest = router._digest(p)
        held = [router._acquire(digest, set()),
                router._acquire(digest, set())]
        assert all(h is not None for h in held)
        timer = threading.Timer(
            0.4, lambda: [router._release(h) for h in held])
        timer.start()
        t0 = time.monotonic()
        assert list(router.generate(p, M, deadline=10.0)) == greedy_refs[0]
        assert time.monotonic() - t0 >= 0.35
        timer.join()
    finally:
        router.close()


def test_deadline_typed_failure_never_hangs():
    router = _router(["127.0.0.1:9"], deadline=1.0, ping_timeout=0.5)
    try:
        t0 = time.monotonic()
        with pytest.raises(ReplicaLostError) as ei:
            router.generate(_prompts()[0], M)
        assert time.monotonic() - t0 < 5.0 and ei.value.emitted == []
    finally:
        router.close()


# -------------------------------------------------------- weights handshake


def _other_state(tiny, seed):
    _, _, pcfg, _ = tiny
    jmodel = JaxTransformer(JaxTransformerConfig(dtype=jnp.float32, **KW))
    other = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8),
                                                            jnp.int32))
    return from_jax_params(jax.tree_util.tree_map(np.asarray, other), pcfg)


def test_weights_handshake_homogeneous_mismatch_and_pin(tiny, greedy_refs,
                                                        port_pair):
    engines, _, addrs = port_pair
    c = RemoteServeClient(addrs[0])
    fp = c.stats()["weights_fingerprint"]
    c.close()
    router = _router(addrs).start()
    try:
        assert router._expected_fp == fp
        assert all(r.verified and not r.refused for r in router._replicas)
    finally:
        router.close()
    bad_eng = _port_engine(tiny, state=_other_state(tiny, 99))
    with _frontends(bad_eng) as (_, (bad_addr,)):
        router = _router([addrs[0], bad_addr])
        try:
            with pytest.raises(WeightsMismatchError, match="different"):
                router.start()
            bad = router._replicas[1]
            assert bad.refused and not bad.placeable
            assert bad.state is ReplicaState.DEAD
            assert router.stats()[rt.WEIGHTS_REFUSED] == 1
            for p, want in zip(_prompts()[:2], greedy_refs[:2]):
                assert list(router.generate(p, M)) == want
            assert _submitted(bad_eng) == 0
        finally:
            router.close()
    router = _router(addrs, expected_weights_fp=fp).start()
    try:
        assert list(router.generate(_prompts()[0], M)) == greedy_refs[0]
    finally:
        router.close()
    router = _router(addrs, expected_weights_fp="00" * 16)
    try:
        with pytest.raises(WeightsMismatchError, match="pinned"):
            router.start()
        assert router._replicas[0].refused
        assert router._expected_fp == "00" * 16
    finally:
        router.close()


def test_weights_handshake_on_ping_and_failback(tiny, port_pair):
    _, _, addrs = port_pair
    bad_eng = _port_engine(tiny, state=_other_state(tiny, 98))
    good_eng = _port_engine(tiny)
    with _frontends(bad_eng, good_eng) as (_, (bad_addr, good_addr)):
        router = _router([addrs[0], "127.0.0.1:1"], ping_timeout=5.0)
        try:
            router._verify_replica_weights(router._replicas[0],
                                           raising=False)
            assert router._replicas[0].verified
            router._on_replica_down(0)
            assert not router._replicas[0].verified
            router._on_replica_up(0)
            assert router._replicas[0].verified
            assert router._replicas[0].placeable
            router._replicas[1].addr = bad_addr
            assert router._ping_replica(1)
            assert router._replicas[1].refused
            assert router.stats()[rt.WEIGHTS_REFUSED] == 1
            router._replicas[1].addr = good_addr
            assert router._ping_replica(1)
            assert not router._replicas[1].refused
            assert router._replicas[1].placeable
        finally:
            router.close()


# ------------------------------------------------ tenants and wire cancel


def test_tenant_fair_share_pools_and_debit(port_pair):
    router = _router(port_pair[2], credits=3,
                     tenant_weights={"a": 3.0, "b": 1.0})
    jrouter = _jax_router(port_pair[2], credits=3,
                          tenant_weights={"a": 3.0, "b": 1.0})
    try:
        shares = {t: q.credits for t, q in router._tenant_pools.items()}
        assert shares == {"a": 4, "b": 1, "default": 1}
        assert shares == {t: q.credits
                          for t, q in jrouter._tenant_pools.items()}
        assert len(list(router.stream(_prompts()[0], 2, tenant="b"))) == 2
        assert router.stats()["tenant_credits"] == shares
    finally:
        router.close()
        jrouter.close()
    for weights, n in (({"a": 0.0}, 3), ({"a": 1.0, "b": 1.0}, 1)):
        errs = []
        for mk in (_router, _jax_router):
            with pytest.raises(ValueError) as ei:
                mk(["127.0.0.1:1"], credits=n, tenant_weights=weights)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]


def test_wire_cancel_reclaims_blocks_through_the_router(tiny):
    engine = _slow_ticks(_port_engine(tiny))
    baseline = engine.pool.block_stats()["used"]
    with _frontends(engine) as (_, (rep_addr,)):
        router = _router([rep_addr])
        fr = RouterFrontend(("127.0.0.1", 0), router)
        threading.Thread(target=fr.serve_forever, daemon=True).start()
        raddr = f"127.0.0.1:{fr.server_address[1]}"
        cli = RemoteServeClient(raddr, timeout=10.0)
        try:
            toks = []
            for tok in cli.stream(_prompts()[0], 40, rid="victim"):
                toks.append(int(tok))
                if len(toks) == 2:
                    c = RemoteServeClient(raddr, timeout=5.0)
                    assert c.cancel("victim") is True
                    c.close()
            assert 2 <= len(toks) < 40
            deadline = time.monotonic() + 5.0
            while (engine.pool.block_stats()["used"] != baseline
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert engine.pool.block_stats()["used"] == baseline
            st = router.stats()
            assert st[rt.CANCELS] == 1 and st[rt.CANCELLED] == 1
            c = RemoteServeClient(raddr, timeout=5.0)
            assert c.cancel("early") is False
            assert len(list(c.stream(_prompts()[1], 40, rid="early"))) < 40
            c.close()
            assert engine.pool.block_stats()["used"] == baseline
        finally:
            cli.close()
            fr.kill()


# ------------------------------------------------------- disaggregated legs


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_disagg_legs_driven_by_a_port_router(tiny, greedy_refs, temperature):
    prompts = _prompts()[:2]
    if temperature == 0.0:
        refs = greedy_refs[:2]
    else:
        colo = ServeClient(_port_engine(tiny, temperature=temperature))
        refs = [list(colo.generate(p, M, seed=100 + i))
                for i, p in enumerate(prompts)]
        colo.close()
    engines = [_port_engine(tiny, temperature=temperature)
               for _ in range(2)]
    base = [e.pool.alloc.used_count for e in engines]
    with _frontends(*engines) as (_, addrs):
        router = _router(addrs, roles=["prefill", "decode"], affinity=True,
                         credits=4)
        _handshake(router)
        try:
            for i, p in enumerate(prompts):
                assert list(router.stream(p, M, seed=100 + i)) == refs[i]
            st = router.stats()
            assert st["disagg"] is True
            assert st[rt.DISAGG_PREFILLS] == len(prompts)
            assert st[rt.DISAGG_SHIPPED_BLOCKS] >= 2 * len(prompts)
            assert st[rt.DISAGG_FALLBACKS] == 0 and st[rt.REDISPATCHES] == 0
            assert engines[0].metrics.get(sm.KV_BLOCKS_SHIPPED) >= 2 * len(
                prompts)
            assert engines[1].metrics.get(sm.KV_BLOCKS_SHIPPED) == 0
            assert engines[1].step_counts()["prefill_chunks"] == 0
            assert [e.pool.alloc.used_count for e in engines] == base
        finally:
            router.close()


# ------------------------------------------------- the launcher's role


ROUTER_ENV = ("BYTEPS_ROUTER_REPLICAS", "BYTEPS_ROUTER_PEERS",
              "BYTEPS_ROUTER_SELF", "BYTEPS_ROUTER_TENANT_WEIGHTS",
              "BYTEPS_ROUTER_ROLES")


@pytest.mark.parametrize("env", [
    {},
    {"BYTEPS_ROUTER_REPLICAS": "h:1", "BYTEPS_ROUTER_PEERS": "r:1,r:2"},
    {"BYTEPS_ROUTER_REPLICAS": "h:1", "BYTEPS_ROUTER_TENANT_WEIGHTS": "a="},
    {"BYTEPS_ROUTER_REPLICAS": "h:1",
     "BYTEPS_ROUTER_TENANT_WEIGHTS": "a=x"},
    {"BYTEPS_ROUTER_REPLICAS": "h:1,h:2", "BYTEPS_ROUTER_ROLES": "prefill"},
], ids=["no-replicas", "peers-without-self", "malformed-weights",
        "weight-not-a-number", "roles-length"])
def test_router_from_env_refusals_match_jax(env, monkeypatch):
    from byteps_tpu.serving.router import router_from_env as jax_from_env

    for k in ROUTER_ENV:
        monkeypatch.delenv(k, raising=False)
    msgs = []
    for fn in (router_from_env, jax_from_env):
        with pytest.raises(SystemExit) as ei:
            fn(env)
        msgs.append(str(ei.value.code))
    for k in env:
        monkeypatch.delenv(k, raising=False)
    reset_config()
    jax_reset_config()
    assert msgs[0].startswith("byteps_tpu_torch.launcher: ")
    assert msgs[0].replace("byteps_tpu_torch.launcher",
                           "byteps_tpu.launcher") == msgs[1]


ROUTER_CHILD = """
import sys, threading, time
import numpy as np
import torch
from byteps_tpu_torch import launcher
from byteps_tpu_torch.serving import RemoteServeClient
t = threading.Thread(target=launcher.main, daemon=True)
t.start()
addr = "127.0.0.1:" + sys.argv[1]
deadline = time.monotonic() + 60
while True:
    try:
        c = RemoteServeClient(addr, timeout=30)
        break
    except Exception:
        if time.monotonic() > deadline:
            raise
        time.sleep(0.1)
toks = c.generate(np.arange(5, 14, dtype=np.int32), 4)
assert toks.shape == (4,), toks
assert c.stats()["role"] == "active"
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "byteps_tpu" or m.startswith("byteps_tpu.")]
assert not bad, bad
assert not torch.cuda.is_initialized()
print("ROUTER-OK", list(toks))
"""


@pytest.fixture(scope="module")
def router_child(port_pair):
    """``DMLC_ROLE=router`` through the port's launcher in a child
    process over a port replica of this process (a module fixture: the
    child's interpreter and torch import take seconds on a loaded
    host)."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BYTEPS_", "DMLC_"))}
    env.update(DMLC_ROLE="router", BYTEPS_ROUTER_PORT=str(port),
               BYTEPS_ROUTER_REPLICAS=port_pair[2][0],
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.dirname(__file__))]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.run([sys.executable, "-c", ROUTER_CHILD, str(port)],
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_router_role_child_serves_and_leaves_cuda_alone(router_child,
                                                        port_pair):
    """The router role answers a request, loads neither jax nor the JAX
    package, and creates no CUDA context."""
    assert router_child.returncode == 0, router_child.stderr[-3000:]
    c = RemoteServeClient(port_pair[2][0])
    want = list(c.generate(np.arange(5, 14, dtype=np.int32), 4))
    c.close()
    assert f"ROUTER-OK {want}" in router_child.stdout
