"""The port's serve replica on the wire, held against the JAX package:
everything a JAX ``ServeRouter`` sends a replica.

* A JAX ``ServeRouter(roles=["prefill", "decode"])`` over two port
  frontends (block 8, chunk 16, prompts of 2-3 blocks): greedy tokens
  equal JAX ``generate()``, every KV ship whole (no disagg fallback, no
  redispatch, ``ship_n`` = the prompts, no block leaked on either pool);
  seeded (temperature 0.8) tokens equal the port's own colocated engine
  at the same seeds.
* The epoch fence: the same sequence of epochs fenced the same way, with
  the same message, on both engines.
* OP_CANCEL from a JAX client against a port frontend: mid-stream (the
  stream ends with its terminal frame, slot and blocks reclaimed), ahead
  of its submit (tombstoned), too late (the next request with that rid
  is untouched), and at a stale epoch (fenced).
* OP_JOURNAL: "bad op 5" from both packages' frontends.
* ``kill()`` mid-stream: ``ServeConnectionError`` in both clients.
* A tier mixing a JAX and a port replica is refused at registration,
  typed ``WeightsMismatchError`` (the weights fingerprints differ by
  design: port-only tiers).
* Frame bytes: JAX's ``_frame_buffers`` and ``_encode_buffers`` joined equal
  ``_encode`` in both packages.
* Every submit param a JAX router sends is accepted; transports other
  than TCP are refused.

Weights come from the JAX model's init with a fixed seed, carried across
with ``from_jax_params``; prompts from numpy with a fixed seed.
"""

import contextlib
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.engine.wire import _encode as jax_encode
from byteps_tpu.common.config import reset_config as jax_reset_config
from byteps_tpu.inference import generate
from byteps_tpu.models.transformer import Transformer as JaxTransformer
from byteps_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from byteps_tpu.observability.metrics import MetricsRegistry
from byteps_tpu.resilience.policy import RetryPolicy
from byteps_tpu.serving import EpochFencedError as JaxEpochFencedError
from byteps_tpu.serving import RemoteServeClient as JaxRemoteServeClient
from byteps_tpu.serving import ServeConnectionError as JaxConnectionError
from byteps_tpu.serving import ServeMetrics as JaxServeMetrics
from byteps_tpu.serving import ServeReplyError as JaxReplyError
from byteps_tpu.serving import ServeRouter, WeightsMismatchError
from byteps_tpu.serving import ServingEngine as JaxServingEngine
from byteps_tpu.serving import router as rt
from byteps_tpu.serving.disagg.ship import \
    _frame_buffers as jax_frame_buffers
from byteps_tpu.serving.frontend import serve as jax_serve
from byteps_tpu_torch.common.config import reset_config
from byteps_tpu_torch.engine.wire import _encode, _encode_buffers
from byteps_tpu_torch.models.convert import from_jax_params
from byteps_tpu_torch.models.transformer import Transformer, TransformerConfig
from byteps_tpu_torch.serving import (OP_JOURNAL, OP_KV_BLOCKS,
                                      EpochFencedError, RemoteServeClient,
                                      ServeConnectionError, ServeFrontend,
                                      ServeMetrics, ServeReplyError,
                                      ServingEngine, serve)
from byteps_tpu_torch.serving import metrics as sm

M = 8  # new tokens per request
KW = dict(vocab_size=61, num_layers=2, num_heads=2, d_model=32, d_ff=64,
          max_seq_len=64)
LENGTHS = (9, 13, 17, 21)   # 2-3 blocks of 8 each


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


@pytest.fixture
def jax_tcp(monkeypatch):
    """JAX frontends on TCP alone: they leave no Unix-socket / shared-
    memory rendezvous files (the port serves TCP only), so no other test
    finds one under its own port."""
    monkeypatch.setenv("BYTEPS_TRANSPORT", "tcp")
    jax_reset_config()
    yield
    jax_reset_config()


def _prompts(lengths=LENGTHS, seed=20):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 61, size=(n,)).astype(np.int32) for n in lengths]


@pytest.fixture(scope="module")
def greedy_refs(tiny):
    jmodel, variables, _, _ = tiny
    return [list(np.asarray(generate(jmodel, variables, p[None], M,
                                     temperature=0.0)["tokens"])[0])
            for p in _prompts()]


def _port_engine(tiny, **kw):
    _, _, pcfg, state = tiny
    model = Transformer(pcfg)
    model.load_state_dict(state)
    kw.setdefault("paged", True)
    if kw["paged"]:
        kw.setdefault("block", 8)
        kw.setdefault("chunk", 16)
    return ServingEngine(model, n_slots=4, max_seq=64, device="cpu",
                         metrics=ServeMetrics(), **kw)


def _jax_engine(tiny, **kw):
    jmodel, variables, _, _ = tiny
    return JaxServingEngine(jmodel, variables, n_slots=4, max_seq=64,
                            temperature=0.0, metrics=JaxServeMetrics(), **kw)


@contextlib.contextmanager
def _frontends(*engines, serve_fn=serve):
    """``(servers, addrs)`` of in-thread frontends over ``engines``."""
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


def _router(addrs, **kw):
    # ping_timeout bounds the weights handshake's STATS round trip; an
    # unanswered one leaves the replica unverified without a raise, so it
    # is generous here for a loaded test host
    router = ServeRouter(
        addrs, affinity=True, credits=4, deadline=30.0, stream_timeout=5.0,
        ping_timeout=30.0, registry=MetricsRegistry(),
        retry=RetryPolicy(max_attempts=5, backoff_base=0.02, jitter=0.0,
                          backoff_cap=0.1, deadline=0.0), **kw)
    return router


def _used(engine):
    return engine.pool.alloc.used_count


def _slow_ticks(engine):
    """20 ms a tick: a stream of tens of tokens outlasts the cancel or
    kill a test sends mid-stream, however loaded the host."""
    step = engine.step

    def slow_step():
        time.sleep(0.02)
        return step()

    engine.step = slow_step
    return engine


# ------------------------------------------------- the JAX router tier


def test_jax_router_over_port_replicas_greedy_equals_generate(tiny,
                                                              greedy_refs):
    """Prefill on replica 0, ship, adopt on replica 1: tokens ==
    ``generate()``, no fallback, no redispatch, >= 2 blocks a prompt,
    the prefill replica alone shipping, no block leaked."""
    prompts = _prompts()
    engines = [_port_engine(tiny), _port_engine(tiny)]
    base = [_used(e) for e in engines]
    with _frontends(*engines) as (_, addrs):
        router = _router(addrs, roles=["prefill", "decode"])
        try:
            for rep in router._replicas:
                router._verify_replica_weights(rep, raising=True)
            for i, p in enumerate(prompts):
                assert list(router.stream(p, M, seed=i)) == greedy_refs[i]
            st = router.stats()
        finally:
            router.close()
    assert st["disagg"] is True
    assert st[rt.DISAGG_PREFILLS] == len(prompts)
    assert st[rt.DISAGG_FALLBACKS] == 0 and st[rt.REDISPATCHES] == 0
    want = sum(-(-len(p) // 8) for p in prompts)
    assert st[rt.DISAGG_SHIPPED_BLOCKS] == want >= 2 * len(prompts)
    assert engines[0].metrics.get(sm.KV_BLOCKS_SHIPPED) == want
    assert (engines[0].metrics.get(sm.KV_BLOCKS_SHIPPED_BYTES)
            == want * engines[0].pool.block_bytes)
    assert engines[1].metrics.get(sm.KV_BLOCKS_SHIPPED) == 0
    assert engines[0].metrics.summary()["ship_n"] == len(prompts)
    # the decode replica adopted every prompt: it never prefilled
    assert engines[1].step_counts()["prefill_chunks"] == 0
    assert engines[0].step_counts()["decode_ticks"] == 0
    assert [_used(e) for e in engines] == base


def test_jax_router_over_port_replicas_seeded_equals_colocated(tiny):
    """Seeded sampling (temperature 0.8) through the disaggregated pair
    equals the port's own colocated engine at the same seeds: the noise
    of token k is a function of (seed, k) on either side of the ship."""
    prompts = _prompts()[:2]
    kw = dict(temperature=0.8)
    solo = _port_engine(tiny, **kw)
    reqs = [solo.submit(p, M, seed=100 + i) for i, p in enumerate(prompts)]
    solo.drain(timeout=60)
    want = [r.result().tolist() for r in reqs]
    engines = [_port_engine(tiny, **kw), _port_engine(tiny, **kw)]
    with _frontends(*engines) as (_, addrs):
        router = _router(addrs, roles=["prefill", "decode"])
        try:
            for rep in router._replicas:
                router._verify_replica_weights(rep, raising=True)
            got = [list(router.stream(p, M, seed=100 + i))
                   for i, p in enumerate(prompts)]
            st = router.stats()
        finally:
            router.close()
    assert got == want
    assert st[rt.DISAGG_FALLBACKS] == 0 and st[rt.REDISPATCHES] == 0


@pytest.mark.usefixtures("jax_tcp")
def test_mixed_jax_and_port_tier_is_refused_typed(tiny):
    """The weights fingerprint hashes each package's own state names and
    dtypes, so a tier mixing a JAX and a port replica is refused at
    registration as ``WeightsMismatchError`` — tiers are port-only."""
    with _frontends(_jax_engine(tiny), serve_fn=jax_serve) as (_, ja), \
            _frontends(_port_engine(tiny)) as (_, pa):
        router = _router(ja + pa)
        try:
            router._verify_replica_weights(router._replicas[0],
                                           raising=True)
            with pytest.raises(WeightsMismatchError):
                router._verify_replica_weights(router._replicas[1],
                                               raising=True)
            assert router._replicas[1].refused
        finally:
            router.close()


# ------------------------------------------------------- router epochs


@pytest.mark.parametrize("package", ["jax", "port"])
def test_epoch_fence_matches_jax(tiny, package):
    """The same epochs fenced the same way, with JAX's message, on both
    engines; a stale ``submit(epoch=)`` is refused before admission."""
    if package == "jax":
        eng, err = _jax_engine(tiny), JaxEpochFencedError
    else:
        eng, err = _port_engine(tiny, paged=False), EpochFencedError
    eng.fence_epoch(3)
    eng.fence_epoch(3)
    eng.fence_epoch(5)
    with pytest.raises(err) as ei:
        eng.fence_epoch(4)
    assert ei.value.epoch == 4 and ei.value.high_water == 5
    assert str(ei.value) == (
        "dispatch fenced: epoch 4 < this engine's epoch high-water 5 — a "
        "newer router epoch has taken over this tier; the sending router "
        "must demote")
    assert eng.epoch_high_water == 5
    with pytest.raises(err):
        eng.submit([1, 2, 3], 4, epoch=4)
    req = eng.submit([1, 2, 3], 4, epoch=6)
    assert eng.epoch_high_water == 6
    eng.cancel(req)


def test_every_submit_param_a_router_sends_is_accepted(tiny, greedy_refs):
    """epoch, rid, tenant, slo and timeout ride a JAX client's SUBMIT and
    STREAM to a port frontend: served (tenant and slo ignored, as a JAX
    replica ignores them); a stale epoch comes back typed."""
    p = _prompts()[0]
    with _frontends(_port_engine(tiny)) as (_, (addr,)):
        c = JaxRemoteServeClient(addr, timeout=30, transport="tcp")
        try:
            got = c.generate(p, M, epoch=2, rid="a", tenant="t",
                             slo="guaranteed", extra={"timeout": 30.0})
            assert list(got) == greedy_refs[0]
            assert list(c.stream(p, M, epoch=2, rid="b", tenant="t",
                                 slo="best-effort")) == greedy_refs[0]
            with pytest.raises(JaxReplyError) as ei:
                c.generate(p, M, epoch=1)
            assert ei.value.name == "EpochFencedError"
        finally:
            c.close()


# ------------------------------------------------------------ OP_CANCEL


def _wait_used(engine, want, timeout=5.0):
    deadline = time.monotonic() + timeout
    while _used(engine) != want and time.monotonic() < deadline:
        time.sleep(0.01)
    return _used(engine)


def test_jax_client_cancels_a_port_stream(tiny):
    """A JAX client's ``cancel(rid)`` on a second connection ends a port
    stream mid-flight with its terminal frame; the slot and blocks come
    back.  A cancel ahead of its submit is tombstoned (the stream is
    retired at registration); one after its request finished is too late
    and does not touch the next request with that rid."""
    eng = _slow_ticks(_port_engine(tiny))
    base = _used(eng)
    p = _prompts()[0]
    with _frontends(eng) as (_, (addr,)):
        cli = JaxRemoteServeClient(addr, timeout=10, transport="tcp")
        canceller = JaxRemoteServeClient(addr, timeout=10, transport="tcp")
        try:
            toks = []
            for tok in cli.stream(p, 50, rid="victim"):
                toks.append(int(tok))
                if len(toks) == 2:
                    assert canceller.cancel("victim") is True
            assert 2 <= len(toks) < 50      # ended by its "end" frame
            assert _wait_used(eng, base) == base
            assert eng.pool.active_count == 0
            # ahead of the submit: tombstoned, retired on arrival
            assert canceller.cancel("early") is False
            assert len(list(cli.stream(p, 50, rid="early"))) < 50
            # too late: the rid finished, the next one runs whole
            assert len(cli.generate(p, 4, rid="done")) == 4
            assert canceller.cancel("done") is False
            assert len(list(cli.stream(p, 12, rid="done"))) == 12
            assert _wait_used(eng, base) == base
        finally:
            cli.close()
            canceller.close()


def test_cancel_at_a_stale_epoch_is_fenced(tiny):
    """A cancel stamped with an epoch below the replica's high-water is
    refused typed and cancels nothing; at the current epoch it lands."""
    eng = _slow_ticks(_port_engine(tiny))
    p = _prompts()[0]
    with _frontends(eng) as (_, (addr,)):
        cli = RemoteServeClient(addr, timeout=10)
        try:
            it = cli.stream(p, 50, rid="r", epoch=5)
            first = [next(it), next(it)]
            with pytest.raises(ServeReplyError) as ei:
                cli.cancel("r", epoch=4)
            assert ei.value.name == "EpochFencedError"
            assert cli.cancel("r", epoch=5) is True
            assert len(first + list(it)) < 50
        finally:
            cli.close()


# ----------------------------------------------- journal, kill, frames


@pytest.mark.usefixtures("jax_tcp")
def test_journal_op_gets_bad_op_from_both_frontends(tiny):
    """Only routers take journal pushes: both packages' serve frontends
    answer OP_JOURNAL with "bad op 5", to either client."""
    msgs = []
    with _frontends(_jax_engine(tiny), serve_fn=jax_serve) as (_, ja), \
            _frontends(_port_engine(tiny)) as (_, pa):
        for addr in ja + pa:
            for client in (JaxRemoteServeClient(addr, transport="tcp"),
                           RemoteServeClient(addr)):
                with pytest.raises(RuntimeError) as ei:
                    client.journal([{"e": 1}])
                msgs.append((ei.value.name, str(ei.value)))
                assert client.ping()   # the connection survives
                client.close()
    assert OP_JOURNAL == 5
    assert msgs == [("bad op 5", "serve error: 'bad op 5'")] * 4


def test_kill_mid_stream_raises_typed_in_both_clients(tiny):
    """``ServeFrontend.kill()`` hard-resets live streams: the JAX and the
    port client each raise their ``ServeConnectionError``."""
    eng = _slow_ticks(_port_engine(tiny))
    p = _prompts()[0]
    srv, thread = serve(eng, 0, host="127.0.0.1", in_thread=True)
    addr = f"127.0.0.1:{srv.server_address[1]}"
    clients = [(JaxRemoteServeClient(addr, timeout=5, transport="tcp"),
                JaxConnectionError),
               (RemoteServeClient(addr, timeout=5), ServeConnectionError)]
    its = [c.stream(p, 50) for c, _ in clients]
    for it in its:
        assert isinstance(next(it), int)
    eng.stop()        # freeze the ticks so no stream can finish first
    srv.kill()
    thread.join(timeout=10)
    for (c, err), it in zip(clients, its):
        t0 = time.monotonic()
        with pytest.raises(err):
            list(it)
        assert time.monotonic() - t0 < 5.0
        c.close()


@pytest.mark.parametrize("meta,payload", [
    ({"key": "k", "i": 0, "n": 2, "pos": 16, "geom": "L2/B8/k=256:float32",
      "digest": "00" * 16}, b"\x01\x02" * 1024),
    ({"key": "x", "i": 3, "n": 4, "pos": 1, "geom": "", "digest": ""}, b""),
])
def test_frame_buffers_are_encode_in_both_packages(meta, payload):
    """The OP_KV_BLOCKS frame as the ship sends it (the port's
    ``_encode_buffers`` on a numpy view of the block, JAX's hand-built
    ``_frame_buffers``) joined equals ``_encode(..., raw=payload)`` in
    both packages."""
    bufs = [np.frombuffer(payload[:7], np.uint8), payload[7:]]
    plen = len(payload)
    mine = b"".join(bytes(b) for b in _encode_buffers(
        OP_KV_BLOCKS, json.dumps(meta), None,
        raw=np.frombuffer(payload, np.uint8)))
    theirs = b"".join(bytes(b) for b in jax_frame_buffers(
        OP_KV_BLOCKS, meta, bufs, plen))
    want = _encode(OP_KV_BLOCKS, json.dumps(meta), None, raw=payload)
    assert mine == want == theirs
    assert want == jax_encode(OP_KV_BLOCKS, json.dumps(meta), None,
                              raw=payload)


@pytest.mark.parametrize("arr", [np.arange(7, dtype=np.int32),
                                 np.zeros((0,), np.int32),
                                 np.ones((2, 3), np.float32), None])
def test_encode_buffers_join_is_encode(arr):
    joined = b"".join(bytes(b) for b in _encode_buffers(0, "end", arr,
                                                        b"raw"))
    assert joined == _encode(0, "end", arr, b"raw") == jax_encode(
        0, "end", arr, b"raw")


def test_payload_view_is_zero_copy_for_bf16_tensors():
    from byteps_tpu_torch.engine.wire import _payload_view

    t = torch.arange(6, dtype=torch.float32).to(torch.bfloat16)
    v = _payload_view(t)
    assert bytes(v) == t.view(torch.uint8).numpy().tobytes()
    t[0] = 5.0     # the view shares the tensor's memory
    assert bytes(v) == t.view(torch.uint8).numpy().tobytes()


# ------------------------------------------ transports, reply flags


def test_transports_other_than_tcp_are_refused(tiny, monkeypatch):
    eng = _port_engine(tiny, paged=False)
    for t in ("unix", "shm", "unix:/tmp/x.sock", "shm:/x"):
        monkeypatch.setenv("BYTEPS_TRANSPORT", t)
        reset_config()
        with pytest.raises(NotImplementedError, match="BYTEPS_TRANSPORT"):
            ServeFrontend(("127.0.0.1", 0), eng)
    monkeypatch.setenv("BYTEPS_TRANSPORT", "tcp")
    reset_config()
    with _frontends(eng) as (_, (addr,)):
        with pytest.raises(NotImplementedError):
            RemoteServeClient(addr, transport="shm")
        c = RemoteServeClient(addr, transport="auto")
        assert c.ping()
        c.close()
    monkeypatch.delenv("BYTEPS_TRANSPORT")
    reset_config()


def test_reply_error_flags_match_jax():
    for name in ("RouterStandbyError", "OverloadShedError", "ValueError"):
        a, b = ServeReplyError("m", name), JaxReplyError("m", name)
        assert (a.retryable, a.shed) == (b.retryable, b.shed)


def test_stats_carry_the_ship_histogram(tiny):
    with _frontends(_port_engine(tiny)) as (_, (addr,)):
        c = JaxRemoteServeClient(addr, transport="tcp")
        st = c.stats()
        c.close()
    assert st["ship_n"] == 0
    assert {"ship_p50_s", "ship_p99_s"} <= set(st)
    assert set(JaxServeMetrics().summary()) <= set(st)
