"""Router high availability on the port (``serving/router.py`` with
``serving/journal.py``), held against the JAX package.

* Journal interchange: a JAX active router's ``_journal_snapshot()``
  folded by a port standby's ``apply_journal`` leaves the state a JAX
  standby folds from it — replica verdicts, the affinity map, in-flight
  records, the pending scale intent, the epoch and the ack — and a port
  active's snapshot does the same in the other direction.
* Takeover: a port active journals to a port standby; the active is
  killed mid-stream; the standby takes over at epoch 2, the multi-router
  client (the port's, and JAX's against port routers) splices a stream
  equal to ``generate()``, and the replica fences epoch 1.
* A standby refuses typed and retryable; a multi-router client rotates
  to the active; a non-retryable refusal propagates without rotating;
  a cancel through a standby is refused and a multi-router cancel
  reaches the active.
"""

import contextlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.inference import generate
from byteps_tpu.models.transformer import Transformer as JaxTransformer
from byteps_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from byteps_tpu.observability.metrics import \
    MetricsRegistry as JaxRegistry
from byteps_tpu.resilience.policy import RetryPolicy as JaxRetry
from byteps_tpu.serving import RemoteServeClient as JaxRemoteServeClient
from byteps_tpu.serving import ServeRouter as JaxRouter
from byteps_tpu_torch.engine.transport import free_port
from byteps_tpu_torch.models.convert import from_jax_params
from byteps_tpu_torch.models.transformer import Transformer, TransformerConfig
from byteps_tpu_torch.observability.metrics import MetricsRegistry
from byteps_tpu_torch.resilience import FaultInjectingProxy
from byteps_tpu_torch.resilience.policy import RetryPolicy
from byteps_tpu_torch.serving import (OP_STREAM, RemoteServeClient,
                                      RouterFrontend, ServeMetrics,
                                      ServeReplyError, ServeRouter,
                                      ServingEngine, serve)
from byteps_tpu_torch.serving import router as rt

M = 8
KW = dict(vocab_size=61, num_layers=2, num_heads=2, d_model=32, d_ff=64,
          max_seq_len=64)


def _prompts(seed=50):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 61, size=(n,)).astype(np.int32)
            for n in (9, 13, 17)]


@pytest.fixture(scope="module")
def tiny():
    jmodel = JaxTransformer(JaxTransformerConfig(dtype=jnp.float32, **KW))
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


def _engine(tiny):
    _, _, pcfg, state = tiny
    model = Transformer(pcfg)
    model.load_state_dict(state)
    return ServingEngine(model, n_slots=4, max_seq=64, device="cpu",
                         metrics=ServeMetrics(), paged=True, block=8,
                         chunk=16)


@contextlib.contextmanager
def _frontends(*engines):
    srvs = [serve(e, 0, host="127.0.0.1", in_thread=True) for e in engines]
    try:
        yield [f"127.0.0.1:{s.server_address[1]}" for s, _ in srvs]
    finally:
        for s, t in srvs:
            s.shutdown()
            s.server_close()
            t.join(timeout=10)


@pytest.fixture(scope="module")
def replicas(tiny):
    engines = [_engine(tiny) for _ in range(2)]
    with _frontends(*engines) as addrs:
        yield engines, addrs


def _retry(cls=RetryPolicy):
    return cls(max_attempts=5, backoff_base=0.02, jitter=0.0,
               backoff_cap=0.1, deadline=0.0)


def _ha_router(cls, reg, retry, rep_addrs, peers, self_addr, **kw):
    kw.setdefault("heartbeat_interval", 0.1)
    kw.setdefault("epoch_timeout", 0.1)
    kw.setdefault("ping_timeout", 0.5)
    return cls(rep_addrs, affinity=True, affinity_block=4, credits=4,
               deadline=20.0, stream_timeout=5.0, miss_threshold=2,
               retry=retry, registry=reg, peers=peers, self_addr=self_addr,
               **kw)


def _port(rep_addrs, peers, self_addr, **kw):
    return _ha_router(ServeRouter, MetricsRegistry(), _retry(), rep_addrs,
                      peers, self_addr, **kw)


def _jax(rep_addrs, peers, self_addr, **kw):
    return _ha_router(JaxRouter, JaxRegistry(), _retry(JaxRetry), rep_addrs,
                      peers, self_addr, **kw)


# --------------------------------------------------- journal interchange


def _standby_state(r):
    return {"replicas": [(x.addr, x.role, x.dead, x.suspect, x.refused,
                          x.verified, x.draining) for x in r._replicas],
            "affinity": list(r._affinity_map.items()),
            "inflight": {k: dict(v) for k, v in r._journal_inflight.items()},
            "epoch": (r.epoch, r._journal_epoch, r._active_peer, r.active),
            "scale": r._pending_scale, "fp": r._expected_fp}


def _warm_active(active, prompts):
    """Give an active router state worth journaling: verified replicas,
    affinity groups from real requests, a replica gone dead, a QUEUED and
    a placed in-flight record, an open scale intent, a grown roster."""
    for rep in active._replicas:
        active._verify_replica_weights(rep, raising=True)
    for p in prompts:
        active.generate(p, 4)
    active._on_replica_down(1)
    active._inflight["q1"] = {"rid": "q1", "seed": 3, "prio": 0, "mnt": 8,
                              "tenant": "t", "slo": "guaranteed", "r": None,
                              "n": 0, "st": 1.5, "p": [1, 2, 3]}
    active._inflight["x9"] = {"rid": "x9", "seed": 0, "prio": 1, "mnt": 4,
                              "tenant": None, "slo": "standard", "r": 0,
                              "n": 2, "st": 2.5}
    active.journal_scale("up", phase="intent")


@pytest.mark.parametrize("src", ["jax", "port"])
def test_journal_snapshots_interchange(src, replicas):
    _, addrs = replicas
    peers = ["127.0.0.1:1", "127.0.0.1:2"]
    make_active = _jax if src == "jax" else _port
    # nothing here is started, so the ping timeout bounds only the
    # weights handshake's STATS round trip: generous for a loaded host
    active = make_active(addrs, peers, peers[0], ping_timeout=30.0)
    standbys = [_port(addrs, peers, peers[1]), _jax(addrs, peers, peers[1])]
    try:
        _warm_active(active, _prompts())
        snap = active._journal_snapshot()
        assert len(snap) >= 1 + 2 + 3 + 2 + 1
        # a runtime scale-up: the address rides the entry and the
        # standby appends it to its roster
        extra = dict(snap[1], r=2, addr="127.0.0.1:3", dead=False,
                     verified=False)
        acks = [s.apply_journal(snap + [extra]) for s in standbys]
        assert acks[0] == acks[1] == {"epoch": 1}
        a, b = (_standby_state(s) for s in standbys)
        assert a == b
        assert a["epoch"] == (0, 1, 0, False)
        assert a["replicas"][1][2] and not a["replicas"][0][2]  # dead
        assert len(a["replicas"]) == 3
        assert {k: v.get("p") for k, v in a["inflight"].items()} == {
            "q1": [1, 2, 3], "x9": None}
        assert a["affinity"] == list(active._affinity_map.items())
        assert a["scale"]["op"] == "up"
        # a stale batch (a lower epoch than seen) is ignored by both
        stale = [dict(e, e=0, k="affinity", d="00" * 16, r=1)
                 for e in snap[:1]]
        assert [s.apply_journal(stale) for s in standbys] == acks
        assert _standby_state(standbys[0]) == _standby_state(standbys[1])
        # an active folding a newer epoch's entry is deposed, in both
        for s in (make_active(addrs, peers, peers[0]),):
            ack = s.apply_journal([dict(snap[0], e=5)])
            assert ack == {"epoch": 5} and not s.active
            s.close()
    finally:
        for r in [active] + standbys:
            r.close()


# ---------------------------------------------------------------- takeover


@pytest.mark.parametrize("client", ["port", "jax"])
def test_takeover_splices_the_stream_and_fences(client, tiny, greedy_refs):
    """Active A journals to standby B; the multi-router client reaches A
    through a proxy that cuts its leg after 2 token frames, and A is
    killed at that moment; B takes over at epoch 2 and the client's
    re-issue with the received prefix gives ``generate()``'s tokens."""
    engine = _engine(tiny)
    prompts = _prompts()
    with _frontends(engine) as (rep_addr,):
        pa, pb = free_port(), free_port()
        peers = [f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"]
        ra, rb = _port([rep_addr], peers, peers[0]), _port(
            [rep_addr], peers, peers[1])
        assert ra.active and ra.epoch == 1 and not rb.active
        fa = RouterFrontend(("127.0.0.1", pa), ra)
        fb = RouterFrontend(("127.0.0.1", pb), rb)
        for f in (fa, fb):
            threading.Thread(target=f.serve_forever, daemon=True).start()
        proxy = FaultInjectingProxy(peers[0], serve_stream_op=OP_STREAM)
        addrs = f"{proxy.addr},{peers[1]}"
        cli = (RemoteServeClient(addrs, timeout=15.0) if client == "port"
               else JaxRemoteServeClient(addrs, timeout=15.0,
                                         transport="tcp"))
        try:
            assert list(cli.stream(prompts[0], M)) == greedy_refs[0]
            assert ra._journal.flush(5.0)
            # B's frontend came up after A's first journal batch: B warms
            # from the reconnect snapshot, within the sender's backoff
            deadline = time.monotonic() + 10.0
            while (len(rb._affinity_map) < 1
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert len(rb._affinity_map) == 1 and rb._journal_epoch == 1
            assert rb._replicas[0].verified
            proxy.script(("cut_stream", 2))
            toks = []
            for tok in cli.stream(prompts[1], M):
                toks.append(int(tok))
                if len(toks) == 2:
                    fa.kill()
            assert toks == greedy_refs[1]
            deadline = time.monotonic() + 10.0
            while not rb.active and time.monotonic() < deadline:
                time.sleep(0.02)
            assert rb.active and rb.epoch == 2
            assert rb.stats()[rt.TAKEOVERS] == 1
            probe = RemoteServeClient(rep_addr, timeout=5.0)
            try:
                with pytest.raises(ServeReplyError,
                                   match="EpochFencedError"):
                    probe.generate(prompts[0], 2, epoch=1)
                probe.generate(prompts[0], 2, epoch=rb.epoch)
            finally:
                probe.close()
            assert engine.epoch_high_water == 2
            assert list(cli.stream(prompts[2], M)) == greedy_refs[2]
        finally:
            cli.close()
            proxy.close()
            fb.kill()


def test_standby_refusal_typed_and_retryable(greedy_refs, replicas):
    _, addrs = replicas
    pa, pb = free_port(), free_port()
    peers = [f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"]
    rb = _port(addrs, peers, peers[1], heartbeat_interval=0.2,
               epoch_timeout=60.0, ping_timeout=0.3)
    fb = RouterFrontend(("127.0.0.1", pb), rb)
    threading.Thread(target=fb.serve_forever, daemon=True).start()
    ract = ServeRouter(addrs, credits=4, deadline=10.0, stream_timeout=5.0,
                       ping_timeout=10.0, retry=_retry(),
                       registry=MetricsRegistry())
    fact = RouterFrontend(("127.0.0.1", 0), ract)
    threading.Thread(target=fact.serve_forever, daemon=True).start()
    act = f"127.0.0.1:{fact.server_address[1]}"
    p = _prompts()[0]
    try:
        c1 = RemoteServeClient(peers[1], timeout=5.0)
        with pytest.raises(ServeReplyError) as ei:
            c1.generate(p, M)
        assert ei.value.name == "RouterStandbyError" and ei.value.retryable
        assert rb.stats()[rt.STANDBY_REFUSED] >= 1
        with pytest.raises(ServeReplyError) as ei:
            c1.cancel("no-such-rid")
        assert ei.value.name == "RouterStandbyError"
        c1.close()
        c2 = RemoteServeClient(f"{peers[1]},{act}", timeout=10.0)
        assert list(c2.generate(p, M)) == greedy_refs[0]
        assert c2._cur == 1
        with pytest.raises(ServeReplyError) as ei:
            c2.generate(p, 10_000)      # infeasible: beyond max_seq
        assert not ei.value.retryable and c2._cur == 1
        assert c2.cancel("no-such-rid") is False
        c2.close()
        # a dead first address: the client connects to the next one
        c3 = RemoteServeClient(f"127.0.0.1:1,{act}", timeout=10.0)
        assert c3.addr == act and list(c3.stream(p, M)) == greedy_refs[0]
        c3.close()
    finally:
        fb.kill()
        fact.kill()
