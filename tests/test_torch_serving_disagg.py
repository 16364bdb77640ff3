"""The port's disaggregated prefill/decode KV ship
(``byteps_tpu_torch/serving/disagg``), held against the JAX package.

* ``pool_geometry`` strings equal across the packages (fp32 and int8
  pools), and the same for a grouped gather-fallback pool and a tp=2
  pool as for the flat tp=1 pool; ``extract_kv_payloads`` rows equal
  JAX's ``extract_kv_blocks`` for the same prompt, at tp 1 and 2.
* Ships across the packages, leg by leg with clients: a JAX prefill
  replica to a port decode replica, and a port prefill replica to a JAX
  decode replica — tokens equal JAX ``generate()``, ``shipped: True``.
* Other pools: int8 -> int8, tp=2 -> tp=1 and a grouped gather-fallback
  pool -> a flat kernel pool, each equal to colocated serving.
* The stager and adoption, mirroring ``tests/test_serving_disagg.py``:
  geometry and truncation refusals, the digest resend, out-of-order
  abort, a partial staging never adopted, the TTL sweep, ``adopt_blocks``
  as an ownership transfer, the int8 refusal both ways.
* Downgrades: a dense replica reports ``shipped: False`` beside valid
  tokens and refuses OP_KV_BLOCKS typed; an ``on_block_sent`` hook that
  raises mid-ship gives ``KVShipAbortedError`` and the partial staging
  is released; a wrong block count re-prefills with the tokens
  unchanged; staged blocks a request never adopts (EOS-finished resume,
  refusal, cancel) are released; the parked KV is capped.
"""

import contextlib
import json

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
from byteps_tpu.serving import RemoteServeClient as JaxRemoteServeClient
from byteps_tpu.serving import ServeMetrics as JaxServeMetrics
from byteps_tpu.serving import ServingEngine as JaxServingEngine
from byteps_tpu.serving.disagg.ship import pool_geometry as jax_geometry
from byteps_tpu.serving.frontend import serve as jax_serve
from byteps_tpu_torch.common.config import reset_config
from byteps_tpu_torch.models.convert import from_jax_params
from byteps_tpu_torch.models.transformer import Transformer, TransformerConfig
from byteps_tpu_torch.serving import (KVShipDigestError, KVShipGeometryError,
                                      KVShipSequenceError, KVStager,
                                      QueueFullError, RemoteServeClient,
                                      ServeMetrics, ServingEngine,
                                      pool_geometry, serve)
from byteps_tpu_torch.serving import metrics as sm
from byteps_tpu_torch.serving.disagg import ship as ship_mod
from byteps_tpu_torch.serving.disagg.ship import _digest

M = 8
KW = dict(vocab_size=61, num_layers=2, num_heads=2, d_model=32, d_ff=64,
          max_seq_len=64)


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


def _prompts(lengths=(9, 16, 21), seed=30):
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
                            temperature=0.0, paged=True, block=8, chunk=16,
                            metrics=JaxServeMetrics(), **kw)


@contextlib.contextmanager
def _frontends(*pairs):
    """In-thread frontends over ``(engine, serve_fn)`` pairs; yields
    their ``(servers, addrs)``."""
    srvs = [fn(e, 0, host="127.0.0.1", in_thread=True) for e, fn in pairs]
    try:
        yield ([s for s, _ in srvs],
               [f"127.0.0.1:{s.server_address[1]}" for s, _ in srvs])
    finally:
        for s, t in srvs:
            s.shutdown()
            s.server_close()
            t.join(timeout=10)


def _legs(client_cls, pre_addr, dec_addr, prompts, key="k"):
    """Each prompt's two legs: prefill + ship, then the decode leg that
    claims the staging.  Returns the token lists and the ship reports."""
    out, infos = [], []
    kw = {"transport": "tcp"} if client_cls is JaxRemoteServeClient else {}
    for i, p in enumerate(prompts):
        c = client_cls(pre_addr, timeout=30, **kw)
        first, info = c.prefill_ship(p, ship_to=dec_addr, kv_ship=f"{key}{i}")
        c.close()
        d = client_cls(dec_addr, timeout=30, **kw)
        rest = list(d.stream(p, M, resume=[int(first[0])],
                             extra={"kv_ship": f"{key}{i}"}))
        d.close()
        out.append([int(first[0])] + [int(t) for t in rest])
        infos.append(info)
    return out, infos


def _used(engine):
    return engine.pool.alloc.used_count


def _colocated(engine, prompts):
    reqs = [engine.submit(p, M) for p in prompts]
    engine.drain(timeout=60)
    return [r.result().tolist() for r in reqs]


# ------------------------------------------------ geometry and extract


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_pool_geometry_equal_across_packages_and_layouts(tiny, kv_dtype):
    """The geometry names the dtype as numpy does and never the layout or
    tp: the JAX pool's string is the port's flat, grouped (gather
    fallback) and tp=2 pools' string."""
    want = jax_geometry(_jax_engine(tiny, kv_dtype=kv_dtype))
    assert ("int8" in want and "k_scale" in want) == bool(kv_dtype)
    for kw in ({}, {"paged_kernel": "off"}, {"tp": 2}):
        e = _port_engine(tiny, kv_dtype=kv_dtype, **kw)
        assert pool_geometry(e) == want, kw
        st = KVStager(e)
        assert st._block_bytes == e.pool.block_bytes
    # JAX's own tp=2 pool counts a whole shard, n_blocks included, so a
    # JAX tp replica's ships are refused by any pool (ROADMAP queue C);
    # the port's tp=2 string above is the unsharded block's
    assert jax_geometry(_jax_engine(tiny, kv_dtype=kv_dtype, tp=2)) != want


def test_bf16_geometry_names_the_dtype_as_jax_does(tiny):
    e = _port_engine(tiny)
    e.pool.caches = [{n: t.to(torch.bfloat16) for n, t in c.items()}
                     for c in e.pool.caches]
    assert pool_geometry(e) == "L2/B8/k=256:bfloat16/v=256:bfloat16"


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_extract_bytes_equal_jax_at_tp_1_and_2(tiny, kv_dtype):
    """The same prompt parked by JAX and by the port at tp 1 and 2: the
    shipped rows agree (fp32 values and int8 scales within 1e-5 — the
    two packages' prefill sums differ in order — and the s8 values within
    one step), and a write/extract round trip is byte-exact at either
    tp."""
    p = _prompts()[2]
    je = _jax_engine(tiny, kv_dtype=kv_dtype)
    r = je.submit(p, 1, keep_kv=True)
    je.drain(timeout=60)
    kv = je.take_parked_kv(r.id)
    want = je.extract_kv_blocks(kv["ids"])
    for tp in (1, 2):
        e = _port_engine(tiny, kv_dtype=kv_dtype, tp=tp)
        r = e.submit(p, 1, keep_kv=True)
        e.drain(timeout=60)
        parked = e.take_parked_kv(r.id)
        assert parked["pos"] == len(p) and len(parked["ids"]) == 3
        rows = e.extract_kv_payloads(parked["ids"])
        got = e._split_rows(rows)
        for lj, lp in zip(want, got):
            assert sorted(lj) == sorted(lp)
            for n in lj:
                a = np.asarray(lj[n]).reshape(3, -1).astype(np.float64)
                b = lp[n].numpy().reshape(3, -1).astype(np.float64)
                tol = 1 if lp[n].dtype == torch.int8 else 1e-5
                assert np.abs(a - b).max() <= tol, (tp, n)
        ids = e.stage_alloc(3)
        e.write_kv_payloads(ids, rows)
        assert torch.equal(e.extract_kv_payloads(ids), rows)
        e.release_kv_ids(ids)
        e.release_kv_ids(parked["ids"])
        assert _used(e) == 1


# ---------------------------------------------- ships across packages


@pytest.mark.usefixtures("jax_tcp")
def test_jax_prefill_ships_to_port_decode(tiny, greedy_refs):
    prompts = _prompts()
    pe = _port_engine(tiny)
    base = _used(pe)
    with _frontends((_jax_engine(tiny), jax_serve), (pe, serve)) \
            as (_, (ja, pa)):
        got, infos = _legs(JaxRemoteServeClient, ja, pa, prompts)
    assert got == greedy_refs
    assert all(i["shipped"] for i in infos)
    assert pe.step_counts()["prefill_chunks"] == 0   # every leg adopted
    assert _used(pe) == base


@pytest.mark.usefixtures("jax_tcp")
def test_port_prefill_ships_to_jax_decode(tiny, greedy_refs):
    prompts = _prompts()
    pe, je = _port_engine(tiny), _jax_engine(tiny)
    with _frontends((pe, serve), (je, jax_serve)) as (_, (pa, ja)):
        got, infos = _legs(RemoteServeClient, pa, ja, prompts)
    assert got == greedy_refs
    assert [i["shipped"] for i in infos] == [True] * 3
    assert [i["blocks"] for i in infos] == [2, 2, 3]
    assert pe.metrics.get(sm.KV_BLOCKS_SHIPPED) == 7
    assert je.metrics.get(sm.PREFILL_TOKENS) == 0   # JAX adopted them all
    assert _used(pe) == 1


@pytest.mark.parametrize("prefill_kw,decode_kw", [
    (dict(kv_dtype="int8"), dict(kv_dtype="int8")),
    (dict(tp=2), {}),
    (dict(paged_kernel="off"), {}),
], ids=["int8", "tp2_to_tp1", "grouped_to_flat"])
def test_other_pools_ship_equal_colocated(tiny, prefill_kw, decode_kw):
    prompts = _prompts()
    want = _colocated(_port_engine(tiny, **decode_kw), prompts)
    pre, dec = _port_engine(tiny, **prefill_kw), _port_engine(tiny,
                                                              **decode_kw)
    with _frontends((pre, serve), (dec, serve)) as (_, (pa, da)):
        got, infos = _legs(RemoteServeClient, pa, da, prompts)
    assert got == want
    assert all(i["shipped"] for i in infos)
    assert (pre.metrics.get(sm.KV_BLOCKS_SHIPPED_BYTES)
            == 7 * dec.pool.block_bytes)
    assert dec.step_counts()["prefill_chunks"] == 0
    assert _used(pre) == _used(dec) == 1


# ----------------------------------------------- stager and adoption


@pytest.fixture()
def stager(tiny):
    e = _port_engine(tiny)
    st = KVStager(e)
    yield e, st
    st.ttl = 0.0
    st.sweep()


def _block_payload(st, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, st._block_bytes, dtype=np.uint8).tobytes()
    return raw, _digest([raw])


def _meta(key, i, n, geom, digest, pos=16):
    return json.dumps({"key": key, "i": i, "n": n, "pos": pos,
                       "geom": geom, "digest": digest})


def test_stager_refuses_geometry_mismatch_and_truncation(stager):
    e, st = stager
    raw, dig = _block_payload(st)
    with pytest.raises(KVShipGeometryError):
        st._accept(_meta("s1", 0, 2, "L2/B16/other", dig), raw)
    with pytest.raises(KVShipGeometryError):
        st._accept(_meta("s1", 0, 2, pool_geometry(e), dig), raw[:-1])
    assert st.stats()["staged"] == 0 and _used(e) == 1


def test_stager_digest_refusal_is_resendable(stager):
    e, st = stager
    geom = pool_geometry(e)
    raw0, dig0 = _block_payload(st, 0)
    raw1, dig1 = _block_payload(st, 1)
    assert st._accept(_meta("s2", 0, 2, geom, dig0), raw0) == {
        "i": 0, "complete": False}
    with pytest.raises(KVShipDigestError):
        st._accept(_meta("s2", 1, 2, geom, "00" * 16), raw1)
    assert st._accept(_meta("s2", 1, 2, geom, dig1), raw1) == {
        "i": 1, "complete": True}
    took = st.take("s2")
    assert took is not None and len(took["ids"]) == 2 and took["pos"] == 16
    # the written bytes are the payload's
    assert bytes(e.extract_kv_payloads(took["ids"])[1].numpy()) == raw1
    e.release_kv_ids(took["ids"])
    assert st.take("s2") is None


def test_stager_out_of_order_aborts_and_partial_never_adopted(stager):
    e, st = stager
    geom = pool_geometry(e)
    raw, dig = _block_payload(st)
    with pytest.raises(KVShipSequenceError):
        st._accept(_meta("s3", 1, 3, geom, dig), raw)
    used0 = _used(e)
    st._accept(_meta("s4", 0, 3, geom, dig), raw)
    assert _used(e) == used0 + 3          # the whole staging, up front
    with pytest.raises(KVShipSequenceError):
        st._accept(_meta("s4", 2, 3, geom, dig), raw)
    assert st.stats()["staged"] == 0 and _used(e) == used0
    st._accept(_meta("s5", 0, 3, geom, dig), raw)
    assert st.take("s5") is None          # partial: released, not adopted
    assert _used(e) == used0


def test_stager_ttl_sweep_releases_stranded_stagings(stager):
    e, st = stager
    raw, dig = _block_payload(st)
    st._accept(_meta("s6", 0, 2, pool_geometry(e), dig), raw)
    assert st.sweep() == 0 and st.stats()["staged"] == 1
    st.ttl = 0.0
    assert st.sweep() == 1 and st.stats()["staged"] == 0
    assert _used(e) == 1


def test_adopt_blocks_is_ownership_transfer_with_typed_refusals(tiny):
    e = _port_engine(tiny)
    pool = e.pool
    used0 = _used(e)
    ids = e.stage_alloc(2)
    pool.adopt_blocks(0, ids)
    extra = e.stage_alloc(1)
    with pytest.raises(ValueError):
        pool.adopt_blocks(0, extra)
    with pytest.raises(ValueError):
        pool.adopt_blocks(1, list(range(pool.tables[1].max_blocks + 1)))
    assert not pool.tables[1].blocks
    e.release_kv_ids(extra)
    with pool._lock:
        pool.reset_locked(0)
    assert _used(e) == used0


def test_int8_geometry_refused_both_ways_before_any_alloc(tiny):
    e8, e32 = _port_engine(tiny, kv_dtype="int8"), _port_engine(tiny)
    g8, g32 = pool_geometry(e8), pool_geometry(e32)
    st8, st32 = KVStager(e8), KVStager(e32)
    assert st8._block_bytes < 0.35 * st32._block_bytes
    raw = np.zeros(st8._block_bytes, np.uint8).tobytes()
    with pytest.raises(KVShipGeometryError):
        st32._accept(_meta("x8", 0, 2, g8, _digest([raw])), raw)
    raw32 = np.zeros(st32._block_bytes, np.uint8).tobytes()
    with pytest.raises(KVShipGeometryError):
        st8._accept(_meta("x32", 0, 2, g32, _digest([raw32])), raw32)
    assert st8.stats()["staged"] == st32.stats()["staged"] == 0
    assert _used(e8) == _used(e32) == 1


# ------------------------------------------------------------ downgrades


def test_dense_replica_downgrades(tiny, greedy_refs):
    """A dense prefill replica parks nothing: ``shipped: False`` beside a
    valid first token.  A dense decode replica refuses OP_KV_BLOCKS
    typed, and the paged sender reports it."""
    p = _prompts()[0]
    dense, paged = _port_engine(tiny, paged=False), _port_engine(tiny)
    with _frontends((dense, serve), (paged, serve)) as (_, (da, pa)):
        c = RemoteServeClient(da, timeout=30)
        first, info = c.prefill_ship(p, ship_to=pa, kv_ship="d")
        c.close()
        assert list(first) == greedy_refs[0][:1]
        assert info["shipped"] is False and "no parked KV" in info["error"]
        c = RemoteServeClient(pa, timeout=30)
        first, info = c.prefill_ship(p, ship_to=da, kv_ship="d2")
        c.close()
    assert list(first) == greedy_refs[0][:1]
    assert info["shipped"] is False
    assert info["error"].startswith("KVShipGeometryError")
    assert _used(paged) == 1


def test_hook_raising_mid_ship_aborts_and_releases(tiny, greedy_refs,
                                                   monkeypatch):
    """``on_block_sent`` raising after the first block: the report says
    ``KVShipAbortedError``, the decode side's claim finds the partial
    staging and releases it, and the decode leg re-prefills to the same
    tokens."""
    def boom(key, i, n):
        raise ConnectionResetError("cut after block 0")

    monkeypatch.setattr(ship_mod, "on_block_sent", boom)
    p = _prompts()[2]
    pre, dec = _port_engine(tiny), _port_engine(tiny)
    with _frontends((pre, serve), (dec, serve)) as (srvs, (pa, da)):
        got, infos = _legs(RemoteServeClient, pa, da, [p])
        assert srvs[1].kv_stager().stats()["staged"] == 0
    assert infos[0]["shipped"] is False
    assert infos[0]["error"].startswith("KVShipAbortedError")
    assert got == [greedy_refs[2]]
    assert dec.step_counts()["prefill_chunks"] >= 1   # re-prefilled
    assert _used(pre) == _used(dec) == 1


def test_wrong_block_count_reprefills_with_the_same_tokens(tiny,
                                                           greedy_refs):
    p = _prompts()[2]                       # 21 tokens: 3 blocks
    e = _port_engine(tiny)
    first = greedy_refs[2][0]
    req = e.submit(p, M, resume_tokens=[first], kv_blocks=e.stage_alloc(2))
    e.drain(timeout=60)
    assert req.result().tolist() == greedy_refs[2]
    assert e.step_counts()["prefill_chunks"] >= 1
    assert _used(e) == 1


def test_unadopted_staged_blocks_are_released_on_every_path(tiny):
    """EOS-finished resume (answered at once), a refused submit (the
    caller keeps them), and a cancel before admission all leave the pool
    at its base."""
    p = _prompts()[1]
    e = _port_engine(tiny, eos_id=7, max_queue=1)
    req = e.submit(p, M, resume_tokens=[3, 7], kv_blocks=e.stage_alloc(2))
    assert req.done and req.result().tolist() == [3, 7]
    assert _used(e) == 1
    queued = e.submit(p, M, resume_tokens=[3], kv_blocks=e.stage_alloc(2))
    ids = e.stage_alloc(2)
    with pytest.raises(QueueFullError):
        e.submit(p, M, resume_tokens=[3], kv_blocks=ids)
    e.release_kv_ids(ids)                 # still the caller's
    e.cancel(queued)
    assert _used(e) == 1
    # an engine that cannot resume refuses with JAX's message
    unsafe = _port_engine(tiny, paged=False, kv_quant=True)
    with pytest.raises(ValueError, match="cannot resume"):
        unsafe.submit(p, M, resume_tokens=[3])


def test_parked_kv_is_capped_oldest_first(tiny, monkeypatch):
    monkeypatch.setenv("BYTEPS_DISAGG_PARKED_CAP", "2")
    reset_config()
    try:
        e = _port_engine(tiny)
    finally:
        monkeypatch.delenv("BYTEPS_DISAGG_PARKED_CAP")
        reset_config()
    reqs = [e.submit(p, 1, keep_kv=True) for p in _prompts()]
    e.drain(timeout=60)
    assert e.take_parked_kv(reqs[0].id) is None      # evicted, released
    kept = [e.take_parked_kv(r.id) for r in reqs[1:]]
    assert [len(k["ids"]) for k in kept] == [2, 3]
    assert _used(e) == 1 + 5
    for k in kept:
        e.release_kv_ids(k["ids"])
    assert _used(e) == 1
