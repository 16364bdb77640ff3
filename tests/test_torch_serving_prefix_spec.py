"""The dense engine's prefix store and speculative verify, and the paged
engine's gather fallback, held against the JAX package on the same
converted weights and numpy prompts.

* Dense prefix reuse (``ServingEngine(paged=False, prefix_cache=...)``,
  the row-copy :class:`PrefixCache`): greedy streams bit-exact with the
  store on and off and equal to JAX's dense engine with it on, following
  ``tests/test_serving_prefix.py`` — hits, hit tokens and misses counted
  alike, budgets too small for a row, a hit without chunking split into
  fitting buckets, a tiny credit budget, a store shared by engines of
  different weights and row geometries, cancellation mid-prefill; and
  the store's mechanics and eviction against JAX's ``PrefixCache`` on
  the same operations.
* Dense speculation (``spec_k > 0``, one ``verify_tokens`` pass a tick at
  the slots' position vector): streams equal JAX's speculating dense
  engine and the port's speculation off — greedy, EOS inside an accepted
  span, emitted-token metrics, resume — and seeded streams equal
  speculation off (the port's per-token generators); a span at the row's
  end keeps its width.
* The gather fallback (``paged=True, paged_kernel="off"``): streams equal
  JAX's gather engine on a grouped fp pool, an int8 pool, tp = 2 (fp and
  int8), the prefix store under block pressure with preemption, and
  speculation on an fp pool; the high-water bucket and the blocks it
  gathers follow JAX's ``_gather_hw`` tick by tick.
* The model methods: ``verify_tokens`` (an int or a ``[B]`` position),
  ``decode_paged`` and ``verify_tokens_paged`` (every slot's gather in one
  batch) against JAX's (``vmap``-ed a slot at a time), logits and written
  rows within 1e-5, at tp 1 and 2, fp and int8.

fp32 models small enough for the per-test time guard, torch on one
thread: the JAX serving tests' tiny one (vocab 61, learned positions,
MHA) and, for speculation, the same at vocab 8, whose random-weight
greedy output repeats itself so that proposals are accepted; for the
model methods a Llama-shaped one (rope with llama3 scaling, GQA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.inference import generate as jax_generate
from byteps_tpu.models import transformer as jt
from byteps_tpu.serving import PrefixCache as JaxPrefixCache
from byteps_tpu.serving import ServeMetrics as JaxServeMetrics
from byteps_tpu.serving import ServingEngine as JaxServingEngine
from byteps_tpu.serving.blocks import init_paged_cache as jax_paged_cache
from byteps_tpu.serving.prefix import PagedPrefixCache as JaxPagedPrefixCache
from byteps_tpu_torch.models import transformer as pt
from byteps_tpu_torch.models.convert import from_jax_params
from byteps_tpu_torch.serving import (PagedPrefixCache, PrefixCache,
                                      RequestState, ServeMetrics,
                                      ServingEngine)
from byteps_tpu_torch.serving import metrics as sm
from byteps_tpu_torch.serving.blocks import init_paged_cache


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Thousands of tiny torch ops beside other test workers: one
    intra-op thread each keeps them from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


M = 6
TINY = dict(vocab_size=61, num_layers=2, num_heads=2, d_model=32, d_ff=64,
            max_seq_len=64)
TINY8 = dict(TINY, vocab_size=8)
SCALING = (("factor", 32.0), ("high_freq_factor", 4.0),
           ("low_freq_factor", 1.0), ("original_max_position_embeddings", 16),
           ("rope_type", "llama3"))
LLAMA = dict(vocab_size=97, num_layers=2, num_heads=4, num_kv_heads=2,
             d_model=64, d_ff=128, max_seq_len=64, norm_eps=1e-5,
             pos_emb="rope", rope_theta=500000.0, rope_scaling=SCALING,
             mlp="swiglu", tie_embeddings=True)
TOL = 1e-5


def _pair(kw, seed=1):
    jmodel = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **kw))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, 8), jnp.int32))
    cfg = pt.TransformerConfig(dtype=torch.float32, **kw)
    state = from_jax_params(jax.tree_util.tree_map(np.asarray, variables),
                            cfg)
    return jmodel, variables, cfg, state


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY)


@pytest.fixture(scope="module")
def tiny8():
    return _pair(TINY8)


def _model(pair):
    _, _, cfg, state = pair
    model = pt.Transformer(cfg)
    model.load_state_dict(state)
    return model.eval()


def _toks(n, seed, vocab=61):
    return np.random.RandomState(seed).randint(0, vocab, size=(n,)).astype(
        np.int32)


def _port(pair, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 64)
    return ServingEngine(_model(pair), device="cpu", metrics=ServeMetrics(),
                         **kw)


def _jax(pair, **kw):
    jmodel, variables, _, _ = pair
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("temperature", 0.0)
    return JaxServingEngine(jmodel, variables, metrics=JaxServeMetrics(),
                            **kw)


def _run(eng, prompts, m=M, seeds=None, one_by_one=False):
    reqs = []
    for i, p in enumerate(prompts):
        reqs.append(eng.submit(p, m, seed=seeds[i] if seeds else 0))
        if one_by_one:
            eng.drain(timeout=120)
    eng.drain(timeout=120)
    return [np.asarray(r.result()) for r in reqs]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# prompts sharing a 32-token prefix, the bare prefix and an unrelated one
SHARED = _toks(32, 5)
SHARED_PROMPTS = ([np.concatenate([SHARED, _toks(3 + i, 50 + i)])
                   for i in range(2)] + [SHARED.copy(), _toks(20, 60)])
# a hit without chunking: 16 shared tokens, 34-token tails (T = 50)
SPLIT_SHARED = _toks(16, 90)
SPLIT_WARM = np.concatenate([SPLIT_SHARED, _toks(34, 91)])
SPLIT_PROBE = np.concatenate([SPLIT_SHARED, _toks(34, 92)])
# speculation: a repetitive prompt and a random one (vocab 61), and three
# short vocab-8 prompts whose greedy output repeats
REP = np.asarray((list(range(5)) * 4)[:18], np.int32)
RND = _toks(7, 10)
SPEC8 = [_toks(6, 70 + i, vocab=8) for i in range(3)]
# the gather: four short prompts, four longer ones for block pressure
PROMPTS = [_toks(n, 20 + n) for n in (5, 6, 7, 8)]
LONG = [_toks(n, 30 + n) for n in (9, 10, 11, 12)]
PREFIXED = [np.concatenate([_toks(24, 5), _toks(2 + i, 50 + i)])
            for i in range(3)]
_PREFIX_KW = dict(chunk=8, prefix_cache=True, prefix_block=8)
_GATHER_KW = dict(n_slots=4, paged=True, block=8, paged_kernel="off")
_GATHER_CASES = {"fp": {}, "int8": dict(kv_dtype="int8"),
                 "tp2": dict(tp=2), "tp2_int8": dict(tp=2, kv_dtype="int8")}


@pytest.fixture(scope="module")
def jax_streams(tiny, tiny8):
    """The JAX engines' greedy streams, computed once per module (jit
    compiles dominate their cost)."""
    out = {"prefix": _run(_jax(tiny, **_PREFIX_KW), SHARED_PROMPTS,
                          one_by_one=True)}
    eng = _jax(tiny, n_slots=1, chunk=0, prefix_cache=True, prefix_block=8)
    _run(eng, [SPLIT_WARM])
    out["split"] = _run(eng, [SPLIT_PROBE])[0]
    out["spec"] = _run(_jax(tiny, spec_k=4), [REP, RND], 8)
    out["spec8"] = _run(_jax(tiny8, spec_k=4), SPEC8, 30)
    for name, kw in _GATHER_CASES.items():
        out[f"gather_{name}"] = _run(_jax(tiny, **_GATHER_KW, **kw),
                                     PROMPTS, 8)
    out["gather_pressure"] = _run(
        _jax(tiny, **_GATHER_KW, kv_blocks=9, prefix_cache=True,
             kv_dtype="int8"), LONG, 12)
    out["gather_prefix"] = _run(_jax(tiny, **_GATHER_KW, prefix_cache=True),
                                PREFIXED, M, one_by_one=True)
    out["gather_spec"] = _run(_jax(tiny8, **_GATHER_KW, spec_k=4), SPEC8, 30)
    return out


# ------------------------------------------------------ the dense store


def _buf(v, torch_side):
    """A one-layer "row" of 64 bytes: ``[1, 8, 2]`` fp32."""
    if torch_side:
        return [{"k": torch.full((1, 8, 2), v)}]
    return {"k": jnp.full((1, 8, 2), v, jnp.float32)}


def _store_ops(store_cls, torch_side):
    """JAX's store-mechanics sequence (tests/test_serving_prefix.py),
    recorded: every match length, insert result and eviction count."""
    log = []
    pc = store_cls(block=4, max_bytes=3 * 64)
    t = np.arange(16, dtype=np.int32)

    def m(p):
        r = pc.match(p)
        log.append(None if r is None else (r[1], r[0].length))
        return r

    m(t)
    log.append(pc.insertable_len(t[:3]))
    log.append(pc.insertable_len(t[:11]))
    log.append(pc.insert(t[:8], _buf(1.0, torch_side)))
    m(t), m(t[:6]), m(t[:8])
    log.append(pc.insertable_len(t[:8]))
    log.append(pc.insert(t[:8], _buf(9.0, torch_side)))
    t2 = t.copy()
    t2[1] = 60
    m(t2)
    log.append(pc.insert(t2[:8], _buf(2.0, torch_side)))
    m(t)
    for v in (7, 9):
        log.append(pc.insert(np.full((8,), v, np.int32),
                             _buf(float(v), torch_side)))
    log.append(pc.evictions)
    m(t2), m(t)
    pinned, _ = pc.match(np.full((8,), 7, np.int32))
    pc.acquire(pinned)
    log.append(pc.insert(np.full((8,), 11, np.int32), _buf(5.0, torch_side)))
    m(np.full((8,), 7, np.int32))
    pc.release(pinned)
    with pytest.raises(ValueError):
        pc.release(pinned)
    log.append(pc.stats())
    # the repointing case: A owns boundaries 4 and 8, B registers only 12
    pc = store_cls(block=4, max_bytes=2 * 64)
    t = np.arange(12, dtype=np.int32)
    log.append(pc.insert(t[:8], _buf(1.0, torch_side)))
    log.append(pc.insert(t[:12], _buf(2.0, torch_side)))
    log.append(pc.insert(np.full((8,), 50, np.int32), _buf(3.0, torch_side)))
    m(t), m(t[:6])
    log.append(pc.stats())
    tiny_pc = store_cls(block=4, max_bytes=8)
    log.append(tiny_pc.insert(t[:4], _buf(1.0, torch_side)))
    log.append(tiny_pc.entry_count)
    return log


def test_prefix_store_mechanics_and_eviction_match_jax_store():
    """Matches (longest boundary, capped at ``len - 1``), refused
    re-inserts, LRU eviction under the byte budget, pinning, an entry
    larger than the budget, and a boundary re-pointed at a surviving
    entry: the same answers as JAX's store, operation for operation."""
    got = _store_ops(PrefixCache, True)
    assert got == _store_ops(JaxPrefixCache, False)
    # the surviving superset entry answers the evicted entry's boundary
    assert (8, 12) in got


def test_prefix_reuse_bit_exact_greedy(tiny, jax_streams):
    """Requests sharing a 32-token prefix, one after another, chunked:
    equal to JAX's dense prefix engine and the port's store-off engine;
    the hits skip the shared tokens' prefill (two row copies, and an
    extract for each insert)."""
    eng = _port(tiny, **_PREFIX_KW)
    got = _run(eng, SHARED_PROMPTS, one_by_one=True)
    _equal(got, jax_streams["prefix"])
    _equal(got, _run(_port(tiny, chunk=8), SHARED_PROMPTS))
    # 1 hits 32 shared tokens; 2 (the bare prefix) hits, capped at T-1
    assert eng.metrics.get(sm.PREFIX_HITS) == 2
    assert eng.metrics.get(sm.PREFIX_HIT_TOKENS) == 32 + 24
    assert eng.metrics.get(sm.PREFIX_MISSES) == 2
    c = eng.step_counts()
    assert c["prefix_hits"] == c["prefix_copies"] == 2
    assert c["prefix_extracts"] == eng.prefix.stats()["insertions"] >= 1
    assert isinstance(eng.prefix, PrefixCache) and eng.prefix.block == 8
    assert eng.metrics.get(sm.PREFILL_TOKENS) < sum(
        len(p) + 8 for p in SHARED_PROMPTS)
    # a stored row is zero past its block-aligned length
    e = eng.prefix.match(SHARED_PROMPTS[0], salt=eng._prefix_salt)[0]
    assert not e.buffer[0]["k"][:, e.length:].any()


def test_prefix_reuse_seeded_equals_store_off(tiny):
    """Seeded sampling draws token ``k`` from its own generator, so a hit
    cannot shift the sampled stream."""
    kw = dict(temperature=0.8, top_k=20, n_slots=1)
    on = _port(tiny, **kw, **_PREFIX_KW)
    got = _run(on, SHARED_PROMPTS[:2], seeds=[7, 142], one_by_one=True)
    assert on.metrics.get(sm.PREFIX_HITS) == 1
    _equal(got, _run(_port(tiny, chunk=8, **kw), SHARED_PROMPTS[:2],
                     seeds=[7, 142]))


@pytest.mark.parametrize("budget", ["64 bytes", "one row less a byte"])
def test_prefix_cache_budget_zero_disables_reuse_correctly(tiny, budget):
    """A byte budget too small for one entry refuses every insert — the
    row is not even extracted: every lookup misses and the streams stay
    exact (JAX's case is 64 bytes; one row here is 32 KiB)."""
    probe = _port(tiny, n_slots=1, **_PREFIX_KW)
    row = probe._prefix_row_bytes
    assert row == 2 * 2 * 64 * 32 * 4        # layers x K,V x S x KV*D x fp32
    nbytes = 64 if budget == "64 bytes" else row - 1
    eng = _port(tiny, n_slots=1, prefix_bytes=nbytes, **_PREFIX_KW)
    p = SHARED_PROMPTS[0]
    want = _run(_port(tiny, n_slots=1, chunk=8), [p])[0]
    for _ in range(2):
        np.testing.assert_array_equal(_run(eng, [p])[0], want)
    assert eng.metrics.get(sm.PREFIX_HITS) == 0
    assert eng.prefix.stats()["entries"] == 0
    assert eng.step_counts()["prefix_extracts"] == 0
    # a budget of one row holds one entry and hits
    fits = _port(tiny, n_slots=1, prefix_bytes=row, **_PREFIX_KW)
    _run(fits, [p, p], one_by_one=True)
    assert fits.metrics.get(sm.PREFIX_HITS) == 1


def test_prefix_hit_without_chunking_splits_instead_of_refeeding(
        tiny, jax_streams):
    """chunk=0 and a 16-token hit in a 50-token prompt: the covering
    64-bucket would overrun the 64-row slot, so prefill splits into 32 +
    8 padded tokens at the boundary instead of re-feeding the copied
    prefix; equal to JAX's engine (and the whole-prompt miss)."""
    eng = _port(tiny, n_slots=1, chunk=0, prefix_cache=True, prefix_block=8)
    _run(eng, [SPLIT_WARM])
    before = eng.metrics.get(sm.PREFILL_TOKENS)
    got = _run(eng, [SPLIT_PROBE])[0]
    np.testing.assert_array_equal(got, jax_streams["split"])
    np.testing.assert_array_equal(
        got, _run(_port(tiny, n_slots=1), [SPLIT_PROBE])[0])
    assert eng.metrics.get(sm.PREFIX_HITS) == 1
    assert eng.metrics.get(sm.PREFIX_HIT_TOKENS) == 16
    assert eng.metrics.get(sm.PREFILL_TOKENS) - before == 40


def test_tiny_credit_budget_cannot_stall_prefix_resume(tiny, jax_streams):
    """A continuation bucket larger than the whole per-tick credit budget
    clamps its debit instead of waiting for credits that never accrue."""
    eng = _port(tiny, n_slots=1, chunk=0, prefix_cache=True, prefix_block=8,
                prefill_credits=4)
    _run(eng, [SPLIT_WARM])
    np.testing.assert_array_equal(_run(eng, [SPLIT_PROBE])[0],
                                  jax_streams["split"])
    assert eng.metrics.get(sm.PREFIX_HITS) == 1


def test_shared_store_isolates_different_weights(tiny):
    """Engines sharing one store: other weights (B) miss on what A stored
    and land their own entry; the same weights (C) hit A's; the same
    weights at another row geometry (D, max_seq 48) miss.  Every stream
    equals its own store-off run."""
    other = _pair(TINY, seed=99)
    p = SHARED_PROMPTS[0]
    store = PrefixCache(block=8)

    def eng(pair, max_seq=64):
        return _port(pair, n_slots=1, max_seq=max_seq, chunk=8,
                     prefix_cache=store)

    def alone(pair, max_seq=64):
        return _run(_port(pair, n_slots=1, max_seq=max_seq, chunk=8), [p])[0]

    a = eng(tiny)
    np.testing.assert_array_equal(_run(a, [p])[0], alone(tiny))
    assert store.stats()["entries"] == 1
    b = eng(other)
    np.testing.assert_array_equal(_run(b, [p])[0], alone(other))
    assert b.metrics.get(sm.PREFIX_HITS) == 0
    assert store.stats()["entries"] == 2
    c = eng(tiny)
    np.testing.assert_array_equal(_run(c, [p])[0], alone(tiny))
    assert c.metrics.get(sm.PREFIX_HITS) == 1
    d = eng(tiny, max_seq=48)
    np.testing.assert_array_equal(_run(d, [p])[0], alone(tiny, 48))
    assert d.metrics.get(sm.PREFIX_HITS) == 0


def test_cancel_mid_prefill_frees_slot(tiny):
    """A 40-token prompt chunked at 8 is cancelled mid-prefill: it never
    reaches a token, its slot and credits come back, and nothing is
    inserted for it."""
    eng = _port(tiny, n_slots=1, **_PREFIX_KW)
    r = eng.submit(_toks(40, 33), 4)
    eng.step()
    assert r.state is RequestState.PREFILLING
    eng.cancel(r)
    eng.step()
    assert r.done and r.state is RequestState.CANCELLED and not r.tokens
    assert eng.pool.free_count == 1
    assert eng.scheduler.credits == eng.scheduler.credit_budget
    assert eng.prefix.stats()["insertions"] == 0


def test_store_kinds_are_refused_across_engine_kinds(tiny):
    """JAX's two refusals, in both packages with its words: a paged
    store cannot back a dense engine, nor a plain store a paged one."""
    jm, jv, _, _ = tiny
    from byteps_tpu.serving.blocks import BlockAllocator as JaxAllocator

    from byteps_tpu_torch.serving import BlockAllocator

    cases = [
        (dict(), JaxPagedPrefixCache(JaxAllocator(4, 8), block=8,
                                     block_bytes=64),
         PagedPrefixCache(BlockAllocator(4, 8), block=8, block_bytes=64),
         "cannot back a dense engine"),
        (dict(paged=True, block=8), JaxPrefixCache(block=8),
         PrefixCache(block=8), "cannot be shared across engines")]
    for kw, jstore, pstore, match in cases:
        with pytest.raises(ValueError, match=match):
            JaxServingEngine(jm, jv, n_slots=2, max_seq=64,
                             prefix_cache=jstore, metrics=JaxServeMetrics(),
                             **kw)
        with pytest.raises(ValueError, match=match):
            _port(tiny, prefix_cache=pstore, **kw)
    with pytest.raises(TypeError, match="insert_blocks"):
        cases[0][2].insert(np.arange(8), [{}])


# ------------------------------------------------------ dense speculation


def test_spec_greedy_matches_jax_and_spec_off(tiny, tiny8, jax_streams):
    """A repetitive and a random prompt batched, then three vocab-8
    prompts: streams equal JAX's speculating dense engine and the port's
    speculation off; every tick is one verify pass, and on vocab 8
    proposals are accepted (fewer ticks than tokens)."""
    eng = _port(tiny, spec_k=4)
    got = _run(eng, [REP, RND], 8)
    _equal(got, jax_streams["spec"])
    _equal(got, _run(_port(tiny), [REP, RND], 8))
    want = [np.asarray(jax_generate(tiny[0], tiny[1], p[None], 8,
                                    temperature=0.0)["tokens"])[0]
            for p in (REP, RND)]
    _equal(got, want)
    eng = _port(tiny8, n_slots=4, spec_k=4)
    got = _run(eng, SPEC8, 30)
    _equal(got, jax_streams["spec8"])
    _equal(got, _run(_port(tiny8, n_slots=4), SPEC8, 30))
    c = eng.step_counts()
    assert c["verify_ticks"] == c["decode_ticks"] < 29 * len(SPEC8)
    assert c["spec_accepted"] == eng.metrics.get(sm.SPEC_ACCEPTED) > 0
    assert c["spec_proposed"] == eng.metrics.get(sm.SPEC_PROPOSED)
    assert eng.metrics.get(sm.TOKENS) == 30 * len(SPEC8)


def test_spec_seeded_equals_spec_off(tiny8):
    kw = dict(n_slots=3, temperature=0.8, top_k=5)
    seeds = [3, 4, 5]
    on = _run(_port(tiny8, spec_k=4, **kw), SPEC8, 30, seeds)
    _equal(on, _run(_port(tiny8, **kw), SPEC8, 30, seeds))


def test_spec_eos_truncates_accepted_span(tiny8, jax_streams):
    """An EOS inside an accepted span ends the request at the EOS, as in
    JAX's engine; only emitted tokens are counted."""
    full = jax_streams["spec8"][0]
    eos = int(full[10])
    want = list(full[:list(full).index(eos) + 1])
    eng = _port(tiny8, n_slots=1, spec_k=4, eos_id=eos)
    got = _run(eng, SPEC8[:1], 30)[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _run(_jax(tiny8, n_slots=1, spec_k=4, eos_id=eos),
                  SPEC8[:1], 30)[0])
    assert eng.metrics.get(sm.TOKENS) == len(want)


def test_spec_metrics_count_only_emitted_tokens(tiny8, jax_streams):
    """A budget of 3 with spans that overrun it: ``serve.tokens`` counts
    the emitted tokens only; a resumed request counts only this engine's
    emissions and continues the stream."""
    eng = _port(tiny8, n_slots=3, spec_k=4)
    for r in _run(eng, SPEC8, 3):
        assert len(r) == 3
    assert eng.metrics.get(sm.TOKENS) == 3 * len(SPEC8)
    full = jax_streams["spec8"][0]
    eng2 = _port(tiny8, n_slots=1, spec_k=4)
    req = eng2.submit(SPEC8[0], 30, resume_tokens=[int(t) for t in full[:3]])
    eng2.drain(timeout=120)
    np.testing.assert_array_equal(req.result(), full)
    assert eng2.metrics.get(sm.TOKENS) == 30 - 3


def test_spec_at_the_row_end_keeps_its_width(tiny8):
    """A request that runs to the last position of a 64-row slot beside a
    short one: every verify pass is 5 wide, the span past the row's end
    is clamped there (its rows discarded), and the streams equal
    speculation off."""
    prompts = [np.tile(SPEC8[0], 4)[:22], SPEC8[1]]
    eng = _port(tiny8, spec_k=4)
    widths = []
    verify = eng.model.verify_tokens

    def record(tokens, *a, **kw):
        widths.append(tokens.shape[1])
        return verify(tokens, *a, **kw)

    eng.model.verify_tokens = record
    got = _run(eng, prompts, 42)
    assert set(widths) == {5}
    _equal(got, _run(_port(tiny8), prompts, 42))
    c = eng.step_counts()
    assert c["verify_ticks"] == c["decode_ticks"] > 0


def test_dense_spec_refusals_match_jax(tiny):
    """JAX's refusals of dense speculation, in both packages: int8 rows,
    and rows that are not grouped."""
    jm, jv, _, _ = tiny
    for kw, match in ((dict(kv_quant=True), "dense fp"),
                      (dict(cache_layout="flat"), "grouped")):
        with pytest.raises(ValueError, match=match):
            JaxServingEngine(jm, jv, n_slots=1, max_seq=64, spec_k=4,
                             metrics=JaxServeMetrics(), **kw)
        with pytest.raises(ValueError, match=match):
            _port(tiny, spec_k=4, **kw)
    eng = _port(tiny, spec_k=7, spec_ngram=1)
    assert eng.spec.k == 4 and eng.spec.min_ngram == 2


# --------------------------------------------------- the gather fallback


@pytest.mark.parametrize("case", list(_GATHER_CASES))
def test_gather_streams_match_jax_gather_engine(tiny, jax_streams, case):
    """``paged_kernel="off"``: a grouped fp pool, an int8 pool, tp = 2 fp
    and int8 — the streams equal JAX's gather engine with the same pool,
    reruns equal, tp = 2 equals tp = 1; no paged-kernel call runs, and
    every block comes back."""
    from byteps_tpu_torch.ops import paged_attention as pa

    kw = _GATHER_CASES[case]
    eng = _port(tiny, **_GATHER_KW, **kw)
    k = eng.pool.caches[0]["k"]
    if case == "fp":
        assert k.shape[1:] == (8, 2, 16)            # grouped
    else:
        assert k.shape[-1] == 32 // kw.get("tp", 1)  # flat (per shard)
    calls = pa.launches + pa.plain_calls
    got = _run(eng, PROMPTS, 8)
    assert pa.launches + pa.plain_calls == calls
    _equal(got, jax_streams[f"gather_{case}"])
    _equal(got, _run(eng, PROMPTS, 8))
    if "tp" in kw:
        _equal(got, jax_streams["gather_int8" if "kv_dtype" in kw
                                else "gather_fp"])
    assert eng.pool.alloc.used_count == 1
    assert eng.step_counts()["gather_buckets"] >= 1


def test_gather_prefix_store_and_preemption(tiny, jax_streams):
    """The gather under block pressure (9 blocks for 4 requests of 3) on
    an int8 pool with the prefix store: preemptions and re-prefills, the
    streams equal JAX's; and on an fp pool, prefix hits equal to JAX's
    and to the store off."""
    eng = _port(tiny, **_GATHER_KW, kv_blocks=9, prefix_cache=True,
                kv_dtype="int8")
    got = _run(eng, LONG, 12)
    assert eng.metrics.get(sm.PREEMPTIONS) >= 1
    _equal(got, jax_streams["gather_pressure"])
    eng = _port(tiny, **_GATHER_KW, prefix_cache=True)
    got = _run(eng, PREFIXED, M, one_by_one=True)
    _equal(got, jax_streams["gather_prefix"])
    _equal(got, _run(_port(tiny, **_GATHER_KW), PREFIXED, M))
    assert eng.step_counts()["prefix_hits"] == 2


def test_gather_spec_on_an_fp_pool(tiny8, jax_streams):
    """Speculation over the gather (tq = 5 gathered, spans scattered back
    position by position): equal to JAX's gather engine and to
    speculation off, with accepted proposals; an int8 pool takes it on
    the CPU too (refused on CUDA, where the decode kernel serves tq =
    1)."""
    eng = _port(tiny8, **_GATHER_KW, spec_k=4)
    got = _run(eng, SPEC8, 30)
    _equal(got, jax_streams["gather_spec"])
    _equal(got, _run(_port(tiny8, **_GATHER_KW), SPEC8, 30))
    assert eng.step_counts()["spec_accepted"] > 0
    q8 = _port(tiny8, **_GATHER_KW, spec_k=4, kv_dtype="int8")
    _equal(_run(q8, SPEC8, 30),
           _run(_port(tiny8, **_GATHER_KW, kv_dtype="int8"), SPEC8, 30))


def test_gather_bucket_follows_jax_on_a_staggered_trace(tiny):
    """Arrivals staggered over ticks, one engine of each package stepped
    in lockstep: after every tick the high-water bucket (``_gather_hw``)
    and the blocks gathered so far are JAX's."""
    lengths = (5, 30, 12, 45)
    prompts = [_toks(n, 40 + n) for n in lengths]
    eng = _port(tiny, **_GATHER_KW)
    jeng = _jax(tiny, **_GATHER_KW)
    trace = []
    for t in range(24):
        if t % 3 == 0 and t // 3 < len(prompts):
            for e in (eng, jeng):
                e.submit(prompts[t // 3], 12)
        eng.step()
        jeng.step()
        hw = eng._gather_hw(1)
        assert hw == jeng._gather_hw(1), t
        assert (eng.metrics.get(sm.GATHERED_BLOCKS)
                == jeng.metrics.get(sm.GATHERED_BLOCKS)), t
        trace.append(hw)
    assert len(set(trace)) >= 3                 # the bucket moved


# ------------------------------------------------------ the model methods


@pytest.fixture(scope="module")
def llama():
    jmodel, variables, cfg, state = _pair(LLAMA)
    model = pt.Transformer(cfg)
    model.load_state_dict(state)
    return jmodel, variables, cfg, model.eval()


def _written(rows, r, pos, tq):
    """Each layer's leaves at row ``r``, positions ``[pos, pos + tq)``,
    flattened past the position axis."""
    return [{n: np.asarray(t[r, pos:pos + tq]).reshape(tq, -1)
             for n, t in layer.items()} for layer in rows]


def _close_rows(got, want):
    for g, w in zip(got, want):
        for n in w:
            np.testing.assert_allclose(g[n].astype(np.float32),
                                       w[n].astype(np.float32), atol=TOL,
                                       rtol=0, err_msg=n)


@pytest.mark.parametrize("vector", [False, True])
def test_verify_tokens_matches_jax(llama, vector):
    """``verify_tokens`` at 4 query positions on grouped rows: at one
    offset for every row, or at a ``[3]`` position vector (JAX: the
    method ``vmap``-ed a row at a time, as its dense engine runs it)."""
    jmodel, variables, cfg, model = llama
    rng = np.random.RandomState(8)
    S, B, tq = 48, 3, 4
    rows = [{n: rng.randn(B, S, 2, 16).astype(np.float32) * 0.5
             for n in ("k", "v")} for _ in range(cfg.num_layers)]
    toks = rng.randint(0, 97, size=(B, tq)).astype(np.int32)
    pos = np.array([9, 20, 31] if vector else [17] * B, np.int32)
    jrows = tuple({n: jnp.asarray(a) for n, a in r.items()} for r in rows)
    if vector:
        def one(row, t, p):
            rb = jax.tree_util.tree_map(lambda c: c[None], row)
            lg, new = jmodel.apply(variables, t[None], rb, p,
                                   method=jt.Transformer.verify_tokens)
            return lg[0], jax.tree_util.tree_map(lambda c: c[0], new)

        want, jnew = jax.jit(jax.vmap(one))(jrows, jnp.asarray(toks),
                                            jnp.asarray(pos))
    else:
        want, jnew = jmodel.apply(variables, jnp.asarray(toks), jrows,
                                  jnp.asarray(17),
                                  method=jt.Transformer.verify_tokens)
    prows = [{n: torch.from_numpy(a.copy()) for n, a in r.items()}
             for r in rows]
    got, _ = model.verify_tokens(torch.from_numpy(toks).long(), prows,
                                 torch.from_numpy(pos) if vector else 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    for b in range(B):
        _close_rows(_written(prows, b, int(pos[b]), tq),
                    _written(jnew, b, int(pos[b]), tq))


def test_verify_span_past_the_row_end_is_clamped(llama):
    """A 5-wide span at position S - 2 of a 48-row cache writes only its
    two in-row positions (the span past the end lands on the last row
    with that row's own value) and gives those positions the logits of a
    2-wide verify at the same place; a neighbour's row is untouched."""
    _, _, cfg, model = llama
    rng = np.random.RandomState(9)
    S = 48
    rows = [{n: torch.from_numpy(rng.randn(2, S, 2, 16).astype(np.float32))
             for n in ("k", "v")} for _ in range(cfg.num_layers)]
    twin = [{n: t.clone() for n, t in r.items()} for r in rows]
    toks = torch.from_numpy(rng.randint(0, 97, size=(2, 5))).long()
    pos = torch.tensor([S - 2, 3], dtype=torch.int32)
    got, _ = model.verify_tokens(toks, rows, pos)
    ref, _ = model.verify_tokens(toks[:, :2], twin, pos)
    np.testing.assert_allclose(got[0, :2].numpy(), ref[0].numpy(),
                               atol=TOL, rtol=0)
    for r, t in zip(rows, twin):
        for n in r:
            torch.testing.assert_close(r[n][0], t[n][0], atol=TOL, rtol=0)
            torch.testing.assert_close(r[n][1, :3], t[n][1, :3])


_POOL_CASES = [(1, ""), (1, "int8"), (2, ""), (2, "int8")]


def _pools(jcfg, pcfg, tp, kv_dtype, n_blocks, rng):
    """The same random pool bytes in both packages' layouts (grouped fp
    at tp = 1, as the gather engines keep it; flat otherwise)."""
    layout = "grouped" if tp == 1 and not kv_dtype else "flat"
    jpool = jax_paged_cache(jcfg, n_blocks, 8, layout=layout,
                            kv_dtype=kv_dtype, tp=tp)
    ppool = init_paged_cache(pcfg, n_blocks, 8, kv_dtype=kv_dtype, tp=tp,
                             layout=layout)
    out = []
    for jl, pl in zip(jpool, ppool):
        layer = {}
        for n, t in pl.items():
            shape = tuple(t.shape)
            a = (rng.randint(-127, 128, size=shape).astype(np.int8)
                 if t.dtype == torch.int8 else
                 (rng.rand(*shape).astype(np.float32) * 0.02 + 0.001
                  if n.endswith("scale") else
                  rng.randn(*shape).astype(np.float32) * 0.5))
            assert tuple(jl[n].shape) == shape
            t.copy_(torch.from_numpy(a))
            layer[n] = jnp.asarray(a)
        out.append(layer)
    return tuple(out), ppool


@pytest.mark.parametrize("tp,kv_dtype", _POOL_CASES)
@pytest.mark.parametrize("tq", [1, 3])
def test_decode_and_verify_paged_match_jax(llama, tp, kv_dtype, tq):
    """``decode_paged`` (tq = 1) and ``verify_tokens_paged`` (tq = 3) over
    three slots' tables in ONE batched gather at the high-water bucket,
    against JAX's methods ``vmap``-ed a slot at a time: logits and the
    written rows within 1e-5 (int8 values and scales from the same
    quantization), at tp 1 and 2, fp and int8."""
    jmodel, variables, cfg, model = llama
    rng = np.random.RandomState(11 + tp + tq + len(kv_dtype))
    n_blocks, mb = 16, 64 // 8
    jpool, ppool = _pools(jmodel.cfg, cfg, tp, kv_dtype, n_blocks, rng)
    tables = np.zeros((3, mb), np.int32)
    tables[0, :2] = [5, 2]
    tables[1, :3] = [7, 9, 3]
    tables[2, :1] = [11]
    pos = np.array([12, 21, 4], np.int32)
    hw = 4
    toks = rng.randint(0, 97, size=(3, tq)).astype(np.int32)
    method = (jt.Transformer.decode_paged if tq == 1
              else jt.Transformer.verify_tokens_paged)

    def one(table, t, p):
        lg, rows = jmodel.apply(variables, t[None], jpool, table, p,
                                hw_blocks=hw, tp=tp, method=method)
        return lg[0], jax.tree_util.tree_map(lambda c: c[0], rows)

    want, jrows = jax.jit(jax.vmap(one))(
        jnp.asarray(tables), jnp.asarray(toks), jnp.asarray(pos))
    fn = model.decode_paged if tq == 1 else model.verify_tokens_paged
    got, prows = fn(torch.from_numpy(toks).long(), ppool,
                    torch.from_numpy(tables), torch.from_numpy(pos),
                    hw_blocks=hw, tp=tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    assert prows[0]["k"].shape[:2] == (3, hw * 8)
    for s in range(3):
        _close_rows(_written(prows, s, int(pos[s]), tq),
                    _written(jrows, s, int(pos[s]), tq))


@pytest.mark.parametrize("tp,kv_dtype", _POOL_CASES)
def test_decode_paged_refuses_a_tp_its_pools_do_not_carry(llama, tp,
                                                          kv_dtype):
    """``tp`` is the caller's, as in JAX: a value that the pools' layout
    does not carry (a shard axis read as the block axis, or the block
    axis as shards) is refused before any gather, in decode, verify and
    chunk prefill alike."""
    jmodel, _, cfg, model = llama
    rng = np.random.RandomState(5)
    _, ppool = _pools(jmodel.cfg, cfg, tp, kv_dtype, 16, rng)
    tables = torch.zeros((2, 8), dtype=torch.int32)
    pos = torch.tensor([3, 9], dtype=torch.int32)
    wrong = 2 if tp == 1 else 1
    for fn, tq in ((model.decode_paged, 1), (model.verify_tokens_paged, 3)):
        with pytest.raises(ValueError, match=f"not a tp={wrong} pool"):
            fn(torch.zeros((2, tq), dtype=torch.long), ppool, tables, pos,
               hw_blocks=2, tp=wrong)
    with pytest.raises(ValueError, match=f"not a tp={wrong} pool"):
        model.prefill_chunk_paged(torch.zeros((1, 8), dtype=torch.long),
                                  ppool, tables[0], 0, 7, tp=wrong)
