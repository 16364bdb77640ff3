"""The port's serving tiers — int8 and tensor-parallel block pools, the
radix prefix cache with copy-on-write, and speculative verify — held
against the JAX package.

* Greedy streams of the port's ``ServingEngine(device="cpu")`` equal the
  JAX ``ServingEngine(paged=True, paged_kernel="off")``'s on the same
  converted weights and prompts: int8 pools, tp = 2 (fp and int8), the
  prefix cache on (with hits counted), a copy-on-write fork of a shared
  quantized block, preempt/resume under int8 and tp, and speculation on
  (equal to speculation off, and to JAX's).
* Seeded streams with speculation on equal speculation off within the
  port (the draw for token ``k`` is the same from a verify tick or a
  plain one).
* The radix store and the n-gram proposer give JAX's results on the
  same sequences; the serve role with ``BYTEPS_TP=2``,
  ``BYTEPS_SERVE_KV_DTYPE=int8``, ``BYTEPS_SERVE_PREFIX_CACHE=1`` and
  ``BYTEPS_SERVE_SPEC=1`` shards its pool and answers a JAX client.

Two-layer models narrow enough for the per-test time guard: vocab 61
(as tests/test_torch_serving.py) and, for speculation, vocab 8, whose
random-weight greedy output repeats itself, so proposals are accepted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models.transformer import Transformer as JaxTransformer
from byteps_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from byteps_tpu.serving import RemoteServeClient as JaxRemoteServeClient
from byteps_tpu.serving import ServeMetrics as JaxServeMetrics
from byteps_tpu.serving import ServingEngine as JaxServingEngine
from byteps_tpu.serving.blocks import BlockAllocator as JaxBlockAllocator
from byteps_tpu.serving.prefix import PagedPrefixCache as JaxPagedPrefixCache
from byteps_tpu.serving.spec import NgramProposer as JaxNgramProposer
from byteps_tpu_torch.models.convert import from_jax_params
from byteps_tpu_torch.models.transformer import Transformer, TransformerConfig
from byteps_tpu_torch.serving import BlockAllocator, BlockTable, ServeMetrics
from byteps_tpu_torch.serving import ServingEngine
from byteps_tpu_torch.serving import metrics as sm
from byteps_tpu_torch.serving.prefix import PagedPrefixCache
from byteps_tpu_torch.serving.spec import NgramProposer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU tests run thousands of tiny torch ops beside other test
    workers: one intra-op thread each keeps them from oversubscribing the
    host.  The streams are the same at one thread and at the default
    count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


M = 8
KW = dict(vocab_size=61, num_layers=2, num_heads=2, d_model=32, d_ff=64,
          max_seq_len=64)
KW8 = dict(KW, vocab_size=8)


def _models(kw):
    jcfg = JaxTransformerConfig(dtype=jnp.float32, **kw)
    jmodel = JaxTransformer(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(1),
                            jnp.zeros((1, 8), jnp.int32))
    pcfg = TransformerConfig(dtype=torch.float32, **kw)
    state = from_jax_params(jax.tree_util.tree_map(np.asarray, variables),
                            pcfg)
    return jmodel, variables, pcfg, state


@pytest.fixture(scope="module")
def tiny():
    return _models(KW)


@pytest.fixture(scope="module")
def tiny8():
    return _models(KW8)


def _toks(n, seed, vocab=61):
    return np.random.RandomState(seed).randint(0, vocab, size=(n,)).astype(
        np.int32)


PROMPTS = [_toks(n, 20 + n) for n in (5, 6, 7, 8)]
LONG = [_toks(n, 30 + n) for n in (9, 10, 11, 12)]
SHARED = _toks(24, 5)
PREFIXED = [np.concatenate([SHARED, _toks(2 + i, 50 + i)]) for i in range(3)]
SPEC = [_toks(6, 70 + i, vocab=8) for i in range(3)]


def _port(models, **kw):
    _, _, pcfg, state = models
    model = Transformer(pcfg)
    model.load_state_dict(state)
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_seq", 64)
    kw.setdefault("block", 8)
    return ServingEngine(model, paged=True, device="cpu",
                         metrics=ServeMetrics(), **kw)


def _jax(models, **kw):
    jmodel, variables, _, _ = models
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_seq", 64)
    kw.setdefault("block", 8)
    return JaxServingEngine(jmodel, variables, temperature=0.0, paged=True,
                            paged_kernel="off", metrics=JaxServeMetrics(),
                            **kw)


def _run(eng, prompts, m, seeds=None, one_by_one=False):
    """Streams of ``prompts`` through ``eng`` (all submitted at once, or
    each drained before the next when ``one_by_one``)."""
    out = []
    reqs = []
    for i, p in enumerate(prompts):
        reqs.append(eng.submit(p, m, seed=seeds[i] if seeds else 0))
        if one_by_one:
            eng.drain(timeout=120)
    eng.drain(timeout=120)
    for r in reqs:
        out.append(np.asarray(r.result()))
    return out


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def jax_streams(tiny, tiny8):
    """The JAX engine's greedy streams, computed once per module (jit
    compiles dominate their cost): int8 pools; tp = 2 fp and int8; the
    prefix cache over shared-prefix prompts; int8 under block pressure;
    the copy-on-write case; speculation on the vocab-8 model."""
    out = {
        "int8": _run(_jax(tiny, kv_dtype="int8"), PROMPTS, M),
        "tp2": _run(_jax(tiny, tp=2), PROMPTS, M),
        "tp2_int8": _run(_jax(tiny, tp=2, kv_dtype="int8"), PROMPTS, M),
        "prefix": _run(_jax(tiny, prefix_cache=True), PREFIXED, M,
                       one_by_one=True),
        "int8_long": _run(_jax(tiny, kv_dtype="int8"), LONG, 12),
        "spec": _run(_jax(tiny8, spec_k=4), SPEC, 40),
    }
    jeng = _jax(tiny, **_COW_KW)
    _run(jeng, _COW_PROMPTS[:1], 2)
    out["cow"] = _run(jeng, _COW_PROMPTS[1:], 3)[0]
    return out


def test_int8_pool_streams_match_jax_engine(tiny, jax_streams):
    """s8 blocks with scale rows, quantized at write on the chunk and the
    decode paths alike: the port equals JAX's int8 engine, and reruns
    equal each other; every block comes back."""
    eng = _port(tiny, kv_dtype="int8")
    got = _run(eng, PROMPTS, M)
    _equal(got, jax_streams["int8"])
    _equal(_run(eng, PROMPTS, M), got)
    assert eng.pool.caches[0]["k"].dtype == torch.int8
    assert eng.pool.caches[0]["k_scale"].shape == (eng.pool.alloc.n_blocks,
                                                   8, 2)
    assert eng.pool.alloc.used_count == 1


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_tp2_streams_match_jax_and_tp1(tiny, jax_streams, kv_dtype):
    """Per-shard pools ``[2, n_blocks, block, KV/2 * D]``: the port's tp=2
    engine equals JAX's tp=2 engine and the port's own tp=1 engine."""
    eng = _port(tiny, tp=2, kv_dtype=kv_dtype)
    assert eng.pool.caches[0]["k"].shape[:2] == (2, eng.pool.alloc.n_blocks)
    got = _run(eng, PROMPTS, M)
    _equal(got, jax_streams["tp2_int8" if kv_dtype else "tp2"])
    _equal(got, _run(_port(tiny, kv_dtype=kv_dtype), PROMPTS, M))


def test_prefix_cache_hits_match_jax_and_cache_off(tiny, jax_streams):
    """Prompts sharing a 24-token (3-block) prefix, one after another:
    the second and third share the first's blocks (refcounts, no copy),
    and every stream equals JAX's prefix engine and a cache-off run."""
    eng = _port(tiny, prefix_cache=True)
    got = _run(eng, PREFIXED, M, one_by_one=True)
    _equal(got, jax_streams["prefix"])
    _equal(got, _run(_port(tiny), PREFIXED, M))
    counts = eng.step_counts()
    assert counts["prefix_hits"] == eng.metrics.get(sm.PREFIX_HITS) == 2
    assert eng.metrics.get(sm.PREFIX_HIT_TOKENS) == 2 * 24
    assert counts["cow_copies"] == 0
    st = eng.prefix.stats()
    assert st["hits"] == 2 and st["nodes"] >= 3
    # the store holds its blocks after the requests are gone
    assert eng.pool.alloc.used_count == 1 + st["nodes"]


# the copy-on-write case: a 56-token prefix hit leaves a 1-token tail
# whose 8-token bucket would overrun max_seq 60; the chunk shifts left
# to 52 and re-feeds positions 52..55, which live in a shared block
_COW_KW = dict(n_slots=1, max_seq=60, block=4, kv_dtype="int8",
               prefix_cache=True, kv_blocks=20)
_X = _toks(56, 7)
_COW_PROMPTS = [np.concatenate([_X, _toks(2, 8)]),
                np.concatenate([_X, _toks(1, 9)])]


def test_cow_forks_a_shared_quantized_block(tiny, jax_streams):
    """``make_writable`` forks the shared block (values and scale rows)
    before the re-feed rewrites it; the stream equals JAX's and a solo
    int8 run that never shared, and the stored block is unchanged."""
    eng = _port(tiny, **_COW_KW)
    _run(eng, _COW_PROMPTS[:1], 2)
    shared = eng.prefix.match(_COW_PROMPTS[1],
                              salt=eng._prefix_salt)[0].buffer[-1]
    before = {n: t[shared].clone() for n, t in eng.pool.caches[0].items()}
    got = _run(eng, _COW_PROMPTS[1:], 3)[0]
    assert eng.step_counts()["cow_copies"] == 1
    assert eng.metrics.get(sm.PREFIX_HIT_TOKENS) == 56
    for n, t in eng.pool.caches[0].items():
        assert torch.equal(t[shared], before[n]), n
    np.testing.assert_array_equal(got, jax_streams["cow"])
    solo = _port(tiny, **dict(_COW_KW, prefix_cache=False))
    np.testing.assert_array_equal(got, _run(solo, _COW_PROMPTS[1:], 3)[0])


@pytest.mark.parametrize("kw", [{"kv_dtype": "int8"},
                                {"tp": 2, "kv_dtype": "int8"},
                                {"tp": 2}])
def test_preempt_resume_under_int8_and_tp(tiny, jax_streams, kw):
    """A 9-block pool cannot hold 4 requests of 3 blocks: requests are
    preempted and re-prefilled, and the re-prefill rewrites the same
    int8 bytes — streams equal the unpressured run (and JAX's int8
    engine)."""
    eng = _port(tiny, kv_blocks=9, **kw)
    got = _run(eng, LONG, 12)
    assert eng.metrics.get(sm.PREEMPTIONS) >= 1
    assert eng.pool.alloc.used_count == 1
    _equal(got, _run(_port(tiny, **kw), LONG, 12))
    if kw.get("kv_dtype"):
        _equal(got, jax_streams["int8_long"])


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_spec_greedy_matches_spec_off_and_jax(tiny8, jax_streams, kv_dtype):
    """Speculation with n-gram proposals, verified by the kernel's plain
    version at tq = k + 1: the streams equal speculation off (and JAX's
    speculating engine in fp); proposals are accepted, so verify ticks
    emit several tokens."""
    eng = _port(tiny8, spec_k=4, kv_dtype=kv_dtype)
    got = _run(eng, SPEC, 40)
    _equal(got, _run(_port(tiny8, kv_dtype=kv_dtype), SPEC, 40))
    if not kv_dtype:
        _equal(got, jax_streams["spec"])
    c = eng.step_counts()
    assert c["verify_ticks"] > 0 and c["spec_accepted"] > 0
    assert c["spec_proposed"] == eng.metrics.get(sm.SPEC_PROPOSED)
    assert c["spec_accepted"] == eng.metrics.get(sm.SPEC_ACCEPTED)
    assert eng.metrics.get(sm.TOKENS) == 40 * len(SPEC)
    assert c["decode_ticks"] < 39 * len(SPEC)


def test_spec_seeded_equals_spec_off_and_truncates_at_eos(tiny8):
    kw = dict(temperature=0.8, top_k=5)
    seeds = [3, 4, 5]
    on = _run(_port(tiny8, spec_k=4, **kw), SPEC, 40, seeds)
    _equal(on, _run(_port(tiny8, **kw), SPEC, 40, seeds))
    # an EOS inside an accepted span ends the stream at the EOS
    full = _run(_port(tiny8, spec_k=4), SPEC[:1], 40)[0]
    eos = int(full[10])
    want = full[:list(full).index(eos) + 1]
    got = _run(_port(tiny8, spec_k=4, eos_id=eos), SPEC[:1], 40)[0]
    np.testing.assert_array_equal(got, want)


def test_engine_refusals_and_spec_rounding(tiny):
    with pytest.raises(ValueError, match="kv_dtype"):
        _port(tiny, kv_dtype="fp8")
    with pytest.raises(ValueError, match="tp"):
        _port(tiny, tp=3)
    eng = _port(tiny, spec_k=7, spec_ngram=1)
    assert eng.spec.k == 4 and eng.spec.min_ngram == 2
    assert _port(tiny).spec is None and _port(tiny).prefix is None


def test_prefix_block_other_than_the_pool_block_is_refused(tiny,
                                                          monkeypatch):
    """A paged store matches at the pool's block: ``prefix_block`` equal
    to it is served, another value (the dense store's granularity, not
    ported) is refused by the engine and by the serve role, never
    ignored."""
    from byteps_tpu_torch.common.config import reset_config
    from byteps_tpu_torch.serving.frontend import serve_from_env

    assert _port(tiny, prefix_cache=True, prefix_block=8).prefix.block == 8
    with pytest.raises(NotImplementedError, match="prefix_block"):
        _port(tiny, prefix_cache=True, prefix_block=4)
    for k, v in {"BYTEPS_SERVE_PAGED": "1", "BYTEPS_SERVE_BLOCK": "8",
                 "BYTEPS_SERVE_PREFIX_CACHE": "1",
                 "BYTEPS_SERVE_PREFIX_BLOCK": "4",
                 "BYTEPS_SERVE_MODEL": ",".join(
                     f"{k}={v}" for k, v in KW.items())}.items():
        monkeypatch.setenv(k, v)
    try:
        with pytest.raises(NotImplementedError, match="prefix_block"):
            serve_from_env(device="cpu", port=0, in_thread=True)
    finally:
        reset_config()


def test_spec_at_the_row_end_keeps_its_width(tiny8):
    """A request that runs to the last position of a row whose length is
    the model's ``max_seq_len`` (a learned position table): its verify
    spans run past the row's end at the same width, those rows are
    discarded, and the streams equal speculation off while a short
    neighbour decodes beside it."""
    prompts = [np.tile(SPEC[0], 4)[:22], SPEC[1]]
    eng = _port(tiny8, spec_k=4)
    widths = []
    fused = eng.model.decode_paged_fused

    def record(tokens, *a, **kw):
        widths.append(tokens.shape[1])
        return fused(tokens, *a, **kw)

    eng.model.decode_paged_fused = record
    got = _run(eng, prompts, 42)
    assert set(widths) == {5}
    _equal(got, _run(_port(tiny8), prompts, 42))
    assert eng.pool.alloc.used_count == 1        # the null block
    c = eng.step_counts()
    assert c["verify_ticks"] == c["decode_ticks"] > 0


# ------------------------------------------------------- blocks and store


def test_block_table_share_cow_and_adopt():
    alloc = BlockAllocator(8, 4)
    a, b = BlockTable(4), BlockTable(4)
    a.ensure(alloc, 2)
    b.share(alloc, a.blocks)
    assert alloc.shared_count() == 2 and alloc.refs(a.blocks[0]) == 2
    with pytest.raises(ValueError):
        b.share(alloc, a.blocks)
    old, new = b.cow(alloc, 1)
    assert old == a.blocks[1] and b.blocks[1] == new != old
    assert b.cow(alloc, 1) is None and alloc.shared_count() == 1
    b.release(alloc)
    a.release(alloc)
    assert alloc.used_count == 0
    from byteps_tpu_torch.serving.blocks import PagedSlotPool

    pool = PagedSlotPool(TransformerConfig(**KW), 2, 64, block=8,
                         device="cpu")
    slot = pool.assign(1, 4)
    ids = pool.alloc.alloc(2)
    pool.adopt_blocks(slot, ids)        # ownership transfer: no incref
    assert all(pool.alloc.refs(i) == 1 for i in ids)
    pool.free(slot)
    assert pool.alloc.used_count == 1


def _store_trace(alloc_cls, store_cls):
    """The JAX suite's radix sequences (tests/test_serving_kv_int8.py:
    chains never inserted as one entry; partial insert and leaf-only
    eviction), recorded as plain values."""
    out = []
    alloc = alloc_cls(32, 8)
    store = store_cls(alloc, block=8, block_bytes=100)
    toks = _toks(32, 5)
    a = alloc.alloc(2)
    out.append(store.insert_blocks(toks[:16], a))
    b = alloc.alloc(4)
    out.append(store.insert_blocks(toks, b))
    out += [store.entry_count, len(store._entries),
            [alloc.refs(i) for i in a + b]]
    entry, blen = store.match(np.concatenate([toks, _toks(3, 6)]))
    out += [blen, list(entry.buffer), store.hits]
    alloc = alloc_cls(32, 8)
    store = store_cls(alloc, block=8, block_bytes=100, max_bytes=200)
    toks = _toks(32, 9)
    ids = alloc.alloc(4)
    out += [store.insert_blocks(toks, ids), len(store._entries),
            store.total_bytes, alloc.refs(ids[2])]
    entry, blen = store.match(np.concatenate([toks, _toks(1, 0)]))
    out += [blen, list(entry.buffer)]
    out.append(store.insert_blocks(_toks(16, 11), alloc.alloc(2)))
    out.append(store.evictions)
    for e in store._entries:
        parent = store._node_parent[e.keys[0][0]]
        out.append(parent is None or parent in store._index)
    out += [store.evict_for(32), len(store._entries), alloc.used_count,
            store.insertable_len(toks), store.stats()]
    return out


def test_radix_store_matches_jax_store():
    """The same insert / match / evict sequences on the port's store and
    JAX's give the same answers: chains are never stored as one entry,
    a partial insert keeps the affordable prefix, eviction is leaf-only
    and drains to the callers' own references."""
    got = _store_trace(BlockAllocator, PagedPrefixCache)
    want = _store_trace(JaxBlockAllocator, JaxPagedPrefixCache)
    assert got == want
    assert got[2] == 1 and got[3] == 4     # one chain, four nodes


@pytest.mark.parametrize("k,ngram", [(1, 2), (4, 3), (8, 3), (4, 1)])
def test_ngram_proposer_matches_jax(k, ngram):
    rng = np.random.RandomState(k * 10 + ngram)
    mine, ref = NgramProposer(k, ngram), JaxNgramProposer(k, ngram)
    for _ in range(200):
        ctx = rng.randint(0, 6, size=(rng.randint(1, 40),)).astype(np.int32)
        cap = int(rng.randint(0, 10))
        assert mine.propose(ctx, cap) == ref.propose(ctx, cap)


def test_serve_role_shards_and_serves_every_tier(monkeypatch):
    """``BYTEPS_TP=2`` reaches the engine (its pool is sharded), and the
    int8 / prefix / spec knobs are read: two identical greedy requests
    from a JAX client come back identical, the second a prefix hit, and
    STATS carries the prefix store's and the pool's counts."""
    from byteps_tpu_torch.common.config import reset_config
    from byteps_tpu_torch.serving.frontend import serve_from_env

    for k, v in {"BYTEPS_SERVE_PAGED": "1", "BYTEPS_SERVE_BLOCK": "8",
                 "BYTEPS_SERVE_SLOTS": "2", "BYTEPS_TP": "2",
                 "BYTEPS_SERVE_KV_DTYPE": "int8",
                 "BYTEPS_SERVE_PREFIX_CACHE": "1", "BYTEPS_SERVE_SPEC": "1",
                 "BYTEPS_SERVE_SPEC_K": "2", "BYTEPS_SERVE_PREFIX_MB": "1",
                 "BYTEPS_SERVE_MODEL": ",".join(
                     f"{k}={v}" for k, v in KW8.items())}.items():
        monkeypatch.setenv(k, v)
    srv, thread = serve_from_env(device="cpu", port=0, in_thread=True)
    try:
        eng = srv.engine
        assert eng.tp == 2 and eng.pool.caches[0]["k"].shape[0] == 2
        assert eng.pool.caches[0]["k"].dtype == torch.int8
        assert eng.spec.k == 2 and eng.prefix.max_bytes == 1 << 20
        c = JaxRemoteServeClient(f"127.0.0.1:{srv.server_address[1]}",
                                 timeout=60, transport="tcp")
        p = SPEC[0].repeat(2)
        a, b = c.generate(p, 24), c.generate(p, 24)
        np.testing.assert_array_equal(a, b)
        st = c.stats()
        assert st["prefix_cache"]["hits"] == 1
        assert st["kv_blocks"]["n_blocks"] == eng.pool.alloc.n_blocks
        assert st["step_counts"]["verify_ticks"] > 0
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        reset_config()
    assert not thread.is_alive()


def test_spec_resume_tokens_continue_the_stream(tiny8):
    """A resume submit on a speculating engine (another engine emitted
    the first tokens): the resumed history feeds the proposer, and the
    continued stream equals the never-interrupted one, greedy and
    seeded."""
    for kw, seed in (({}, 0), ({"temperature": 0.8, "top_k": 5}, 77)):
        full = _run(_port(tiny8, spec_k=4, **kw), SPEC[:1], 40, [seed])[0]
        eng = _port(tiny8, spec_k=4, **kw)
        req = eng.submit(SPEC[0], 40, seed=seed,
                         resume_tokens=[int(t) for t in full[:5]])
        eng.drain(timeout=120)
        np.testing.assert_array_equal(req.result(), full)
        assert eng.metrics.get(sm.TOKENS) == 40 - 5
