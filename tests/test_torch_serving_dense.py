"""The port's dense slot engine (``ServingEngine(paged=False)``, the serve
role's default) held against the JAX dense engine on the same converted
weights and numpy prompts.

Greedy streams must be token-identical to the JAX ``ServingEngine`` with
the same options, request by request, and (where the JAX tests hold it)
to JAX ``inference.generate``: grouped and flat rows, ``kv_quant``,
whole-prompt and chunked prefill (``chunk=8``), staggered arrivals and
the credit interleave, EOS, cancellation, the bounded queue.  The JAX
dense engine runs its flat layout on the CPU (its decode kernel in
interpret mode, an int8 flat cache through the dense
``_cached_attention_q8``), so the flat cases use it as their reference
too.  The port's flat rows decode through the decode kernel's wrapper,
whose plain version runs here, one call a layer a tick for every slot.

Also: a ``PREFILLING`` slot rides the decode ticks without its written
chunks being touched (its garbage write lands at its post-prefill
cursor); JAX's refusals raise in both packages with JAX's messages; the
dense engine's features that are not ported yet are refused by name; and
``serve_from_env`` without ``BYTEPS_SERVE_PAGED`` serves the dense
engine.

Two fp32 models: the JAX serving tests' tiny one (learned positions,
MHA, head_dim 16) and a Llama-shaped one (rope with llama3 scaling, GQA
4 heads over 2 KV heads, swiglu, tied embeddings), each initialised by
JAX from a seed and carried across with ``from_jax_params``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.inference import generate
from byteps_tpu.models.transformer import Transformer as JaxTransformer
from byteps_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from byteps_tpu.serving import RemoteServeClient as JaxRemoteServeClient
from byteps_tpu.serving import ServeMetrics as JaxServeMetrics
from byteps_tpu.serving import ServingEngine as JaxServingEngine
from byteps_tpu_torch.models.convert import from_jax_params
from byteps_tpu_torch.models.transformer import Transformer, TransformerConfig
from byteps_tpu_torch.ops import decode_attention as da
from byteps_tpu_torch.serving import (QueueFullError, RequestState,
                                      ServeMetrics, ServingEngine)
from byteps_tpu_torch.serving import metrics as sm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Thousands of tiny torch ops beside other test workers: one
    intra-op thread each keeps them from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


M = 8
TINY = dict(vocab_size=61, num_layers=2, num_heads=2, d_model=32, d_ff=64,
            max_seq_len=64)
SCALING = (("factor", 32.0), ("high_freq_factor", 4.0),
           ("low_freq_factor", 1.0), ("original_max_position_embeddings", 16),
           ("rope_type", "llama3"))
LLAMA = dict(vocab_size=97, num_layers=2, num_heads=4, num_kv_heads=2,
             d_model=64, d_ff=128, max_seq_len=64, norm_eps=1e-5,
             pos_emb="rope", rope_theta=500000.0, rope_scaling=SCALING,
             mlp="swiglu", tie_embeddings=True)


def _pair(kw):
    jmodel = JaxTransformer(JaxTransformerConfig(dtype=jnp.float32, **kw))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                     jnp.zeros((1, 8), jnp.int32))
    cfg = TransformerConfig(dtype=torch.float32, **kw)
    state = from_jax_params(jax.tree_util.tree_map(np.asarray, variables),
                            cfg)
    return jmodel, variables, cfg, state


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY)


@pytest.fixture(scope="module")
def llama():
    return _pair(LLAMA)


def _model(pair):
    _, _, cfg, state = pair
    model = Transformer(cfg)
    model.load_state_dict(state)
    return model


def _prompts(lengths, vocab=61, seed=10):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=(n,)).astype(np.int32)
            for n in lengths]


def _port(pair, **kw):
    kw.setdefault("n_slots", 4)
    return ServingEngine(_model(pair), max_seq=64, device="cpu",
                         metrics=ServeMetrics(), **kw)


def _jax(pair, **kw):
    jmodel, variables, _, _ = pair
    kw.setdefault("n_slots", 4)
    return JaxServingEngine(jmodel, variables, max_seq=64, temperature=0.0,
                            metrics=JaxServeMetrics(), **kw)


def _run(eng, prompts, m=M):
    reqs = [eng.submit(p, m) for p in prompts]
    eng.drain(timeout=60)
    return [r.result() for r in reqs]


@pytest.fixture(scope="module")
def tiny_base(tiny):
    """JAX generate() and the JAX dense engine on the tiny model."""
    jmodel, variables, _, _ = tiny
    prompts = _prompts((5, 6, 7, 8))
    gen = [np.asarray(generate(jmodel, variables, p[None], M,
                               temperature=0.0)["tokens"])[0]
           for p in prompts]
    eng = _run(_jax(tiny), prompts)
    for g, e in zip(gen, eng):
        np.testing.assert_array_equal(g, e)
    return prompts, gen


def test_credit_interleave_then_greedy_parity(tiny, tiny_base):
    """A one-bucket credit budget admits one request a tick while decode
    runs every tick; the four streams equal JAX generate() (and the JAX
    dense engine, which the fixture holds to it)."""
    prompts, want = tiny_base
    eng = _port(tiny, prefill_credits=8)
    reqs = [eng.submit(p, M) for p in prompts]
    s1 = eng.step()
    assert s1["admitted"] == 1 and s1["active"] == 1
    s2 = eng.step()
    assert s2["admitted"] == 1 and s2["active"] == 2
    eng.drain(timeout=60)
    for r, w in zip(reqs, want):
        np.testing.assert_array_equal(r.result(), w)
    assert not eng.paged and eng.pool.layout == "grouped"
    counts = eng.step_counts()
    assert counts["decode_ticks"] == eng.metrics.get(sm.DECODE_TICKS) > 0
    assert counts["prefill_chunks"] == 4     # one whole-prompt forward each
    assert eng.pool.free_count == 4


def test_staggered_arrivals_match_jax(tiny, tiny_base):
    """Requests admitted while others decode match their sequential
    baselines: the batch's makeup cannot leak into a slot."""
    prompts, want = tiny_base
    eng = _port(tiny)
    r0 = eng.submit(prompts[0], M)
    eng.step()
    r1 = eng.submit(prompts[1], M)
    eng.step()
    eng.step()
    r2 = eng.submit(prompts[2], M)
    eng.drain(timeout=60)
    for r, w in zip((r0, r1, r2), want):
        np.testing.assert_array_equal(r.result(), w)


@pytest.mark.parametrize("layout,kv_quant", [("grouped", False),
                                             ("flat", False),
                                             ("grouped", True),
                                             ("flat", True)])
def test_layouts_and_int8_rows_match_the_jax_engine(llama, layout, kv_quant):
    """The Llama-shaped model (per-row rope, GQA) on grouped and flat rows,
    fp and int8: token-identical to the JAX dense engine with the same
    options.  Flat rows decode through the decode kernel's wrapper — one
    call a layer a tick for every slot, at a position vector."""
    prompts = _prompts((3, 9, 17, 30), vocab=97, seed=4)
    want = _run(_jax(llama, cache_layout=layout, kv_quant=kv_quant),
                prompts)
    eng = _port(llama, cache_layout=layout, kv_quant=kv_quant)
    plain = da.plain_calls
    got = _run(eng, prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    k = eng.pool.caches[0]["k"]
    assert k.dtype == (torch.int8 if kv_quant else torch.float32)
    assert k.ndim == (3 if layout == "flat" else 4)
    ticks = eng.step_counts()["decode_ticks"]
    assert da.plain_calls - plain == (
        ticks * LLAMA["num_layers"] if layout == "flat" else 0)


def test_chunked_prefill_matches_jax_and_generate(tiny):
    """Prompts spanning several 8-token chunks (and a sub-chunk one)
    equal JAX generate() and the JAX chunked engine."""
    jmodel, variables, _, _ = tiny
    prompts = _prompts((5, 20, 33), seed=20)
    want = [np.asarray(generate(jmodel, variables, p[None], M,
                                temperature=0.0)["tokens"])[0]
            for p in prompts]
    jgot = _run(_jax(tiny, n_slots=3, chunk=8), prompts)
    eng = _port(tiny, n_slots=3, chunk=8)
    got = _run(eng, prompts)
    for g, j, w in zip(got, jgot, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(j, w)
    assert eng.chunk == 8
    assert eng.step_counts()["prefill_chunks"] == 1 + 3 + 5
    assert eng.metrics.get(sm.PREFILL_CHUNKS) == 9


def test_prefilling_slot_survives_decode_ticks(tiny):
    """A long prompt prefills 8 tokens a tick while a short request
    decodes every tick; the decode pass runs over the PREFILLING slot's
    row too, and its garbage write lands at the post-prefill cursor: the
    chunks it has written stay bit-identical from tick to tick, and when
    its prefill completes its rows are bit-identical to those of the same
    prompt prefilled alone (no decode tick beside it); both streams equal
    JAX generate() (the JAX engine's bound: no tick's prefill exceeds the
    budget)."""
    jmodel, variables, _, _ = tiny
    short, longp = _prompts((5, 62), seed=30)
    T = longp.shape[0]
    solo = _port(tiny, n_slots=1, chunk=8)
    alone = solo.submit(longp, 2)
    solo.drain(timeout=60)
    want_rows = [{n: c[0, :T].clone() for n, c in layer.items()}
                 for layer in solo.pool.caches]
    eng = _port(tiny, n_slots=2, chunk=8)
    r0 = eng.submit(short, 6)
    eng.step()
    r1 = eng.submit(longp, 2)
    ticks = 0
    written = slot = None
    while not r1.done:
        st = eng.step()
        ticks += 1
        assert st["prefill_tokens"] <= 8, st
        if not r0.done:
            assert st["emitted"] >= 1, st   # decode never stalls
        if r1.state is RequestState.PREFILLING:
            slot = r1.slot
            row = eng.pool.caches[0]["k"][slot]
            if written is not None:
                n = written.shape[0]
                assert torch.equal(row[:n], written), ticks
            written = row[:r1.prefill_pos].clone()
            # the cursor the garbage aims at lies past every written chunk
            assert eng.pool.pos[slot] == T >= r1.prefill_pos
        assert ticks < 64
    # the tick that finished the prefill decoded at T: rows [0, T) are
    # the prefill's alone
    for layer, want in zip(eng.pool.caches, want_rows):
        for n, c in layer.items():
            assert torch.equal(c[slot, :T], want[n]), n
    np.testing.assert_array_equal(r1.result(), alone.result())
    assert ticks >= 62 // 8
    eng.drain(timeout=60)
    np.testing.assert_array_equal(r0.result(), np.asarray(generate(
        jmodel, variables, short[None], 6, temperature=0.0)["tokens"])[0])
    np.testing.assert_array_equal(r1.result(), np.asarray(generate(
        jmodel, variables, longp[None], 2, temperature=0.0)["tokens"])[0])


def test_eos_stops_early_and_frees_slot(tiny, tiny_base):
    prompts, want = tiny_base
    eos = int(want[0][3])
    eng = _port(tiny, n_slots=1, eos_id=eos)
    got = _run(eng, prompts[:1])[0]
    np.testing.assert_array_equal(got, want[0][:4])
    assert eng.pool.free_count == 1
    r1 = eng.submit(prompts[1], 1)   # retires at its prefill token
    eng.drain(timeout=60)
    assert len(r1.result()) == 1


def test_cancel_queued_and_active(tiny, tiny_base):
    prompts, _ = tiny_base
    eng = _port(tiny, prefill_credits=8)
    r0 = eng.submit(prompts[0], 32)
    eng.step()
    r1 = eng.submit(prompts[1], 32)
    eng.cancel(r0)
    eng.cancel(r1)
    eng.drain(timeout=60)
    assert r0.state is RequestState.CANCELLED
    assert r1.state is RequestState.CANCELLED
    assert r0.tokens and not r1.tokens
    assert eng.pool.free_count == eng.pool.n_slots
    assert eng.metrics.get(sm.CANCELLED) == 2
    # mid-prefill: the slot frees and the credits return
    eng = _port(tiny, n_slots=1, chunk=8)
    r = eng.submit(_prompts((40,), seed=33)[0], 4)
    eng.step()
    assert r.state is RequestState.PREFILLING
    eng.cancel(r)
    eng.step()
    assert r.done and r.state is RequestState.CANCELLED and not r.tokens
    assert eng.pool.free_count == 1
    assert eng.scheduler.credits == eng.scheduler.credit_budget


def test_admission_queue_full_typed_rejection(tiny, tiny_base):
    prompts, _ = tiny_base
    eng = _port(tiny, n_slots=1, max_queue=1)
    eng.submit(prompts[0], 2)
    with pytest.raises(QueueFullError, match="queue full"):
        eng.submit(prompts[0], 2)
    assert eng.metrics.get(sm.REJECTED) == 1
    with pytest.raises(ValueError):
        eng.submit(prompts[0], 100)
    with pytest.raises(ValueError):
        eng.submit(np.zeros((0,), np.int32), 2)
    with pytest.raises(ValueError, match="max_seq_len"):
        ServingEngine(_model(tiny), n_slots=1, max_seq=128, device="cpu")


def _refusals(flash_pair):
    """(pair, kwargs, error, match) the JAX engine refuses, in both
    packages' words."""
    return [
        (None, dict(kv_quant=True, chunk=8), ValueError, "dense KV cache"),
        (None, dict(kv_quant=True, prefix_cache=True), ValueError,
         "dense KV cache"),
        (None, dict(kv_quant=True, paged=True, block=8), ValueError,
         "dense KV cache"),
        (flash_pair, dict(chunk=8), ValueError, "dense prefill path"),
        (flash_pair, dict(prefix_cache=True), ValueError,
         "dense prefill path"),
        (flash_pair, dict(paged=True, block=8, paged_kernel="on"),
         ValueError, "dense prefill path"),
        (None, dict(paged=True, block=8, paged_kernel="off",
                    cache_layout="flat"), ValueError,
         "requires the fused paged-attention kernel"),
        (None, dict(kv_dtype="int8"), ValueError, "requires paged=True"),
        (None, dict(kv_dtype="int8", kv_quant=True, paged=True, block=8),
         ValueError, "mutually exclusive"),
        (None, dict(spec_k=2, kv_quant=True), ValueError,
         "dense fp KV cache"),
        (None, dict(spec_k=2, cache_layout="flat"), ValueError,
         "cache_layout='grouped'"),
        (None, dict(tp=2), ValueError, "requires paged=True"),
    ]


def test_jax_refusals_raise_in_both_packages(tiny):
    jmodel, variables, _, _ = tiny
    flash = _pair(dict(TINY, max_seq_len=256, attn_impl="flash"))
    for pair, kw, err, match in _refusals(flash):
        pair = pair or tiny
        max_seq = 256 if pair is flash else 64
        with pytest.raises(err, match=match):
            JaxServingEngine(pair[0], pair[1], n_slots=2, max_seq=max_seq,
                             metrics=JaxServeMetrics(), **kw)
        with pytest.raises(err, match=match):
            ServingEngine(_model(pair), n_slots=2, max_seq=max_seq,
                          device="cpu", metrics=ServeMetrics(), **kw)
    # no bucket below 128 passes the gcd gate: a small flash engine chunks
    eng = ServingEngine(_model(flash), n_slots=2, max_seq=64, chunk=8,
                        device="cpu")
    assert eng.chunk == 8
    # kv_quant alone stays constructible, but resumes no request
    eng, jeng = _port(tiny, kv_quant=True), _jax(tiny, kv_quant=True)
    assert eng.prefix is None
    for e in (eng, jeng):
        with pytest.raises(ValueError, match="cannot resume"):
            e.submit(_prompts((6,))[0], 4, resume_tokens=[3, 5])


def test_unported_dense_features_are_refused_by_name(tiny, tiny_base):
    """What the dense slice once refused by name is served now: the dense
    engine's row-copy prefix store and its speculative verify, and a
    paged engine's gather fallback (``paged_kernel="off"``) — each
    built, and serving the JAX dense engine's streams (the fixture holds
    them to JAX ``generate()``).  The paged engine keeps both tiers."""
    prompts, want = tiny_base
    for kw in (dict(prefix_cache=True), dict(spec_k=4),
               dict(paged=True, block=8, paged_kernel="off")):
        eng = _port(tiny, **kw)
        for g, w in zip(_run(eng, prompts), want):
            np.testing.assert_array_equal(g, w)
    assert eng.paged and not eng.paged_kernel
    assert eng.pool.caches[0]["k"].shape[1:] == (8, 2, 16)   # grouped
    eng = _port(tiny, paged=True, block=8, prefix_cache=True, spec_k=2)
    assert eng.prefix is not None and eng.spec is not None


def test_serve_from_env_without_paged_serves_the_dense_engine(
        monkeypatch, tiny):
    """The serve role's defaults build the dense engine (grouped rows, as
    in JAX), which answers a JAX client, greedy reruns identical and
    equal to the same model driven in-process; the dense engine's prefix
    store and speculation knobs, and the paged gather's, build engines
    that serve the same tokens."""
    from byteps_tpu_torch.common.config import reset_config
    from byteps_tpu_torch.serving.frontend import serve_from_env

    monkeypatch.delenv("BYTEPS_SERVE_PAGED", raising=False)
    monkeypatch.setenv("BYTEPS_SERVE_SLOTS", "2")
    monkeypatch.setenv("BYTEPS_SERVE_MODEL",
                       ",".join(f"{k}={v}" for k, v in TINY.items()))
    srv, thread = serve_from_env(device="cpu", port=0, in_thread=True)
    try:
        eng = srv.engine
        assert not eng.paged and eng.pool.layout == "grouped"
        c = JaxRemoteServeClient(f"127.0.0.1:{srv.server_address[1]}",
                                 timeout=60, transport="tcp")
        p = _prompts((6,))[0]
        a, b = c.generate(p, M), c.generate(p, M)
        st = c.stats()
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        reset_config()
    np.testing.assert_array_equal(a, b)
    assert a.shape == (M,)
    assert st["device"] == "cpu" and st["kv_blocks"] is None
    assert st["step_counts"]["decode_ticks"] > 0
    # the role's model driven in-process gives the tokens the wire gave
    again = ServingEngine(eng.model, n_slots=2, max_seq=64, device="cpu",
                          metrics=ServeMetrics())
    np.testing.assert_array_equal(_run(again, [p])[0], a)
    for knobs in ({"BYTEPS_SERVE_PREFIX_CACHE": "1",
                   "BYTEPS_SERVE_PREFIX_BLOCK": "4"},
                  {"BYTEPS_SERVE_SPEC": "1"},
                  {"BYTEPS_SERVE_PAGED": "1", "BYTEPS_SERVE_BLOCK": "8",
                   "BYTEPS_SERVE_PAGED_KERNEL": "off"}):
        for k, v in knobs.items():
            monkeypatch.setenv(k, v)
        srv, thread = serve_from_env(device="cpu", port=0, in_thread=True)
        try:
            eng = srv.engine
            c = JaxRemoteServeClient(f"127.0.0.1:{srv.server_address[1]}",
                                     timeout=60, transport="tcp")
            np.testing.assert_array_equal(c.generate(p, M), a)
            st = c.stats()
            c.close()
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=10)
            reset_config()
        assert ((eng.prefix is not None and eng.prefix.block == 4)
                or eng.spec is not None
                or (eng.paged and not eng.paged_kernel)), knobs
        if eng.prefix is not None:   # the dense store's STATS, as JAX's
            assert set(st["prefix_cache"]) == {
                "hits", "misses", "insertions", "evictions", "entries",
                "bytes"}
            assert st["step_counts"]["prefix_extracts"] == 1
        for k in knobs:
            monkeypatch.delenv(k)


@pytest.mark.parametrize("knob", [("--kv-dtype", "int8"), ("--tp", "2"),
                                  ("--paged-kernel", "off")])
@pytest.mark.parametrize("layout", ["flat", "grouped"])
def test_serve_profile_refuses_paged_knobs_on_the_dense_engine(layout, knob):
    """``scripts/torch_serve_profile.py --dense`` refuses the paged
    engine's knobs (argparse, before any device is touched) instead of
    ignoring them.  (``--spec-k``, once among them, is the dense grouped
    engine's too now: see the next test.)"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, os.path.join(root, "scripts",
                                      "torch_serve_profile.py"),
         "--dense", layout, *knob], capture_output=True, text=True,
        timeout=60)
    assert r.returncode == 2, r.stderr
    assert "the dense engine takes none of them" in r.stderr


def test_serve_profile_takes_prefix_and_spec_on_dense_grouped_rows():
    """``--dense grouped --prefix --spec-k 4`` gets past the argument
    checks (and, with no GPU here, stops at the device check), while
    ``--spec-k`` on flat rows is refused, as the engine refuses it."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "scripts", "torch_serve_profile.py")
    r = subprocess.run([sys.executable, script, "--dense", "grouped",
                        "--prefix", "--spec-k", "4"], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 1 and "needs a CUDA device" in r.stderr, r.stderr
    r = subprocess.run([sys.executable, script, "--dense", "flat",
                        "--spec-k", "4"], capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 2 and "needs grouped rows" in r.stderr, r.stderr
