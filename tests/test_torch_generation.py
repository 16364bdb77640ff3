"""Cached generation of the port (byteps_tpu_torch/inference.py
``generate`` / ``make_generate_fn`` over ``init_cache``'s flat and
grouped, fp and int8 caches, and ``quantize_params``) held against the
JAX package's ``make_generate_fn`` on the same weights and prompts.

A 2-layer Llama-shaped fp32 model (GQA 4 heads over 2 KV heads, rope
with llama3 scaling, swiglu, tied embeddings), initialised by JAX from a
seed and carried across with ``from_jax_params``.  Greedy tokens must be
identical: fp32 on both sides (the JAX CPU route sends a flat int8 cache
to the dense ``_cached_attention_q8``, which rounds scores to q's dtype —
a no-op in fp32 — where the port takes the decode kernel's plain
version).  Sampled streams draw from other generators in the two
packages, so they are held to repeat within the port only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu import inference as ji
from byteps_tpu.models import transformer as jt
from byteps_tpu_torch import inference as pi
from byteps_tpu_torch.models import transformer as pt
from byteps_tpu_torch.models.convert import from_jax_params
from byteps_tpu_torch.ops import decode_attention as da
from byteps_tpu_torch.ops import flash_attention as fa
from byteps_tpu_torch.ops import quant_dot as qd

SCALING = (("factor", 32.0), ("high_freq_factor", 4.0),
           ("low_freq_factor", 1.0), ("original_max_position_embeddings", 16),
           ("rope_type", "llama3"))
KW = dict(vocab_size=97, num_layers=2, num_heads=4, num_kv_heads=2,
          d_model=64, d_ff=128, max_seq_len=160, norm_eps=1e-5,
          pos_emb="rope", rope_theta=500000.0, rope_scaling=SCALING,
          mlp="swiglu", tie_embeddings=True)
NEW = 10


def _pair(attn_impl):
    jmodel = jt.Transformer(jt.TransformerConfig(
        dtype=jnp.float32, attn_impl=attn_impl, **KW))
    # jitted: flax's eager init compiles every op
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                     jnp.zeros((1, 8), jnp.int32))
    cfg = pt.TransformerConfig(dtype=torch.float32, attn_impl=attn_impl, **KW)
    model = pt.Transformer(cfg)
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables), cfg))
    return jmodel, variables, model


@pytest.fixture(scope="module")
def local():
    return _pair("local")


@pytest.fixture(scope="module")
def flash():
    return _pair("flash")


def _prompt(T, seed=0, B=2):
    return np.random.RandomState(seed).randint(0, KW["vocab_size"],
                                               size=(B, T)).astype(np.int32)


def _jax_generate(jmodel, variables, prompt, n=NEW, **kw):
    out = ji.make_generate_fn(jmodel, n, temperature=0, **kw)(
        variables, jnp.asarray(prompt), jax.random.PRNGKey(0))
    return np.asarray(out["tokens"]), np.asarray(out["done"])


def _port_generate(model, prompt, n=NEW, **kw):
    out = pi.generate(model, prompt, n, temperature=0, **kw)
    return out["tokens"].numpy(), out["done"].numpy()


@pytest.mark.parametrize("layout", ["grouped", "flat"])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_greedy_tokens_match_jax(local, layout, kv_quant):
    jmodel, variables, model = local
    prompt = _prompt(11)
    want = _jax_generate(jmodel, variables, prompt, kv_quant=kv_quant,
                         cache_layout=layout)
    plain = da.plain_calls
    got = _port_generate(model, prompt, kv_quant=kv_quant,
                         cache_layout=layout)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # a flat cache decodes every step through the kernel's wrapper
    steps = (NEW - 1) * KW["num_layers"]
    assert da.plain_calls - plain == (steps if layout == "flat" else 0)


def test_init_cache_layouts_and_refusals():
    cfg = pt.TransformerConfig(dtype=torch.bfloat16, **KW)
    flat = pt.init_cache(cfg, 3, 40, quantized=True, layout="flat")
    grouped = pt.init_cache(cfg, 3, 40, layout="grouped")
    assert len(flat) == len(grouped) == KW["num_layers"]
    assert flat[0]["k"].shape == (3, 40, 32) and flat[0]["k"].dtype == \
        torch.int8
    assert flat[0]["v_scale"].shape == (3, 40, 2)
    assert grouped[0]["v"].shape == (3, 40, 2, 16)
    assert grouped[0]["v"].dtype == torch.bfloat16
    # auto is grouped off the GPU, as JAX's is off its accelerator
    assert pt.init_cache(cfg, 3, 40)[0]["k"].ndim == 4
    with pytest.raises(ValueError, match="layout"):
        pt.init_cache(cfg, 3, 40, layout="paged")
    with pytest.raises(ValueError, match="max_seq_len"):
        pt.init_cache(cfg, 3, KW["max_seq_len"] + 1)


@pytest.mark.parametrize("layout", ["grouped", "flat"])
def test_quantize_params_greedy_tokens_match_jax(local, layout):
    jmodel, variables, model = local
    prompt = _prompt(9, seed=3)
    want = _jax_generate(jmodel, ji.quantize_params(variables), prompt,
                         cache_layout=layout)
    qmodel = pi.quantize_params(model, inplace=False)
    assert model.blocks[0].attn.q.weight.dtype == torch.float32
    plain = qd.plain_calls
    got = _port_generate(qmodel, prompt, cache_layout=layout)
    np.testing.assert_array_equal(got[0], want[0])
    # 7 projections per layer per forward (the head is the tied table)
    assert qd.plain_calls - plain == NEW * 7 * KW["num_layers"]


def test_converted_quantized_tree_generates_as_jax(local):
    """The JAX int8 tree carried through ``from_jax_params`` into a model
    quantized first."""
    jmodel, variables, model = local
    qvars = ji.quantize_params(variables)
    prompt = _prompt(13, seed=4)
    want = _jax_generate(jmodel, qvars, prompt, kv_quant=True,
                         cache_layout="flat")
    cfg = model.cfg
    qmodel = pi.quantize_params(pt.Transformer(cfg))
    qmodel.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, qvars), cfg), strict=True)
    got = _port_generate(qmodel, prompt, kv_quant=True, cache_layout="flat")
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("T,layout,gate", [(128, "flat", True),
                                           (10, "grouped", False)])
def test_flash_prefill_greedy_tokens_match_jax(flash, T, layout, gate):
    """``attn_impl="flash"``: a prompt passing the gcd gate prefills
    through the flash forward, one failing it takes the dense path."""
    jmodel, variables, model = flash
    prompt = _prompt(T, seed=5)
    want = _jax_generate(jmodel, variables, prompt, n=6,
                         cache_layout=layout)
    plain = fa.plain_calls
    got = _port_generate(model, prompt, n=6, cache_layout=layout)
    np.testing.assert_array_equal(got[0], want[0])
    assert fa.plain_calls - plain == (KW["num_layers"] if gate else 0)


def test_eos_freezes_a_row_as_jax(local):
    jmodel, variables, model = local
    prompt = _prompt(11, seed=6)
    free = _port_generate(model, prompt)[0]
    eos = int(free[0, 2])           # row 0 stops at its third token
    want = _jax_generate(jmodel, variables, prompt, eos_id=eos, pad_id=5)
    got = _port_generate(model, prompt, eos_id=eos, pad_id=5)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1][0] and (got[0][0, 3:] == 5).all()


def test_cache_len_guard_and_longer_cache(local):
    jmodel, variables, model = local
    prompt = _prompt(11, seed=7)
    with pytest.raises(ValueError, match="cache_len"):
        pi.generate(model, prompt, NEW, temperature=0, cache_len=11 + NEW - 1)
    want = _jax_generate(jmodel, variables, prompt, cache_len=64,
                         cache_layout="flat")
    got = _port_generate(model, prompt, cache_len=64, cache_layout="flat")
    np.testing.assert_array_equal(got[0], want[0])
    noncausal = pt.Transformer(pt.TransformerConfig(
        dtype=torch.float32, causal=False, **KW))
    with pytest.raises(ValueError, match="causal"):
        pi.generate(noncausal, prompt, 2, temperature=0)


def test_seeded_sampling_repeats_and_needs_a_seed(local):
    _, _, model = local
    prompt = _prompt(11, seed=8)
    kw = dict(temperature=0.8, top_k=50, top_p=0.95)
    fn = pi.make_generate_fn(model, NEW, cache_layout="flat", **kw)
    a, b, c = fn(prompt, 11), fn(prompt, 11), fn(prompt, 12)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (2, NEW)
    with pytest.raises(ValueError, match="seed"):
        fn(prompt)
    with pytest.raises(ValueError, match="seed"):
        pi.generate(model, prompt, NEW, **kw)


def _verdict(res):
    return {k: res[k] for k in ("divergence", "first_div_pos",
                                "first_div_positions", "div_frac_by_quarter")}


def test_classify_divergence_gives_jax_verdicts(local):
    """The cases of tests/test_generation.py: identical decodes, a
    runner-up flip under a generous threshold, a worst-token flip under a
    tight one, and the late-churn / early-cliff position profiles."""
    jmodel, variables, model = local
    prompt = _prompt(6, seed=3)
    toks = _port_generate(model, prompt, n=8)[0]
    full = np.concatenate([prompt, toks], axis=1)
    logits = model(torch.from_numpy(full).long()).detach().numpy()
    order = np.argsort(logits[0, 6 + 4 - 1])[::-1]
    tie_b, bug_b = toks.copy(), toks.copy()
    tie_b[0, 4] = order[1] if order[0] == toks[0, 4] else order[0]
    bug_b[0, 4] = order[-1]
    base = np.random.RandomState(9).randint(0, 50, size=(2, 16))
    churn, cliff, mix = base.copy(), base.copy(), base.copy()
    churn[0, 12:] = (churn[0, 12:] + 1) % 50
    churn[1, 14:] = (churn[1, 14:] + 1) % 50
    cliff[:, 1:] = (cliff[:, 1:] + 1) % 50
    mix[0, 5:] = (mix[0, 5:] + 3) % 50
    cases = [(prompt, toks, toks, {}), (prompt, toks, tie_b,
                                        {"tie_rtol": 10.0}),
             (prompt, toks, bug_b, {"tie_rtol": 0.0, "tie_atol": 1e-6}),
             (prompt[:, :4], base, churn, {}), (prompt[:, :4], base, cliff, {}),
             (prompt[:, :4], base, mix, {})]
    kinds = []
    for p, a, b, kw in cases:
        want = ji.classify_divergence(jmodel, variables, jnp.asarray(p), a, b,
                                      **kw)
        got = pi.classify_divergence(model, p, a, b, **kw)
        assert _verdict(got) == _verdict(want)
        assert got["agreement"] == pytest.approx(want["agreement"])
        assert got["delta_logit"] == pytest.approx(want["delta_logit"],
                                                   abs=2e-4)
        kinds.append(got["divergence"])
    assert kinds[:3] == ["none", "tie", "real"]
