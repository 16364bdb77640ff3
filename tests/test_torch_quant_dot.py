"""The int8 weight-only product of the port (byteps_tpu_torch/ops/
quant_dot.py) and ``quantize_params`` held against the JAX package on
the same numpy inputs: ``QuantDense`` applied to a quantized tree, the
probe kernel ``scripts/dot_probe.py:27`` run through ``pl.pallas_call``
in interpret mode, and ``inference.quantize_params``.

Tolerances: the int8 values and scales are bit-equal (the same fp32
arithmetic, rounding half to even).  The products are held within one
bf16 ulp of the largest output (``2**-7`` of it) in bf16 — both sides
round at the same points but sum the fp32 products in other orders, and
the probe kernel rounds once where ``QuantDense`` rounds twice — and
within 1e-6 of the largest output in fp32.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from byteps_tpu.inference import quantize_params as jax_quantize_params
from byteps_tpu.models import transformer as jt
from byteps_tpu_torch.inference import quantize_params
from byteps_tpu_torch.models import transformer as pt
from byteps_tpu_torch.models.convert import from_jax_params
from byteps_tpu_torch.ops import quant_dot as qd

BF16_ULP = 2.0 ** -7
SCALING = (("factor", 32.0), ("high_freq_factor", 4.0),
           ("low_freq_factor", 1.0), ("original_max_position_embeddings", 16),
           ("rope_type", "llama3"))
CONFIGS = {
    "llama_untied": dict(vocab_size=97, num_layers=2, num_heads=4,
                         num_kv_heads=2, d_model=64, d_ff=128, max_seq_len=64,
                         pos_emb="rope", rope_scaling=SCALING, mlp="swiglu"),
    "gpt2": dict(vocab_size=97, num_layers=1, num_heads=4, d_model=64,
                 d_ff=128, max_seq_len=64, norm="layernorm", use_bias=True,
                 mlp="gelu", pos_emb="learned"),
}


def _assert_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = (BF16_ULP if dtype == jnp.bfloat16 else 1e-6) * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_quantize_params_is_bit_equal_to_jax(name):
    kw = CONFIGS[name]
    jmodel = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **kw))
    # a jitted init (flax's eager init compiles every op); the quantizer
    # eager, as it is called (under jit XLA turns absmax / 127 into a
    # multiply by 1/127, which moves scales by an ulp)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(4),
                                     jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables)
    cfg = pt.TransformerConfig(dtype=torch.float32, **kw)
    model = pt.Transformer(cfg)
    model.load_state_dict(from_jax_params(params, cfg))
    quantize_params(model)
    qtree = jax.tree_util.tree_map(np.asarray, jax_quantize_params(variables))
    want = from_jax_params(qtree, cfg)   # the JAX int8 tree, re-laid out
    got = model.state_dict()
    assert set(got) == set(want)
    n_int8 = 0
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k
        n_int8 += v.dtype == torch.int8
    # q k v o + the MLP per block, and the untied head
    per_block = 4 + (3 if kw["mlp"] == "swiglu" else 2)
    assert n_int8 == kw["num_layers"] * per_block + (
        0 if kw.get("tie_embeddings") else 1)


@pytest.mark.parametrize("dtype,accum", [(jnp.bfloat16, None),
                                         (jnp.bfloat16, jnp.float32),
                                         (jnp.float32, None)])
@pytest.mark.parametrize("M,K,N", [(8, 64, 96), (37, 200, 48)])
def test_plain_quant_linear_matches_quant_dense(dtype, accum, M, K, N):
    rng = np.random.RandomState(M + K)
    x = rng.randn(M, K).astype(np.float32)
    layer = jt.QuantDense(features=N, dtype=dtype, accum_dtype=accum,
                          use_bias=True)
    params = jax.jit(layer.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(x))["params"]
    params = dict(params, bias=jnp.asarray(rng.randn(N).astype(np.float32)))
    qp = jax.jit(jax_quantize_params)({"params": params})["params"]
    want = layer.apply({"params": qp}, jnp.asarray(x, dtype))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    out_dt = torch.float32 if accum is not None else tdt
    got = qd.quant_linear(
        torch.from_numpy(x).to(tdt),
        torch.from_numpy(np.array(qp["kernel"]).T.copy()),
        torch.from_numpy(np.array(qp["scale"])),
        torch.from_numpy(np.array(qp["bias"])), out_dt)
    assert got.dtype == out_dt
    _assert_close(got.float().numpy(), want, dtype)


def _probe_kernel(x_ref, w_ref, s_ref, o_ref):
    # scripts/dot_probe.py:27-30 quant_dot_kernel, kept here: importing
    # the script runs its benchmark at module level
    w = w_ref[...].astype(jnp.bfloat16)
    acc = jnp.dot(x_ref[...], w, preferred_element_type=jnp.float32)
    o_ref[...] = (acc * s_ref[...].astype(jnp.float32)).astype(o_ref.dtype)


@functools.partial(jax.jit, static_argnames=("bn",))
def _probe(x, w, s, bn=512):
    (M, K), N = x.shape, w.shape[1]
    return pl.pallas_call(
        _probe_kernel, grid=(N // bn,),
        in_specs=[pl.BlockSpec((M, K), lambda i: (0, 0)),
                  pl.BlockSpec((K, bn), lambda i: (0, i)),
                  pl.BlockSpec((1, bn), lambda i: (0, i))],
        out_specs=pl.BlockSpec((M, bn), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.bfloat16),
        interpret=True)(x, w, s)


def test_plain_quant_linear_matches_the_probe_kernel():
    """The probe's shapes (x [8, 768] . W [768, 3072]); the port rounds as
    QuantDense, the probe once: within one bf16 ulp of the largest
    output."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 768).astype(np.float32)
    wf = rng.randn(3072, 768).astype(np.float32)
    w, scale = qd.quantize_weight(torch.from_numpy(wf))
    want = _probe(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w.numpy().T),
                  jnp.asarray(scale.numpy()[None, :]))
    got = qd.quant_linear(torch.from_numpy(x).to(torch.bfloat16), w, scale)
    _assert_close(got.float().numpy(), want, jnp.bfloat16)


def test_quantized_dense_runs_the_plain_version_on_cpu():
    layer = pt.Dense(24, 40, True, torch.bfloat16, torch.float32)
    torch.manual_seed(0)
    x = torch.randn(3, 5, 24)
    before = layer(x)
    layer.quantize()
    assert layer.quantized and layer.weight.dtype == torch.int8
    assert not layer.weight.requires_grad
    assert set(layer.state_dict()) == {"weight", "bias", "scale"}
    launches, plain = qd.launches, qd.plain_calls
    after = layer(x)
    assert (qd.launches, qd.plain_calls) == (launches, plain + 1)
    assert after.shape == (3, 5, 40) and after.dtype == torch.bfloat16
    # int8 weights: within the quantization error of the float product
    err = (after.float() - before.float()).abs().max()
    assert err <= 0.05 * before.float().abs().max()
    with pytest.raises(ValueError, match="int8"):
        qd.quant_linear(x, layer.weight.float(), layer.scale)
    with pytest.raises(ValueError, match="out_dtype"):
        qd.quant_linear(x, layer.weight, layer.scale,
                        out_dtype=torch.float16)
