"""The int8 weight-only product of the port (byteps_tpu_torch/ops/
quant_dot.py) and ``quantize_params`` held against the JAX package on
the same numpy inputs: ``QuantDense`` applied to a quantized tree, the
probe kernel ``scripts/dot_probe.py:27`` run through ``pl.pallas_call``
in interpret mode, and ``inference.quantize_params``.

The CUDA wrapper's choices, as pure functions of the shapes: the rule
among the three designs (``_design``: swap up to 64 bf16 rows, tma above,
the tile design for fp32 x and the shapes neither describes), the swap
design's split plan (``_swap_plan``), and the launches a call is held to,
through a stand-in for the CUDA library that applies the C rule.

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
@pytest.mark.parametrize("M,K,N", [(8, 64, 96), (37, 200, 48), (1, 64, 96),
                                   (16, 64, 96), (40, 64, 96), (64, 64, 96),
                                   (65, 64, 96), (300, 64, 96)])
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


BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,M,N,K,ptrs,want", [
    (F32, 8, 2048, 2048, (0, 0, 0), qd.TILE),      # fp32 x: the tile
    (F32, 15360, 2048, 2048, (0, 0, 0), qd.TILE),
    (BF, 1, 2048, 2048, (0, 0, 0), qd.SWAP),
    (BF, 8, 512, 2048, (0, 0, 0), qd.SWAP),
    (BF, 64, 8192, 2048, (0, 0, 0), qd.SWAP),      # the last swap row count
    (BF, 65, 8192, 2048, (0, 0, 0), qd.TMA),       # the first tma one
    (BF, 15360, 2048, 8192, (0, 0, 0), qd.TMA),
    (BF, 8, 1001, 2048, (0, 0, 0), qd.SWAP),       # swap takes any N
    (BF, 300, 1001, 2048, (0, 0, 0), qd.TILE),     # tma's stores: N % 8
    (BF, 8, 96, 40, (0, 0, 0), qd.TILE),           # K % 16 != 0
    (BF, 300, 96, 40, (0, 0, 0), qd.TILE),
    (BF, 8, 2048, 2048, (0, 33, 0), qd.TILE),      # W base unaligned
    (BF, 300, 2048, 2048, (8, 0, 0), qd.TILE),     # x base unaligned
    (BF, 300, 2048, 2048, (0, 0, 2), qd.TILE),     # out base unaligned
    (BF, 8, 2048, 2048, (0, 0, 2), qd.SWAP),       # swap stores scalars
])
def test_design_rule_is_a_function_of_the_shapes(dtype, M, N, K, ptrs, want):
    base = 1 << 20
    x, w, out = (base + p for p in ptrs)
    assert qd._design(dtype, M, N, K, x, w, out) == want


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("M", [1, 8, 16, 40, 64])
@pytest.mark.parametrize("N,K", [(2048, 2048), (512, 2048), (8192, 2048),
                                 (2048, 8192), (3072, 768), (1000, 208),
                                 (96, 16), (128256, 2048)])
def test_swap_plan_covers_k_in_whole_steps(M, N, K, sms):
    splits, kper = qd._swap_plan(M, N, K, sms)
    steps = -(-K // qd.SWAP_STEP)
    assert splits >= 1 and kper % qd.SWAP_STEP == 0
    assert (splits - 1) * kper < K <= splits * kper   # none empty, K covered
    if steps >= qd.SWAP_MIN_STEPS:
        assert kper // qd.SWAP_STEP >= qd.SWAP_MIN_STEPS
    tiles = -(-N // qd.SWAP_CHANNELS)
    # about one CTA an SM, fewer where the splits would be too shallow
    assert splits <= max(1, int(sms / tiles + 0.5))
    assert qd._swap_plan(M, N, K, sms) == (splits, kper)   # a pure function


def test_swap_plan_at_the_model_shapes():
    """Llama-3.2-1B's projections at decode (8 rows) on 132 SMs."""
    assert qd._swap_plan(8, 2048, 2048, 132) == (4, 512)
    assert qd._swap_plan(8, 512, 2048, 132) == (8, 256)
    assert qd._swap_plan(8, 8192, 2048, 132) == (1, 2048)   # no merge
    assert qd._swap_plan(8, 2048, 8192, 132) == (4, 2048)
    assert qd._swap_plan(8, 128256, 2048, 132) == (1, 2048)   # a head


@pytest.mark.parametrize("design,splits,want", [
    (qd.TILE, 1, [1, 0, 0]), (qd.TILE, 3, [2, 0, 0]),   # + the combine
    (qd.SWAP, 1, [0, 1, 0]), (qd.SWAP, 8, [0, 1, 0]),   # merged inside
    (qd.TMA, 1, [0, 0, 1])])
def test_kernels_a_call_launches(design, splits, want):
    assert qd._kernels_for(design, splits) == want


def _c_rule(dtype, M, N, K, x, w, out):
    """The C side's ``choose``, restated for the stand-in library."""
    if dtype != 1 or K % 16 or x % 16 or w % 16:
        return 0
    if M <= 64:
        return 1
    return 2 if N % 8 == 0 and out % 16 == 0 else 0


class _RuleLibrary:
    """Stands in for the CUDA library: applies the C rule (or the named
    design), records each call's arguments and reports the kernels it
    would launch by design; ``lie`` reports another design."""

    def __init__(self, lie=False):
        self.calls, self.lie = [], lie

    def bps_quant_dot(self, x, w, scale, bias, out, part, tickets, M, N, K,
                      splits, kper, dtype, out_bf16, design, counts, stream):
        d = _c_rule(dtype, M, N, K, x, w, out) if design < 0 else design
        self.calls.append(dict(design=design, ran=d, part=part,
                               tickets=tickets, M=M, N=N, K=K,
                               splits=splits, kper=kper, dtype=dtype,
                               out_bf16=out_bf16))
        if self.lie:
            d = (d + 1) % 3
        counts[d] = 2 if d == 0 and splits > 1 else 1
        return 0


class _Stream:
    cuda_stream = 0


def _stand_in(monkeypatch, lib):
    monkeypatch.setattr(qd, "_library", lambda: lib)
    monkeypatch.setattr(qd, "_tickets", {})
    monkeypatch.setattr(qd._build, "on_cuda", lambda *a: True)
    monkeypatch.setattr(qd._build, "sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(qd, "design_launches", dict.fromkeys(qd.DESIGNS, 0))


@pytest.mark.parametrize("dtype,out_dtype,M,N,K,bias,design", [
    (BF, BF, 8, 2048, 2048, False, qd.SWAP),
    (BF, F32, 8, 512, 2048, True, qd.SWAP),       # the head's fp32 output
    (BF, BF, 1, 96, 32, True, qd.SWAP),           # one split
    (BF, BF, 65, 1000, 208, True, qd.TMA),
    (BF, BF, 300, 1001, 2048, False, qd.TILE),
    (F32, F32, 8, 2048, 2048, True, qd.TILE),
    (F32, F32, 4096, 512, 2048, False, qd.TILE),
])
def test_launch_takes_the_design_its_rule_names(monkeypatch, dtype,
                                                out_dtype, M, N, K, bias,
                                                design):
    lib = _RuleLibrary()
    _stand_in(monkeypatch, lib)
    x = torch.zeros(M, K, dtype=dtype)
    w = torch.zeros(N, K, dtype=torch.int8)
    b = torch.zeros(N) if bias else None
    before = qd.launches
    out = qd.quant_linear(x, w, torch.ones(N), b, out_dtype)
    assert out.shape == (M, N) and out.dtype == out_dtype
    assert qd.launches == before + 1 and len(lib.calls) == 1
    c = lib.calls[0]
    assert c["design"] == -1 and c["ran"] == design   # the C rule chose
    assert (c["M"], c["N"], c["K"]) == (M, N, K)
    assert (c["dtype"], c["out_bf16"]) == (int(dtype == BF),
                                           int(out_dtype == BF))
    if design == qd.SWAP:
        plan = qd._swap_plan(M, N, K, 132)
    elif design == qd.TILE:
        plan = qd._split_k(M, N, K, torch.device("cpu"))
    else:
        plan = (1, K)
    assert (c["splits"], c["kper"]) == plan
    assert (c["part"] is not None) == (plan[0] > 1)
    assert (c["tickets"] is not None) == (design == qd.SWAP and plan[0] > 1)
    want = qd._kernels_for(design, plan[0])
    assert [qd.design_launches[k] for k in qd.DESIGNS] == want
    if c["tickets"] is not None:   # one ticket a 64-channel tile, zeros
        buf = qd._tickets[torch.device("cpu")]
        assert buf.numel() >= -(-N // qd.SWAP_CHANNELS) and not buf.any()


def test_a_launch_the_rule_did_not_predict_raises(monkeypatch):
    _stand_in(monkeypatch, _RuleLibrary(lie=True))
    x = torch.zeros(8, 2048, dtype=BF)
    w = torch.zeros(2048, 2048, dtype=torch.int8)
    with pytest.raises(RuntimeError, match="the rule predicted"):
        qd.quant_linear(x, w, torch.ones(2048))


def test_a_named_design_is_passed_to_the_library(monkeypatch):
    lib = _RuleLibrary()
    _stand_in(monkeypatch, lib)
    x = torch.zeros(8, 2048, dtype=BF)
    w = torch.zeros(2048, 2048, dtype=torch.int8)
    before = qd.launches
    qd.quant_linear_design(x, w, torch.ones(2048), design=qd.TILE)
    assert lib.calls[0]["design"] == qd.TILE == lib.calls[0]["ran"]
    assert qd.launches == before      # only the model's calls count there
    assert qd.design_launches["tile"] >= 1
    with pytest.raises(ValueError, match="CUDA tensors"):
        monkeypatch.setattr(qd._build, "on_cuda", lambda *a: False)
        qd.quant_linear_design(x, w, torch.ones(2048), design=qd.TILE)
