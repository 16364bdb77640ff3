"""The port's flash attention (byteps_tpu_torch/ops/flash_attention.py)
held against the JAX Pallas kernels of byteps_tpu/ops/flash_attention.py.

On the CPU the port's wrapper runs its plain versions; the JAX kernels
run in interpret mode, as tests/test_flash_attention.py runs them.
Inputs come from numpy with a fixed seed and go through both.  Each
case compares the forward (o and lse), dq, dk and dv — the JAX backward
from ``_flash_backward(..., interpret=True)`` — in fp32 within 2e-5:
the two sum the same fp32 products in other orders (blocked online
softmax vs one dense softmax), which moves results by ~1e-6.

Cases: causal and non-causal, MHA, GQA 4/2 and MQA, sliding window,
segment ids (two packed documents, causal and not), ALiBi, a T that is
a multiple of no tile (37), and the lse variant with a nonzero lse
cotangent.  The autograd Function is also held to a dense masked
softmax's autograd and to ``torch.autograd.gradcheck`` in fp64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops.flash_attention import (_flash_backward, _flash_forward,
                                            flash_attention_with_lse as
                                            jax_flash_with_lse)
from byteps_tpu_torch.ops import flash_attention as fa

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU tests run tiny torch ops beside other test workers: one
    intra-op thread each keeps them from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 2e-5

# name: (B, T, H, KV, D, causal, window, segments, alibi, block)
CASES = {
    "causal_mha": (2, 32, 4, 4, 16, True, None, False, False, 1024),
    "noncausal_gqa": (2, 32, 4, 2, 16, False, None, False, False, 1024),
    "causal_mqa_blocks16": (1, 48, 4, 1, 32, True, None, False, False, 16),
    "window8_gqa": (2, 40, 4, 2, 16, True, 8, False, False, 1024),
    "segments_causal": (2, 32, 4, 2, 16, True, None, True, False, 1024),
    "segments_noncausal": (2, 32, 2, 2, 16, False, None, True, False, 1024),
    "alibi_gqa": (2, 32, 4, 2, 16, True, None, False, True, 1024),
    "ragged_t37": (2, 37, 4, 2, 16, True, None, False, False, 1024),
}


def _inputs(seed, B, T, H, KV, D, segments, alibi):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, T, KV, D).astype(np.float32)
    v = rng.randn(B, T, KV, D).astype(np.float32)
    do = rng.randn(B, T, H, D).astype(np.float32)
    seg = None
    if segments:  # two packed documents, split at a different row each
        cut = 5 + 7 * np.arange(B)
        seg = (np.arange(T)[None] >= cut[:, None]).astype(np.int32)
    slopes = (2.0 ** -np.arange(1, H + 1)).astype(np.float32) if alibi \
        else None
    return q, k, v, do, seg, slopes


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_versions_match_the_jax_kernels(name):
    B, T, H, KV, D, causal, window, segs, alibi, block = CASES[name]
    q, k, v, do, seg, slopes = _inputs(3, B, T, H, KV, D, segs, alibi)
    scale = D ** -0.5
    jo, jlse = _flash_forward(_j(q), _j(k), _j(v), causal, scale, block,
                              block, True, _j(seg), window, _j(slopes))
    jdq, jdk, jdv = _flash_backward(
        _j(q), _j(k), _j(v), jo, jlse, _j(do), None, causal, scale, block,
        block, True, _j(seg), window, _j(slopes))
    opts = (causal, scale, _t(seg), window, _t(slopes))
    o, lse = fa.flash_forward(_t(q), _t(k), _t(v), *opts)
    delta = (torch.from_numpy(do) * o).sum(-1).permute(0, 2, 1).contiguous()
    dq = fa.flash_backward_dq(_t(q), _t(k), _t(v), _t(do), lse, delta, *opts)
    dk, dv = fa.flash_backward_dkv(_t(q), _t(k), _t(v), _t(do), lse, delta,
                                   *opts)
    for got, want, what in ((o, jo, "o"), (lse.reshape(B * H, T), jlse, "lse"),
                            (dq, jdq, "dq"), (dk, jdk, "dk"),
                            (dv, jdv, "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0, err_msg=f"{name}: {what}")


def test_lse_variant_with_an_lse_cotangent_matches_jax_vjp():
    """``flash_attention_with_lse``: o and lse ``[B, T, H]``, and the
    gradients for cotangents on both outputs (the lse one folds into
    delta), against ``jax.vjp`` of the JAX function in interpret mode."""
    B, T, H, KV, D = 2, 32, 4, 2, 16
    q, k, v, do, _, _ = _inputs(5, B, T, H, KV, D, False, False)
    dlse = np.random.RandomState(6).randn(B, T, H).astype(np.float32)
    (jo, jlse), vjp = jax.vjp(
        lambda a, b, c: jax_flash_with_lse(a, b, c, True, None, None, None,
                                           True), _j(q), _j(k), _j(v))
    jgrads = vjp((_j(do), _j(dlse)))
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    o, lse = fa.flash_attention_with_lse(qt, kt, vt, causal=True)
    torch.autograd.backward((o, lse), (_t(do), _t(dlse)))
    assert lse.shape == (B, T, H)
    for got, want, what in ((o, jo, "o"), (lse, jlse, "lse"),
                            (qt.grad, jgrads[0], "dq"),
                            (kt.grad, jgrads[1], "dk"),
                            (vt.grad, jgrads[2], "dv")):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=TOL, rtol=0, err_msg=what)


def _dense(q, k, v, causal, seg, window, slopes):
    """A dense masked softmax written out, with autograd."""
    B, T, H, D = q.shape
    G = H // k.shape[2]
    k, v = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    r, c = torch.arange(T)[:, None], torch.arange(T)[None]
    if slopes is not None:
        s = s + slopes[None, :, None, None] * (c - r)
    keep = torch.ones(T, T, dtype=torch.bool)
    if causal:
        keep = r >= c
        if window is not None:
            keep = keep & (r - c < window)
    keep = keep[None, None]
    if seg is not None:
        keep = keep & (seg[:, None, :, None] == seg[:, None, None, :])
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("name", ["noncausal_gqa", "window8_gqa",
                                  "segments_causal", "alibi_gqa",
                                  "ragged_t37"])
def test_function_grads_match_dense_softmax_autograd(name):
    B, T, H, KV, D, causal, window, segs, alibi, _ = CASES[name]
    q, k, v, do, seg, slopes = _inputs(9, B, T, H, KV, D, segs, alibi)
    grads = []
    for fn in (lambda a, b, c: fa.flash_attention(
            a, b, c, causal, segment_ids=_t(seg), window=window,
            alibi_slopes=_t(slopes)),
               lambda a, b, c: _dense(a, b, c, causal, _t(seg), window,
                                      _t(slopes))):
        ts = [_t(x).requires_grad_() for x in (q, k, v)]
        out = fn(*ts)
        out.backward(_t(do))
        grads.append([out.detach()] + [t.grad for t in ts])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0)


def test_function_passes_gradcheck_in_fp64():
    # the plain versions take any head dim; a small one keeps the
    # numerical Jacobian cheap
    rng = np.random.RandomState(2)
    q = torch.from_numpy(rng.randn(1, 7, 4, 4)).requires_grad_()
    k = torch.from_numpy(rng.randn(1, 7, 2, 4)).requires_grad_()
    v = torch.from_numpy(rng.randn(1, 7, 2, 4)).requires_grad_()
    seg = torch.tensor([[0, 0, 0, 1, 1, 1, 1]])
    slopes = torch.tensor([0.5, 0.25, 0.125, 0.0625], dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, True, segment_ids=seg,
                                           window=5, alibi_slopes=slopes),
        (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention_with_lse(a, b, c, False),
        (q, k, v))


def test_alibi_slopes_get_a_zero_gradient_and_bad_options_are_refused():
    q = torch.randn(1, 8, 2, 16)
    k = torch.randn(1, 8, 1, 16)
    slopes = torch.tensor([0.5, 0.25], requires_grad=True)
    fa.flash_attention(q, k, k, True, alibi_slopes=slopes).sum().backward()
    assert torch.equal(slopes.grad, torch.zeros(2))
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, k, k, False, window=4)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention(q, k, k, False, alibi_slopes=slopes)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, torch.randn(1, 8, 3, 16),
                           torch.randn(1, 8, 3, 16))
    with pytest.raises(ValueError, match="segment_ids"):
        fa.flash_attention(q, k, k, True, segment_ids=torch.zeros(1, 7))


def test_attention_flops_count_the_attended_pairs():
    f = fa.attention_flops(1, 4, 1, 2, causal=True)
    assert f == {"fwd": 4 * 10 * 2, "dq": 6 * 10 * 2, "dkv": 8 * 10 * 2}
    assert fa.attention_flops(1, 4, 1, 2, causal=False)["fwd"] == 4 * 16 * 2
    # window 2 over T 4: rows see 1, 2, 2, 2 keys
    assert fa.attention_flops(1, 4, 1, 2, True, window=2)["fwd"] == 4 * 7 * 2
