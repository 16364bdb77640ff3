"""The plain version of the port's decode-attention kernel
(byteps_tpu_torch/ops/decode_attention.py) held against the JAX Pallas
kernel ``byteps_tpu.ops.decode_attention.decode_attention`` run in
interpret mode with 64-key chunks, on the same numpy inputs.

Tolerance 2e-5 absolute in fp32: the JAX kernel folds the chunks with an
online softmax, the plain version takes one dense softmax over the same
keys; the two sum the same fp32 products in other orders.  The int8 mode
runs both on the same ``_quantize_kv`` values, which are bit-equal
between the packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models.transformer import _quantize_kv as jax_quantize_kv
from byteps_tpu.ops.decode_attention import decode_attention as jax_decode
from byteps_tpu.ops.decode_attention import (
    decode_attention_usable as jax_usable)
from byteps_tpu_torch.models.transformer import _quantize_kv
from byteps_tpu_torch.ops import decode_attention as da

TOL = 2e-5


def _inputs(seed, B, S, H, KV, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 1, H, D).astype(np.float32),
            rng.randn(B, S, KV, D).astype(np.float32),
            rng.randn(B, S, KV, D).astype(np.float32))


def _jax(q, k, v, pos, window=None, ks=None, vs=None):
    B, S = k.shape[:2]
    kw = {} if ks is None else {"k_scale": jnp.asarray(ks),
                                "v_scale": jnp.asarray(vs)}
    out = jax_decode(jnp.asarray(q), jnp.asarray(k).reshape(B, S, -1),
                     jnp.asarray(v).reshape(B, S, -1), pos, window=window,
                     block_s=64, interpret=True, **kw)
    return np.asarray(out)


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("pos,window", [(0, None), (63, None), (64, None),
                                        (200, None), (255, None), (200, 48),
                                        (255, 48)])
def test_plain_decode_matches_jax_kernel(H, KV, pos, window):
    B, S, D = 2, 256, 16
    q, k, v = _inputs(pos + H, B, S, H, KV, D)
    want = _jax(q, k, v, pos, window)
    got = da.decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k).reshape(B, S, -1),
        torch.from_numpy(v).reshape(B, S, -1), pos, window=window)
    assert got.shape == (B, 1, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
@pytest.mark.parametrize("S,pos,window", [
    (160, 100, None), (160, 150, None),    # a ragged 32-key tail chunk
    (160, 60, 48), (160, 150, 48),          # window
    (256, 0, None), (256, 255, None)])
def test_plain_int8_decode_matches_jax_kernel(H, KV, S, pos, window):
    B, D = 2, 16
    q, k, v = _inputs(9 + pos, B, S, H, KV, D)
    kq, ks = (np.array(a) for a in jax_quantize_kv(jnp.asarray(k)))
    vq, vs = (np.array(a) for a in jax_quantize_kv(jnp.asarray(v)))
    want = _jax(q, kq, vq, pos, window, ks, vs)
    got = da.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kq).reshape(B, S, -1),
        torch.from_numpy(vq).reshape(B, S, -1), pos,
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs),
        window=window)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_quantize_kv_is_bit_equal_to_jax():
    x = np.random.RandomState(2).randn(3, 7, 4, 16).astype(np.float32)
    x[0, 0, 0] = 0.0                        # an all-zero row: scale 1
    x[1, 2, 3, :4] = [127.5, -0.5, 2.5, 0.0]  # ties round half to even
    want_q, want_s = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(x)))
    got_q, got_s = _quantize_kv(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


@pytest.mark.parametrize("args,kw", [
    (((8, 1, 12, 64), 1280, False), {}),
    (((8, 4, 12, 64), 1280, False), {}),
    (((8, 1, 12, 64), 1280, True), {"kv_heads": 12}),
    (((8, 1, 12, 64), 1280, True), {"kv_heads": 2}),
    (((8, 1, 12, 64), 1280, True), {}),
    (((8, 1, 12, 64), 1021, False), {}),
    (((8, 1, 32, 64), 2048, False), {"kv_heads": 8}),
    (((8, 1, 128, 128), 2048, False), {}),
])
def test_usable_gate_answers_as_jax(args, kw):
    assert da.decode_attention_usable(*args, **kw) == jax_usable(*args, **kw)


def test_wrapper_takes_the_plain_version_on_cpu_tensors():
    B, S, H, KV, D = 2, 96, 4, 2, 32
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, B, S, H, KV, D))
    launches, plain = da.launches, da.plain_calls
    flat = da.decode_attention(q, k.reshape(B, S, -1), v.reshape(B, S, -1),
                               70, window=20)
    grouped = da.decode_attention(q, k, v, 70, window=20)
    assert (da.launches, da.plain_calls) == (launches, plain + 2)
    assert torch.equal(flat, grouped)
    with pytest.raises(ValueError, match="tq=1"):
        da.decode_attention(torch.zeros(B, 2, H, D), k, v, 3)
    with pytest.raises(ValueError, match="outside"):
        da.decode_attention(q, k, v, S)
    with pytest.raises(ValueError, match="both"):
        da.decode_attention(q, k, v, 3, k_scale=torch.ones(B, S, KV))


def test_bound_bytes_count_the_attended_rows():
    # Llama-3.2-1B at B=8, pos 2047: 33.5 MB in bf16, 17.8 MB in int8
    assert da.kv_bytes_read(8, 2047, 512, 2) == 33554432
    assert da.kv_bytes_read(8, 2047, 512, 1, kv_heads=8) == 17825792
    assert da.kv_bytes_read(1, 1000, 64, 4, window=256) == 256 * 2 * 64 * 4
    assert da.decode_flops(1, 4, 16, 9) == 4 * 4 * 16 * 10
