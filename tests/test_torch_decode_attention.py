"""The plain version of the port's decode-attention kernel
(byteps_tpu_torch/ops/decode_attention.py) held against the JAX Pallas
kernel ``byteps_tpu.ops.decode_attention.decode_attention`` run in
interpret mode with 64-key chunks, on the same numpy inputs.

Tolerance 2e-5 absolute in fp32: the JAX kernel folds the chunks with an
online softmax, the plain version takes one dense softmax over the same
keys; the two sum the same fp32 products in other orders.  The int8 mode
runs both on the same ``_quantize_kv`` values, which are bit-equal
between the packages.

Also, without a card: the kernel's split plan (``_splits``) covers every
attended chunk once with no empty split, and the ring design's splits
stream at least 8 chunks where the cache has them; the wrapper's launch,
driven through a stand-in for the CUDA library, takes the design its rule
names (``_ring_ok``: bf16 q on tensor cores, fp32 on the first design)
with that plan, and hands the ring its ticket buffer.
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


def _chunks_seen(pos, window, nsplit, per):
    """The chunks each CTA of one (slot, KV head) streams, as the kernel
    computes them (j0 = c_lo + split * per, up to c_hi), in split order."""
    c_lo = (max(pos - window + 1, 0) if window else 0) // da.CHUNK
    c_hi = pos // da.CHUNK
    seen = []
    for split in range(nsplit):
        j0 = c_lo + split * per
        j1 = min(c_hi + 1, j0 + per)
        assert j0 < j1, (split, j0, j1)         # no split is empty
        seen += range(j0, j1)
    return seen, list(range(c_lo, c_hi + 1))


@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("B,KV,S", [
    (8, 8, 2048),    # Llama-3.2-1B generation: 2 ring splits of 16 chunks
    (1, 8, 2048),    # one slot: 4 ring splits of 8
    (8, 1, 2000),    # MQA, S % 64 != 0
    (3, 4, 160),     # a short cache: one split
    (64, 8, 4096),   # more (slot, KV head) pairs than SMs: one split
])
def test_split_plan_covers_every_attended_chunk_once(ring, sms, B, KV, S):
    rng = np.random.RandomState(S + sms)
    cursors = {0, 1, 63, 64, 65, 511, 512, S - 1, S - 2,
               *(int(x) for x in rng.randint(0, S, size=12))}
    for pos in sorted(p for p in cursors if p < S):
        for window in (None, 1, 37, 256, 1000):
            lo = (max(pos - window + 1, 0) if window else 0) // da.CHUNK
            n = pos // da.CHUNK - lo + 1
            nsplit, per = da._splits(B, KV, n, sms, ring)
            assert 1 <= nsplit <= n and per >= 1
            seen, want = _chunks_seen(pos, window, nsplit, per)
            assert seen == want, (pos, window, nsplit, per)
            if ring:
                # a split streams >= 8 chunks where the cache has them,
                # and the CTAs stay within one an SM where they can
                assert per >= min(n, da.RING_MIN_CHUNKS)
                assert nsplit == 1 or B * KV * nsplit <= sms


def test_ring_split_plan_at_the_generation_shape():
    # B = 8, KV = 8 at 2048 keys on 132 SMs: 2 splits of 16 chunks, 128
    # CTAs; 21 chunks for one slot: 2 splits of 11 and 10 (ragged)
    assert da._splits(8, 8, 32, 132, True) == (2, 16)
    assert da._splits(1, 8, 21, 132, True) == (2, 11)
    assert da._splits(8, 8, 32, 132, False) == (16, 2)   # the first design


class _FakeLib:
    """Stands in for the CUDA library: records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def bps_decode_attention_smem(self, G, D, dtype, quant, ring):
        return 1024

    def bps_decode_attention(self, *args):
        self.calls.append(args)
        return 0


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("dtype,quant,H,KV,ring", [
    (torch.bfloat16, False, 32, 8, True),
    (torch.bfloat16, True, 32, 32, True),    # int8 cache, bf16 q
    (torch.bfloat16, False, 32, 1, True),    # MQA: 32 heads, two row tiles
    (torch.bfloat16, False, 64, 1, False),   # 64 heads a KV head
    (torch.float32, False, 32, 8, False),
    (torch.float32, True, 32, 32, False),
])
def test_launch_takes_the_design_its_rule_names(monkeypatch, dtype, quant,
                                                H, KV, ring):
    lib = _FakeLib()
    monkeypatch.setattr(da, "_library", lambda: lib)
    monkeypatch.setattr(da, "_tickets", {})
    monkeypatch.setattr(da._build, "on_cuda", lambda *a: True)
    monkeypatch.setattr(da._build, "sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    B, S, D, pos = 2, 1500, 64, 1400
    q = torch.zeros(B, 1, H, D, dtype=dtype)
    cdt = torch.int8 if quant else dtype
    ck = torch.zeros(B, S, KV * D, dtype=cdt)
    scales = ((torch.zeros(B, S, KV), torch.zeros(B, S, KV)) if quant
              else (None, None))
    before = da.launches
    out = da.decode_attention(q, ck, ck.clone(), pos, k_scale=scales[0],
                              v_scale=scales[1])
    assert da.launches == before + 1 and len(lib.calls) == 1
    assert out.shape == q.shape and out.dtype == dtype
    args = lib.calls[0]
    part, tickets = args[6], args[7]
    (B_, S_, H_, KV_, D_, pos_, window, c_lo, c_hi, nsplit, per, dt, q8,
     rg) = args[8:22]
    assert (B_, S_, H_, KV_, D_, pos_, window) == (B, S, H, KV, D, pos, 0)
    assert (c_lo, c_hi) == (0, pos // da.CHUNK)
    assert (nsplit, per) == da._splits(B, KV, c_hi + 1, 132, ring)
    assert (dt, q8, rg) == (int(dtype == torch.bfloat16), int(quant),
                            int(ring))
    assert da._ring_ok(dtype, H // KV) is ring
    assert (part is None) == (nsplit == 1)
    assert (tickets is not None) == (ring and nsplit > 1)
