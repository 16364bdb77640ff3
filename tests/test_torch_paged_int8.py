"""The port's paged attention in its int8 mode and its tensor-parallel
wrapper (byteps_tpu_torch/ops/paged_attention.py), held against the JAX
kernel, and the block pool's int8 / tp geometry against JAX's.

The same numpy inputs go through ``byteps_tpu``'s Pallas
``paged_decode_attention`` / ``paged_decode_attention_sharded`` in
interpret mode (how the JAX suite runs them on the CPU) and through the
port's wrappers on CPU tensors, which run the plain PyTorch version.
Tolerance 2e-5 absolute in fp32: the bound tests/test_torch_paged_attention.py
holds the fp mode to (an online softmax against a dense one).  Int8
values and scales come from the port's ``_quantize_kv`` (bit-equal to
JAX's, tests/test_torch_decode_attention.py); the scale rows past every
cursor hold a stale tenant's garbage (1e30), which the mask must keep
out of the result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from byteps_tpu.ops.paged_attention import (paged_decode_attention,
                                            paged_decode_attention_sharded)
from byteps_tpu.serving.blocks import PagedSlotPool as JaxPagedSlotPool
from byteps_tpu_torch.models.transformer import (TransformerConfig,
                                                 _quantize_kv)
from byteps_tpu_torch.ops import paged_attention as pa
from byteps_tpu_torch.serving.blocks import PagedSlotPool, init_paged_cache

TOL = 2e-5
STALE = 1e30


def _case(seed, B, tq, H, KV, D, blk, mb, pos, quant):
    """Random pools (int8: quantized per (position, head)) and ragged
    per-slot tables covering ``pos + tq``; the rest on the null block 0.
    Int8 scale rows past each slot's last query position are stale."""
    rng = np.random.RandomState(seed)
    n_blocks = 1 + B * mb
    q = rng.randn(B, tq, H, D).astype(np.float32)
    kf = rng.randn(n_blocks, blk, KV, D).astype(np.float32)
    vf = rng.randn(n_blocks, blk, KV, D).astype(np.float32)
    table = np.zeros((B, mb), np.int32)
    nxt = iter(rng.permutation(np.arange(1, n_blocks)))
    for b in range(B):
        for j in range(-(-(int(pos[b]) + tq) // blk)):
            table[b, j] = next(nxt)
    pos = np.asarray(pos, np.int32)
    if not quant:
        return (q, kf.reshape(n_blocks, blk, -1), vf.reshape(n_blocks, blk, -1),
                table, pos, None, None)
    kq, ks = (t.numpy() for t in _quantize_kv(torch.from_numpy(kf)))
    vq, vs = (t.numpy() for t in _quantize_kv(torch.from_numpy(vf)))
    ks[0], vs[0] = STALE, STALE                      # the null block
    for b in range(B):
        last = int(pos[b]) + tq - 1
        bid = table[b, last // blk]
        ks[bid, last % blk + 1:] = STALE
        vs[bid, last % blk + 1:] = STALE
    return (q, kq.reshape(n_blocks, blk, -1), vq.reshape(n_blocks, blk, -1),
            table, pos, ks, vs)


def _jax(q, ck, cv, table, pos, ks, vs, window, fn=paged_decode_attention):
    kw = {}
    if ks is not None:
        kw = {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)}
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                         jnp.asarray(table), jnp.asarray(pos), window=window,
                         interpret=True, **kw))


def _port(q, ck, cv, table, pos, ks, vs, window, fn=None):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    fn = fn or pa.paged_attention
    return fn(t(q), t(ck), t(cv), t(table), t(pos), k_scale=t(ks),
              v_scale=t(vs), window=window).numpy()


@pytest.mark.parametrize("KV", [4, 2, 1])
@pytest.mark.parametrize("tq", [1, 3])
@pytest.mark.parametrize("window", [None, 5])
def test_int8_plain_version_matches_jax_kernel(KV, tq, window):
    """MHA (KV=4), GQA (KV=2) and MQA (KV=1) at H=4 over s8 pools with
    per-(position, head) scales; ragged tables with null-padded tails,
    a slot at pos 0, cursors straddling block boundaries; with and
    without a window."""
    args = _case(KV * 10 + tq, 4, tq, 4, KV, 8, 4, 6, [0, 5, 11, 17], True)
    np.testing.assert_allclose(_port(*args, window), _jax(*args, window),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant", [False, True])
def test_sharded_wrapper_matches_jax_sharded_kernel(tp, quant):
    """Per-shard pools ``[tp, n_blocks, block, (KV/tp)*D]`` cut from one
    unsharded pool head-major (as ``init_paged_cache(tp=...)`` lays them
    out): the port's sharded wrapper equals JAX's, and the unsharded
    call on the same bytes, GQA (H=8, KV=4), tq=2, window 6."""
    q, ck, cv, table, pos, ks, vs = _case(3 + tp, 3, 2, 8, 4, 8, 4, 5,
                                          [2, 9, 15], quant)
    n, blk, kvd = ck.shape

    def shard(a):
        return None if a is None else np.ascontiguousarray(
            a.reshape(n, blk, tp, -1).transpose(2, 0, 1, 3))

    sharded = (q, shard(ck), shard(cv), table, pos, shard(ks), shard(vs))
    got = _port(*sharded, 6, fn=pa.paged_attention_sharded)
    np.testing.assert_allclose(
        got, _jax(*sharded, 6, fn=paged_decode_attention_sharded),
        atol=TOL, rtol=0)
    np.testing.assert_allclose(got, _port(q, ck, cv, table, pos, ks, vs, 6),
                               atol=TOL, rtol=0)


def test_int8_refusals_follow_the_jax_wrapper():
    q, ck, cv, table, pos, ks, vs = (
        None if a is None else torch.from_numpy(a)
        for a in _case(1, 2, 1, 4, 2, 8, 4, 4, [2, 9], True))
    with pytest.raises(ValueError, match="BOTH"):
        pa.paged_attention(q, ck, cv, table, pos, k_scale=ks)
    with pytest.raises(ValueError, match="needs k_scale"):
        pa.paged_attention(q, ck, cv, table, pos)
    with pytest.raises(ValueError, match="expected int8"):
        pa.paged_attention(q, ck.float(), cv.float(), table, pos,
                           k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="kv_heads"):
        pa.paged_attention(q, ck, cv, table, pos, k_scale=ks[..., :1],
                           v_scale=vs[..., :1])
    with pytest.raises(ValueError, match="tp"):
        pa.paged_attention_sharded(
            q[:, :, :3], torch.stack([ck, ck]), torch.stack([cv, cv]), table,
            pos, k_scale=torch.stack([ks, ks]), v_scale=torch.stack([vs, vs]))
    with pytest.raises(ValueError, match="kv_dtype"):
        pa.check_kernel_config(torch.bfloat16, 64, 16, "fp8")
    pa.check_kernel_config(torch.bfloat16, 64, 16, "int8")
    before = pa.launches
    out = pa.paged_attention(q, ck, cv, table, pos, k_scale=ks, v_scale=vs)
    assert pa.launches == before and torch.isfinite(out).all()


def test_kv_bytes_read_counts_int8_scales():
    # block 16, KV 8 x D 64: s8 values 16*512*2 + fp32 scales 16*8*4*2
    per = 16 * 512 * 2 + 16 * 8 * 4 * 2
    assert pa.kv_bytes_read([0, 31], 1, 16, 512, 1, kv_heads=8) == 3 * per
    assert pa.kv_bytes_read([2047] * 8, 1, 16, 512, 1, kv_heads=8) \
        == 8 * 128 * per


@pytest.mark.parametrize("kv_dtype,tp,kv_mb", [
    ("", 1, 0), ("int8", 1, 0), ("", 2, 1), ("int8", 2, 1), ("int8", 4, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_geometry_matches_jax(kv_dtype, tp, kv_mb, dtype):
    """``block_bytes`` and ``n_blocks`` as JAX's ``PagedSlotPool``
    reckons them (int8: 1 byte per value plus 4 per (position, head)
    scale; the total across shards at tp > 1), and the pools' shapes and
    dtypes as ``init_paged_cache`` lays them out."""
    kw = dict(vocab_size=61, num_layers=2, num_heads=8, num_kv_heads=4,
              d_model=64, d_ff=64, max_seq_len=64)
    jcfg = JaxTransformerConfig(dtype=getattr(jnp, dtype), **kw)
    pcfg = TransformerConfig(dtype=getattr(torch, dtype), **kw)
    jpool = JaxPagedSlotPool(jcfg, 2, 64, block=8, kv_bytes=kv_mb << 20,
                             kv_dtype=kv_dtype, tp=tp, layout="flat")
    pool = PagedSlotPool(pcfg, 2, 64, block=8, kv_bytes=kv_mb << 20,
                         kv_dtype=kv_dtype, tp=tp, device="cpu")
    assert pool.block_bytes == jpool.block_bytes
    assert pool.alloc.n_blocks == jpool.alloc.n_blocks
    for jl, pl in zip(jpool.caches, pool.caches):
        assert sorted(jl) == sorted(pl)
        for n in jl:
            assert tuple(pl[n].shape) == tuple(jl[n].shape), n
            assert str(pl[n].dtype).split(".")[-1] == str(jl[n].dtype), n
    assert init_paged_cache(pcfg, 3, 8, kv_dtype=kv_dtype,
                            tp=tp)[0]["k"].shape[-1] == 4 * 8 // tp
