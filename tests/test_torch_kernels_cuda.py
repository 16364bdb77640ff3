"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the GPU.  Imports torch and the port only (no JAX), so it
runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a GPU every test here skips.  Paged attention (fp and int8
pools, and the tp wrapper): fp32 1e-4 absolute (online vs dense softmax
accumulation order); bf16 2e-2 (p is rounded to bf16 before the PV
product, so a bf16 ulp of a probability reaches the output); the tp
wrapper's output bit-identical to the unsharded launch (one launch whose
CTAs do the unsharded launch's arithmetic for their rows), and reruns
bit-identical (the splits merge in split order); the int8 mode with a
bf16 q within 2 bf16 ulps of each output row's largest reference
magnitude (both sides round p and the output to bf16 at the same points).  Flash attention (forward, dq, dk/dv): fp32 1e-4
of the largest reference magnitude, absolute below magnitude 1 (dk/dv
sum over the whole head group); bf16 2e-2 of the largest reference
magnitude (p and ds are rounded to bf16 before their products, at
other running maxima in the online forward than in the dense plain
version, and every output is rounded to bf16 once); reruns of every
kernel bit-identical (no atomics).  Fused LM-head
cross-entropy (forward, dlogits + dx, dW): fp32 lse and target logit
within 1e-5 relative, dx and dW within 1e-4 of the largest reference
magnitude (fp32 sums of H or N products in other orders); bf16 within
2e-2 of the largest reference magnitude (dlogits is rounded to bf16
before each product, in both), on the kernels on TMA and wgmma where
their rule takes the shape (dW too, on ragged rows, columns and depth)
and on the first design where it does not (H = 36), with bit-identical
reruns.  Decode attention (fp and int8 caches): fp32 1e-4 absolute
(online softmax over splits vs one dense softmax); a bf16 q (bf16 cache,
or int8 with scales) on the kernel on tensor cores, one launch a call by
profiler name (taken in a fresh process, never an empty profile), and
every call held to the launches the library counts by design, within 2
bf16 ulps of each output row's largest reference magnitude (p is rounded
to bf16 before the PV product at other running maxima, and the output
once), reruns bit-identical (warps and splits merge in a fixed order);
the device form (a position vector, 8 slots at mixed depths) under the
same tolerances, each slot's bits independent of the others' positions,
and a CUDA graph replayed at rewritten positions.  The int8 product, in each of its three
designs (swap up to 64 bf16 rows, tma above, the tile design for fp32 x
and the shapes neither takes; the rule's choice held to the launches the
library counts): bf16 within one bf16 ulp of the largest output (2^-7 of
it: the same rounding points on both sides, fp32 sums in other orders),
fp32 within 1e-5 of the largest output; reruns bit-identical (the swap
design's splits merge in split order), its tickets back at zero.  And
the disaggregated KV ship between two CUDA engines: the adopted blocks
give a colocated engine's tokens exactly (fp32), the paged launches are
the decode replica's ticks x layers, both pools end at their base; and
the ship's copies ordered after the writes queued on the default stream.
And a port router over two CUDA replicas failing a stream over across a
replica's kill: the splice equals its own control (the survivor's resumed
continuation), every paged-attention call a kernel launch.  And the
eager push_pull API at one worker on NCCL (every result the input's
bits), and two gloo processes sharing the card running
``push_pull_shard`` on CUDA tensors, bit-identical to the host sum.
"""

import numpy as np
import pytest
import torch

from byteps_tpu_torch.ops import flash_attention as fa
from byteps_tpu_torch.ops import fused_cross_entropy as fce
from byteps_tpu_torch.models.transformer import _quantize_kv
from byteps_tpu_torch.ops import decode_attention as da
from byteps_tpu_torch.ops import paged_attention as pa
from byteps_tpu_torch.ops import quant_dot as qd


def _case(seed, B, tq, H, KV, D, blk, mb, pos, dtype):
    rng = np.random.RandomState(seed)
    n_blocks = 1 + B * mb
    q = torch.from_numpy(rng.randn(B, tq, H, D).astype(np.float32))
    ck = torch.from_numpy(rng.randn(n_blocks, blk, KV * D).astype(np.float32))
    cv = torch.from_numpy(rng.randn(n_blocks, blk, KV * D).astype(np.float32))
    table = np.zeros((B, mb), np.int32)
    nxt = iter(rng.permutation(np.arange(1, n_blocks)))
    for b in range(B):
        for j in range(-(-(pos[b] + tq) // blk)):
            table[b, j] = next(nxt)
    dev = torch.device("cuda")
    return (q.to(dev, dtype), ck.to(dev, dtype), cv.to(dev, dtype),
            torch.from_numpy(table).to(dev),
            torch.tensor(pos, dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("tq,window", [(1, None), (4, None), (1, 256),
                                       (3, 5)])
# (32, 1, 64, 16): G * tq reaches 128 query rows per CTA, past the 64 one
# pass of 16 warps x 4 rows holds, so the kernel walks the blocks twice
@pytest.mark.parametrize("H,KV,D,blk", [(32, 8, 64, 16), (8, 2, 128, 64),
                                        (4, 4, 64, 8), (32, 1, 64, 16),
                                        (4, 2, 32, 16), (8, 4, 16, 8)])
def test_paged_attention_kernel_matches_plain_version(dtype, tol, tq, window,
                                                      H, KV, D, blk):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pos = [0, 1, 17, 100, 255, 333, 480, 623]
    mb = -(-(max(pos) + tq) // blk)
    args = _case(5, len(pos), tq, H, KV, D, blk, mb, pos, dtype)
    before = pa.launches
    out = pa.paged_attention(*args, window=window)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    ref = pa.paged_attention_reference(*args, window=window)
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out.float()).all()
    assert err <= tol, err


def _int8_pools(ck, cv, KV, table, pos, tq):
    """Quantize fp pools per (position, KV head) with ``_quantize_kv``;
    the scale rows of the null block and past each slot's last query
    position hold a stale tenant's garbage (1e30)."""
    n, blk, kvd = ck.shape
    out = []
    for c in (ck, cv):
        qv, sc = _quantize_kv(c.float().view(n, blk, KV, kvd // KV))
        sc[0] = 1e30
        for row, p in zip(table.tolist(), pos):
            last = p + tq - 1
            sc[row[last // blk], last % blk + 1:] = 1e30
        out += [qv.view(n, blk, kvd), sc]
    return out


def _row_ulps(out, ref):
    """The largest ``|out - ref|`` in bf16 ulps of its row's (one query
    head's) largest reference magnitude."""
    top = ref.float().abs().amax(dim=-1, keepdim=True).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return ((out.float() - ref.float()).abs() / ulp).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, None)])
@pytest.mark.parametrize("tq,window", [(1, None), (5, None), (1, 256),
                                       (3, 5)])
@pytest.mark.parametrize("H,KV,D,blk", [(32, 8, 64, 16), (8, 2, 128, 64),
                                        (32, 1, 64, 16), (4, 4, 32, 16),
                                        (8, 4, 16, 8)])
def test_paged_attention_int8_mode_matches_plain_version(dtype, tol, tq,
                                                         window, H, KV, D,
                                                         blk):
    """s8 pools with fp32 scale pools, q in fp32 or bf16; stale scale rows
    past the cursors are garbage, which the mask must keep out."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pos = [0, 1, 17, 100, 255, 333, 480, 623]
    mb = -(-(max(pos) + tq) // blk)
    q, ck, cv, table, posv = _case(9, len(pos), tq, H, KV, D, blk, mb, pos,
                                   torch.float32)
    kq, ks, vq, vs = _int8_pools(ck, cv, KV, table, pos, tq)
    q = q.to(dtype)
    before = pa.launches
    out = pa.paged_attention(q, kq, vq, table, posv, k_scale=ks, v_scale=vs,
                             window=window)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    ref = pa.paged_attention_reference(q, kq, vq, table, posv, k_scale=ks,
                                       v_scale=vs, window=window)
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    if tol is None:                     # bf16 q
        assert _row_ulps(out, ref) <= 2, _row_ulps(out, ref)
    else:
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_span_past_the_row_end(quant):
    """A verify span at the row's end (``pos + tq`` past ``max_blocks *
    block``): the kernel reads the row's own blocks only, as the plain
    version does, so every row (those past the end included) agrees."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, KV, D, blk, tq, S = 32, 8, 64, 16, 5, 2048
    pos = [2047, 2046, 2044, 2043, 100, 0, 2045, 1500]
    mb = S // blk
    # one block past the row is allocated, then cut off the table
    q, ck, cv, table, posv = _case(6, len(pos), tq, H, KV, D, blk, mb + 1,
                                   pos, torch.float32)
    kw = {}
    if quant:
        ck, ks, cv, vs = _int8_pools(ck, cv, KV, table, pos, tq)
        kw = {"k_scale": ks, "v_scale": vs}
    table = table[:, :mb].contiguous()
    out = pa.paged_attention(q, ck, cv, table, posv, **kw)
    ref = pa.paged_attention_reference(q, ck, cv, table, posv, **kw)
    assert torch.isfinite(out).all()
    err = (out - ref).abs().max().item()
    assert err <= 1e-4, err


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_sharded_is_the_unsharded_launch(tp, quant, dtype):
    """Per-shard pools cut head-major from one pool: ``tp`` launches, and
    an output bit-identical to the unsharded launch's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, KV, D, blk, tq = 32, 8, 64, 16, 5
    pos = [1, 90, 511, 1000, 1500, 2000, 2042, 2042]
    mb = -(-(max(pos) + tq) // blk)
    q, ck, cv, table, posv = _case(4, len(pos), tq, H, KV, D, blk, mb, pos,
                                   dtype)
    kw = {}
    if quant:
        ck, ks, cv, vs = _int8_pools(ck, cv, KV, table, pos, tq)
        kw = {"k_scale": ks, "v_scale": vs}
    n = ck.shape[0]

    def shard(t):
        return t.reshape(n, blk, tp, -1).permute(2, 0, 1, 3).contiguous()

    whole = pa.paged_attention(q, ck, cv, table, posv, **kw)
    before = pa.launches
    parts = pa.paged_attention_sharded(
        q, shard(ck), shard(cv), table, posv,
        **{k: shard(v) for k, v in kw.items()})
    torch.cuda.synchronize()
    assert pa.launches == before + 1  # one launch serves every shard
    assert torch.equal(parts, whole)


def _split_case(name, sms):
    """Cursors (and shapes) that put the split plan's edges where the
    kernel can get them wrong.  Returns ``(H, KV, D, blk, mb, tq, window,
    pos, cut)``: with ``cut`` the table keeps ``mb`` blocks but one more
    is allocated past each row (a span running past the row's end)."""
    H, KV, D, blk, mb, tq, window, cut = 32, 8, 64, 16, 128, 1, None, False
    if name == "block64_head_dim128":
        H, KV, D, blk, mb = 8, 2, 128, 64, 32
    if name == "max_blocks_not_a_multiple":
        mb = 130
    probe = (torch.empty(8, tq, H, D, device="meta"),
             torch.empty(1, blk, KV * D, device="meta"),
             torch.empty(8, mb, device="meta"))
    _, per = pa.split_plan(*probe, sms)
    edge = per * blk  # keys per split
    S = mb * blk
    if name == "cursor_0":
        pos = [0, 0, 1, 0, 5, 0, edge, 0]
    elif name in ("split_edge", "block64_head_dim128"):
        pos = [edge - 1, edge, 2 * edge - 1, 2 * edge, 3 * edge - 1,
               3 * edge + 1, S - 1, 0]
    elif name == "tq5_across_edge":
        tq = 5
        pos = [edge - 2, edge - 5, edge - 4, 2 * edge - 3, 0, S - 5,
               3 * edge - 1, 4 * edge - 3]
    elif name == "tq5_past_row_end":
        tq, cut = 5, True
        pos = [S - 1, S - 2, S - 4, S - 5, S - 3, 0, edge - 2, S - edge - 2]
    elif name == "window256_mid_split":
        window = 256
        pos = [edge + 255 + edge // 2, 1000, 255 + edge // 2, 3 * edge + 7,
               255, 256, S - 1, 0]
    elif name == "max_blocks_not_a_multiple":
        pos = [S - 1, S - 2, S - edge, S - edge - 1, 17, 0, edge, S // 2]
    return H, KV, D, blk, mb, tq, window, pos, cut


SPLIT_CASES = ("cursor_0", "split_edge", "tq5_across_edge",
               "tq5_past_row_end", "window256_mid_split",
               "max_blocks_not_a_multiple", "block64_head_dim128")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", SPLIT_CASES)
def test_paged_attention_split_plan_edges(mode, name):
    """The block axis split over CTAs and merged by the last one: cursors
    at 0, on and one past a split's edge, a verify span across an edge and
    past the row's end, a window starting mid-split, ``max_blocks`` not a
    multiple of the split, block 64 at head_dim 128.  Each against the
    plain version (fp32 1e-4, bf16 2e-2, int8 with a bf16 q 2 row ulps),
    and a rerun bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from byteps_tpu_torch.ops import _build
    sms = _build.sm_count(torch.device("cuda", torch.cuda.current_device()))
    H, KV, D, blk, mb, tq, window, pos, cut = _split_case(name, sms)
    dtype = torch.float32 if mode == "float32" else torch.bfloat16
    q, ck, cv, table, posv = _case(12, len(pos), tq, H, KV, D, blk,
                                   mb + cut, pos,
                                   torch.float32 if mode == "int8" else dtype)
    kw = {}
    if mode == "int8":
        ck, ks, cv, vs = _int8_pools(ck, cv, KV, table, pos, tq)
        kw = {"k_scale": ks, "v_scale": vs}
        q = q.to(dtype)
    table = table[:, :mb].contiguous()
    assert pa.split_plan(q, ck, table, sms)[0] > 1  # the merge path runs
    before = pa.launches
    out = pa.paged_attention(q, ck, cv, table, posv, window=window, **kw)
    again = pa.paged_attention(q, ck, cv, table, posv, window=window, **kw)
    torch.cuda.synchronize()
    assert pa.launches == before + 2
    ref = pa.paged_attention_reference(q, ck, cv, table, posv, window=window,
                                       **kw)
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    if mode == "int8":
        assert _row_ulps(out, ref) <= 2, _row_ulps(out, ref)
    else:
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= (1e-4 if mode == "float32" else 2e-2), err
    assert torch.equal(out, again)


def _flash_inputs(seed, B, T, H, KV, D, dtype, seg, alibi):
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, dtype)

    q, k, v, do = t(B, T, H, D), t(B, T, KV, D), t(B, T, KV, D), t(B, T, H, D)
    segment_ids = None
    if seg:  # two packed documents per row, split at different points
        cut = np.arange(B) * 7 % T // 2 + T // 4
        segment_ids = torch.from_numpy(
            (np.arange(T)[None] >= cut[:, None]).astype(np.int32)).to(dev)
    slopes = (torch.from_numpy(2.0 ** -np.arange(1, H + 1, dtype=np.float32))
              .to(dev) if alibi else None)
    return q, k, v, do, segment_ids, slopes


def _rel_err(out, ref, dtype):
    err = (out.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    return err / (max(top, 1e-6) if dtype == torch.bfloat16
                  else max(top, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,H,KV,D,causal,window,seg,alibi", [
    (128, 4, 2, 64, True, None, False, False),     # GQA causal
    (128, 4, 4, 64, False, None, False, False),    # MHA, non-causal
    (200, 4, 1, 64, True, None, False, False),     # MQA, T % 64 != 0
    (256, 4, 2, 64, True, 48, False, False),       # sliding window
    (160, 4, 2, 64, True, None, True, False),      # packed documents
    (96, 4, 2, 64, False, None, True, False),      # segments, non-causal
    (128, 4, 2, 64, True, None, False, True),      # ALiBi
    (100, 2, 1, 16, True, None, False, False),     # head_dim 16
    (77, 4, 2, 32, True, 20, True, True),          # head_dim 32, all options
    (130, 4, 2, 128, True, None, False, False),    # head_dim 128
    (128, 8, 1, 64, True, None, False, False),     # G = 8
    (200, 4, 2, 128, True, 40, True, True),        # head_dim 128, all options
    (65, 4, 2, 64, True, None, False, False),      # one live row past a tile
    (2000, 8, 2, 64, True, None, False, False),    # a 16-row tail tile
])
def test_flash_kernels_match_plain_versions(dtype, tol, T, H, KV, D, causal,
                                            window, seg, alibi):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, do, seg_ids, slopes = _flash_inputs(
        7, 2, T, H, KV, D, dtype, seg, alibi)
    args = (causal, None, seg_ids, window, slopes)
    n0 = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    o, lse = fa.flash_forward(q, k, v, *args)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, *args)
    delta = (do.float() * o_ref.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq = fa.flash_backward_dq(q, k, v, do, lse_ref, delta, *args)
    dk, dv = fa.flash_backward_dkv(q, k, v, do, lse_ref, delta, *args)
    dq_ref = fa.flash_backward_dq_reference(q, k, v, do, lse_ref, delta, *args)
    dk_ref, dv_ref = fa.flash_backward_dkv_reference(q, k, v, do, lse_ref,
                                                     delta, *args)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(
        n + 1 for n in n0)
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    o2, lse2 = fa.flash_forward(q, k, v, *args)  # a rerun: the same bits
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    dq2 = fa.flash_backward_dq(q, k, v, do, lse_ref, delta, *args)
    dk2, dv2 = fa.flash_backward_dkv(q, k, v, do, lse_ref, delta, *args)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(
        dv, dv2)
    for name, out, ref in (("o", o, o_ref), ("dq", dq, dq_ref),
                           ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        assert out.shape == ref.shape and out.dtype == ref.dtype, name
        assert torch.isfinite(out.float()).all(), name
        assert torch.isfinite(ref.float()).all(), name
        err = _rel_err(out, ref, dtype)
        assert err <= tol, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("T,H,KV,D", [(1, 4, 2, 64), (1, 4, 4, 128),
                                      (2000, 8, 2, 64)])
def test_flash_forward_bf16_at_the_t_edges(T, H, KV, D):
    """The tensor-core forward at T = 1 (one live row of a 64-row tile)
    and T = 2000 (a tail tile of 16 rows): o within 2e-2 of the largest
    reference magnitude, lse within 1e-4, a rerun bit-identical.  (The
    backward at T = 1 has dq = dk = 0 up to rounding, which a relative
    bound cannot hold: the forward alone.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, _, _, _ = _flash_inputs(13, 2, T, H, KV, D, torch.bfloat16,
                                     False, False)
    o, lse = fa.flash_forward(q, k, v, True)
    o2, lse2 = fa.flash_forward(q, k, v, True)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, True)
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert _rel_err(o, o_ref, torch.bfloat16) <= 2e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def _padding_ids(seed, B, T):
    """BERT padding segment ids ``1...1 0...0`` of seeded lengths in [1,
    T], row 0 unpadded and row 1 one valid token."""
    lengths = np.random.RandomState(seed).randint(1, T + 1, size=B)
    lengths[:2] = (T, 1)
    return torch.from_numpy((np.arange(T)[None] < lengths[:, None]).astype(
        np.int32)).to("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernels_at_the_bert_padding_shape(dtype, tol):
    """BERT-base's fine-tune shape: B=32, T=128 (two 64-row tiles), H=KV=12
    (not a power of two), D=64, non-causal, padding segment ids.  A padding
    query's first key tile is all valid keys, which it may not see: no NaN
    in o, lse, dq, dk or dv; each within its bound of the plain version,
    lse within 1e-4, reruns bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, do, _, _ = _flash_inputs(11, 32, 128, 12, 12, 64, dtype, False,
                                      False)
    args = (False, None, _padding_ids(11, 32, 128), None, None)
    o, lse = fa.flash_forward(q, k, v, *args)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, *args)
    delta = (do.float() * o_ref.float()).sum(-1).permute(0, 2, 1).contiguous()
    bwd = (q, k, v, do, lse_ref, delta)
    dq = fa.flash_backward_dq(*bwd, *args)
    dk, dv = fa.flash_backward_dkv(*bwd, *args)
    dq_ref = fa.flash_backward_dq_reference(*bwd, *args)
    dk_ref, dv_ref = fa.flash_backward_dkv_reference(*bwd, *args)
    again = (*fa.flash_forward(q, k, v, *args),
             fa.flash_backward_dq(*bwd, *args),
             *fa.flash_backward_dkv(*bwd, *args))
    torch.cuda.synchronize()
    assert torch.isfinite(lse).all()
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    for name, out, ref in (("o", o, o_ref), ("dq", dq, dq_ref),
                           ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        assert torch.isfinite(out.float()).all(), name
        err = _rel_err(out, ref, dtype)
        assert err <= tol, (name, err)
    for a, b in zip((o, lse, dq, dk, dv), again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_autograd_on_the_card_matches_the_cpu_function():
    """The same Function on CUDA tensors (the kernels, fp32) and on CPU
    tensors (the plain versions, run in fp64: the exact values), GQA,
    causal, lse variant with a nonzero lse cotangent; reruns on the card
    are bit-identical.  The CPU side runs in fp64 because its fp32 sums
    follow the host: on one host the process's first fp32 call landed
    9.9e-5 from the exact values (dk[1, 1, 1, 45]), where the card's
    kernels stay within 6.2e-6 (scripts/torch_flash_grad_drift.py).  The
    fp32 plain versions stay held to JAX's kernels on the CPU by
    ``tests/test_torch_flash_attention.py::
    test_plain_versions_match_the_jax_kernels``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, do, _, _ = _flash_inputs(3, 2, 150, 8, 2, 64, torch.float32,
                                      False, False)
    # the lse cotangent from its own generator, seeded as the inputs are:
    # the same values whatever ran before in the process
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    dlse = torch.randn(2, 150, 8, device="cuda", generator=g)
    grads = []
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64),
                       ("cuda", torch.float32)):
        qq, kk, vv = (t.detach().to(dev, dtype).requires_grad_()
                      for t in (q, k, v))
        o, lse = fa.flash_attention_with_lse(qq, kk, vv, causal=True)
        torch.autograd.backward((o, lse), (do.to(dev, dtype),
                                           dlse.to(dev, dtype)))
        grads.append([t.cpu() for t in (o.detach(), lse.detach(), qq.grad,
                                        kk.grad, vv.grad)])
    for a, b in zip(grads[0], grads[1]):
        assert (a.double() - b).abs().max().item() <= 1e-4
    for a, b in zip(grads[0], grads[2]):
        assert torch.equal(a, b)


def _fce_inputs(seed, N, H, V, dtype, tgt_dtype=torch.int64, table=True):
    """x [N, H], w [H, V] (the transpose view of a [V, H] table, or a
    [H, V] tensor), targets with every 4th row -100, a non-uniform
    cotangent zero on those rows."""
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.randn(N, H).astype(np.float32)).to(dev, dtype)
    tab = torch.from_numpy((rng.randn(V, H) * 0.05).astype(np.float32))
    w = tab.to(dev, dtype).t() if table else \
        tab.t().contiguous().to(dev, dtype)
    t = rng.randint(0, V, size=N)
    t[::4] = -100
    dl = rng.uniform(0.5, 1.5, size=N).astype(np.float32) * (t >= 0)
    return (x, w, torch.from_numpy(t).to(dev, tgt_dtype),
            torch.from_numpy(dl).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("N,H,V,tgt_dtype,table", [
    (512, 256, 9000, torch.int64, True),    # two vocabulary chunks
    (300, 72, 1000, torch.int32, True),     # ragged rows and columns
    (77, 36, 300, torch.int64, True),       # H % 8 != 0: scalar loads
    (130, 64, 8192, torch.int64, False),    # w laid out [H, V] itself
])
def test_fused_ce_kernels_match_plain_versions(dtype, tol, N, H, V, tgt_dtype,
                                               table):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, w, t, dl = _fce_inputs(11, N, H, V, dtype, tgt_dtype, table)
    n0 = (fce.fwd_launches, fce.dx_launches, fce.dw_launches)
    lse, tl = fce.fce_forward(x, w, t)
    lse_r, tl_r = fce.fce_forward_reference(x, w, t)
    dx, dw = fce.fce_backward(x, w, t, lse_r, dl)
    dx_r = fce.fce_backward_dx_reference(x, w, t, lse_r, dl)
    dw_r = fce.fce_backward_dw_reference(x, w, t, lse_r, dl)
    torch.cuda.synchronize()
    nc = fce.vocab_chunks(V)
    assert (fce.fwd_launches, fce.dx_launches, fce.dw_launches) == (
        n0[0] + 1, n0[1] + nc, n0[2] + nc)
    for name, out, ref in (("lse", lse, lse_r), ("tl", tl, tl_r)):
        err = ((out - ref).abs().max() / ref.abs().max()).item()
        assert err <= 1e-5, (name, err)
    for name, out, ref in (("dx", dx, dx_r), ("dw", dw, dw_r)):
        assert out.shape == ref.shape and out.dtype == ref.dtype, name
        assert torch.isfinite(out.float()).all(), name
        err = _rel_err(out, ref, torch.bfloat16)  # of the largest magnitude
        assert err <= tol, (name, err)
    assert (dx[t < 0] == 0).all()  # ignored rows get no gradient


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,V,table,tma", [
    (300, 72, 1000, True, True),     # one chunk; N, H, V all ragged
    (200, 320, 16484, True, True),   # three chunks, the last 100 wide; a
                                     # dx column tile of one 64-wide box
    (517, 200, 9000, True, True),    # two chunks, the last 808 wide
    (130, 64, 8192, False, True),    # w laid out [H, V] itself (copied)
    (333, 520, 8300, True, True),    # dW: the last chunk 108 rows, H a
                                     # multiple of 8 but not of 256, N of
                                     # 64 neither
    (1000, 136, 5000, True, True),   # dW: one 5000-row chunk, one
                                     # 136-wide column tile, N = 1000
    (77, 36, 300, True, False),      # H % 8 != 0: the first design
])
def test_fused_ce_bf16_paths_match_plain_versions_and_rerun_identically(
        N, H, V, table, tma):
    """bf16 on the kernels on TMA and wgmma where the rule takes the
    shape (the path counter says which ran: the forward, and dlogits, dx
    and dW of every chunk), against the plain versions within 2e-2 of the
    largest reference magnitude; forward, dx and dW reruns
    bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, w, t, dl = _fce_inputs(12, N, H, V, torch.bfloat16, torch.int64,
                              table)
    n0 = fce.tma_launches
    lse, tl = fce.fce_forward(x, w, t)
    lse_r, tl_r = fce.fce_forward_reference(x, w, t)
    dx, dw = fce.fce_backward(x, w, t, lse_r, dl)
    # the library's count: the forward, and dlogits, dx and dW of each
    # chunk
    assert fce.tma_launches - n0 == (1 + 3 * fce.vocab_chunks(V) if tma
                                     else 0)
    dx_r = fce.fce_backward_dx_reference(x, w, t, lse_r, dl)
    dw_r = fce.fce_backward_dw_reference(x, w, t, lse_r, dl)
    torch.cuda.synchronize()
    for name, out, ref in (("lse", lse, lse_r), ("tl", tl, tl_r)):
        err = ((out - ref).abs().max() / ref.abs().max()).item()
        assert err <= 1e-5, (name, err)
    for name, out, ref in (("dx", dx, dx_r), ("dw", dw, dw_r)):
        assert out.shape == ref.shape and out.dtype == ref.dtype, name
        assert torch.isfinite(out.float()).all(), name
        err = _rel_err(out, ref, torch.bfloat16)
        assert err <= 2e-2, (name, err)
    assert (dx[t < 0] == 0).all()
    lse2, tl2 = fce.fce_forward(x, w, t)
    dx2, dw2 = fce.fce_backward(x, w, t, lse_r, dl)
    for a, b in ((lse, lse2), (tl, tl2), (dx, dx2), (dw, dw2)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_ce_autograd_on_the_card_matches_the_cpu_function():
    """The same Function on CUDA tensors (the kernels) and on CPU tensors
    (the plain versions), fp32, two vocabulary chunks; reruns on the card
    are bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, w, t, dl = _fce_inputs(4, 256, 128, 9000, torch.float32)
    runs = []
    for dev in ("cuda", "cpu", "cuda"):
        xx = x.detach().to(dev).requires_grad_()
        tab = w.t().detach().to(dev).requires_grad_()
        loss = fce.fused_linear_cross_entropy(xx, tab.t(), t.to(dev))
        (loss * dl.to(dev)).sum().backward()
        runs.append([a.cpu() for a in (loss.detach(), xx.grad, tab.grad)])
    for a, b in zip(runs[0], runs[1]):
        assert (a - b).abs().max().item() <= 1e-4 * max(
            b.abs().max().item(), 1.0)
    for a, b in zip(runs[0], runs[2]):
        assert torch.equal(a, b)


def _decode_inputs(seed, B, S, H, KV, D, dtype, quant):
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.randn(B, 1, H, D).astype(np.float32))
    k = torch.from_numpy(rng.randn(B, S, KV, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(B, S, KV, D).astype(np.float32))
    if not quant:
        return (q.to(dev, dtype), k.reshape(B, S, -1).to(dev, dtype),
                v.reshape(B, S, -1).to(dev, dtype), None, None)
    kq, ks = _quantize_kv(k)
    vq, vs = _quantize_kv(v)
    return (q.to(dev, dtype), kq.reshape(B, S, -1).to(dev),
            vq.reshape(B, S, -1).to(dev), ks.to(dev), vs.to(dev))


# (B, S, H, KV, D, pos, window, plan): the decode cases, by id
DECODE_CASES = [
    (8, 2048, 32, 8, 64, 2047, None, "long"),  # Llama-3.2-1B, full cache:
                                               # ring splits of >= 8 chunks
    (1, 2048, 32, 8, 64, 1300, None, "ragged"),  # 21 chunks: a short split
    (8, 2048, 32, 8, 64, 1000, 256, None),     # window
    (3, 2000, 8, 2, 128, 1999, None, None),    # ragged tail, head_dim 128
    (2, 160, 4, 4, 16, 150, None, None),       # MHA, head_dim 16
    (4, 300, 32, 1, 64, 0, None, None),        # MQA (two row tiles), pos 0
    (2, 513, 4, 4, 32, 300, 48, None),         # head_dim 32, window
    (4, 1024, 12, 12, 64, 1023, None, None),   # GPT-2 small: G = 1, 12 heads
]
DECODE_MODES = [(torch.float32, False), (torch.bfloat16, False),
                (torch.float32, True), (torch.bfloat16, True)]


def _case_key(case, dtype, quant) -> str:
    return "-".join(map(str, case[:7])) + f"/{dtype}/{quant}"


def _decode_call(case, dtype, quant, seed=6):
    B, S, H, KV, D, pos, window, _ = case
    q, ck, cv, ks, vs = _decode_inputs(seed, B, S, H, KV, D, dtype, quant)
    return lambda: da.decode_attention(q, ck, cv, pos, k_scale=ks,
                                       v_scale=vs, window=window)


def print_decode_kernel_names():
    """Print, as one JSON line, the decode kernels (profiler names) one
    call of every case launched, keyed ``"case/dtype/quant"``.  Run in a
    fresh process (a long pytest process's profiler can stop recording
    device events, as chip_smoke's long run's does), under ONE profiler
    session: a process that opened some twenty sessions saw an empty one.
    Every call starts with its main kernel (``decode_ring_kernel`` or
    ``decode_attention_kernel``) and the first design's combine kernel
    follows it, so the kernels in launch order split into the calls; a
    profile that lost a main kernel cannot be split and prints no names."""
    import json

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = [(_case_key(case, dtype, quant),
              _decode_call(case, dtype, quant))
             for case in DECODE_CASES for dtype, quant in DECODE_MODES]
    for _, call in calls:
        call()                 # build and warm, outside the profile
    lead = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead.add_(1)           # the profiler can miss its first kernel
        torch.cuda.synchronize()
        for _, call in calls:
            call()
            torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and "decode_" in e.name),
                     key=lambda e: e.time_range.start)
    groups = []
    for e in kernels:
        if "decode_attention_combine" in e.name and groups:
            groups[-1].append(e.name)
        else:
            groups.append([e.name])
    print(json.dumps({"keys": [k for k, _ in calls], "groups": groups}))


@pytest.fixture(scope="module")
def decode_kernel_names():
    """The profiler names of every decode case's kernels, taken once in
    a fresh process (``print_decode_kernel_names``)."""
    import json
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path.insert(0, {!r}); "
            "import test_torch_kernels_cuda as t; "
            "t.print_decode_kernel_names()").format(here)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600,
                          cwd=os.path.dirname(here))
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(got["groups"]) == len(got["keys"]), (
        f"the profile holds {len(got['groups'])} decode calls, "
        f"{len(got['keys'])} were made: {got['groups']}")
    return dict(zip(got["keys"], got["groups"]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,quant", DECODE_MODES)
@pytest.mark.parametrize("B,S,H,KV,D,pos,window,plan", DECODE_CASES)
def test_decode_attention_kernel_matches_plain_version(dtype, quant, B, S, H,
                                                       KV, D, pos, window,
                                                       plan,
                                                       decode_kernel_names):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, ck, cv, ks, vs = _decode_inputs(6, B, S, H, KV, D, dtype, quant)
    ring = dtype == torch.bfloat16
    lo = (max(pos - window + 1, 0) if window else 0) // da.CHUNK
    n = pos // da.CHUNK - lo + 1
    nsplit, per = da._splits(B, KV, n, torch.cuda.get_device_properties(
        0).multi_processor_count, ring)
    if ring and plan == "long":
        assert nsplit > 1 and per >= da.RING_MIN_CHUNKS
    elif ring and plan == "ragged":
        assert nsplit > 1 and n % per != 0

    def call(ck=ck, cv=cv):
        return da.decode_attention(q, ck, cv, pos, k_scale=ks, v_scale=vs,
                                   window=window)

    before, by = da.launches, dict(da.design_launches)
    out = call()
    # the library's own counts, by design: one ring launch (its split
    # merge inside), or the first design's kernel and, where it splits,
    # its combine kernel
    assert da.launches == before + 1
    took = [da.design_launches[k] - by[k] for k in da.COUNTS]
    assert took == da._kernels_for(ring, nsplit, False), took
    assert took == ([1, 0, 0, 0] if ring else [0, 1, int(nsplit > 1), 0])
    # and by the profiler, in a fresh process: never an empty profile
    names = decode_kernel_names[_case_key(
        (B, S, H, KV, D, pos, window), dtype, quant)]
    if ring:
        assert len(names) == 1 and "decode_ring_kernel" in names[0], names
    else:
        assert any("decode_attention_kernel" in k for k in names), names
        assert len(names) == (2 if nsplit > 1 else 1), names
    ref = da.decode_attention_reference(q, ck, cv, pos, k_scale=ks,
                                        v_scale=vs, window=window)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.isfinite(out.float()).all()
    if ring:
        ulps = _row_ulps(out, ref)
        assert ulps <= 2, ulps
    else:
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= 1e-4, err
    # a rerun, and the grouped [B, S, KV, D] view of the same cache, give
    # the same bits
    assert torch.equal(out, call())
    assert torch.equal(out, call(ck.view(B, S, KV, D), cv.view(B, S, KV, D)))


# the device form at the dense engine's shape: 8 slots at mixed depths
DEVICE_POS = [0, 15, 16, 63, 255, 1000, 1919, 2047]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,quant", DECODE_MODES)
@pytest.mark.parametrize("window", [None, 256])
def test_decode_attention_device_positions(dtype, quant, window):
    """A ``[B]`` position vector on the card: each slot against the plain
    version at its own position (phase 16's tolerances), reruns
    bit-identical, each slot's bits unchanged when the others' positions
    change, the tickets back at zero, the vector at 2047 everywhere
    bit-identical to the int call, and a CUDA graph captured once and
    replayed after the vector is rewritten in place (no host read)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, S, H, KV, D = 8, 2048, 32, 8, 64
    q, ck, cv, ks, vs = _decode_inputs(7, B, S, H, KV, D, dtype, quant)
    ring = dtype == torch.bfloat16
    posv = torch.tensor(DEVICE_POS, dtype=torch.int32, device="cuda")

    def call(p):
        return da.decode_attention(q, ck, cv, p, k_scale=ks, v_scale=vs,
                                   window=window)

    def check(out, p):
        ref = da.decode_attention_reference(q, ck, cv, p, k_scale=ks,
                                            v_scale=vs, window=window)
        assert torch.isfinite(out.float()).all()
        if ring:
            assert _row_ulps(out, ref) <= 2, _row_ulps(out, ref)
        else:
            err = (out.float() - ref.float()).abs().max().item()
            assert err <= 1e-4, err

    nsplit, _ = da._splits(B, KV, da._max_chunks(S, window),
                           torch.cuda.get_device_properties(
                               0).multi_processor_count, ring)
    by = dict(da.design_launches)
    out = call(posv)
    took = [da.design_launches[k] - by[k] for k in da.COUNTS]
    assert took == da._kernels_for(ring, nsplit, True), took
    check(out, posv)
    assert torch.equal(out, call(posv))
    # every slot's bits alone: the others moved to other depths
    other = torch.tensor(DEVICE_POS[::-1], dtype=torch.int32, device="cuda")
    for b in range(B):
        moved = other.clone()
        moved[b] = posv[b]
        assert torch.equal(call(moved)[b], out[b]), b
    torch.cuda.synchronize()
    if ring and nsplit > 1:
        assert not da._tickets[q.device][:B * KV].any()
    full = torch.full((B,), S - 1, dtype=torch.int32, device="cuda")
    assert torch.equal(call(full), call(S - 1))
    # one capture, replayed at new positions written into the same vector
    live = posv.clone()
    call(live)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call(live)
    for p in (DEVICE_POS, DEVICE_POS[::-1], [2047] * B, [5] * B):
        live.copy_(torch.tensor(p, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        check(got, live)
        assert torch.equal(got, call(live))


# the gather fallback's int8 rows: the paged pool's blocks gathered up to
# the high-water bucket (a power of two times block 16), 8 slots at
# positions inside it, one launch at the position vector
GATHER_ROWS = [16, 64, 256, 1024, 2048]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", GATHER_ROWS)
def test_decode_attention_at_gathered_row_shapes(S, dtype):
    """Row 7's int8 mode on gathered rows ``[8, S, KV*D]`` (S = the gather's
    high-water bucket x 16) at an ``[8]`` position vector, as the gather
    fallback calls it over an int8 pool: one launch reading the vector,
    each slot against the plain version at its position and against a
    one-slot int launch at the same S (phase 16's tolerances), reruns
    bit-identical, and each slot's bits unchanged when the other slots'
    positions change."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    B, H, KV, D = 8, 32, 8, 64
    q, ck, cv, ks, vs = _decode_inputs(12, B, S, H, KV, D, dtype, True)
    rng = np.random.RandomState(S)
    pos = sorted(set([0, S - 1] + rng.randint(0, S, size=6).tolist()))
    pos = (pos * B)[:B]
    posv = torch.tensor(pos, dtype=torch.int32, device="cuda")
    ring = dtype == torch.bfloat16

    def call(p, sel=slice(None)):
        return da.decode_attention(q[sel], ck[sel], cv[sel], p,
                                   k_scale=ks[sel], v_scale=vs[sel])

    def close(out, ref):
        if ring:
            assert _row_ulps(out, ref) <= 2, _row_ulps(out, ref)
        else:
            err = (out.float() - ref.float()).abs().max().item()
            assert err <= 1e-4, err

    by = dict(da.design_launches)
    out = call(posv)
    took = [da.design_launches[k] - by[k] for k in da.COUNTS]
    nsplit, _ = da._splits(B, KV, da._max_chunks(S, None),
                           torch.cuda.get_device_properties(
                               0).multi_processor_count, ring)
    assert took == da._kernels_for(ring, nsplit, True), took
    assert torch.isfinite(out.float()).all()
    close(out, da.decode_attention_reference(q, ck, cv, posv, k_scale=ks,
                                             v_scale=vs))
    assert torch.equal(out, call(posv))
    for b in range(B):
        close(out[b:b + 1], call(pos[b], slice(b, b + 1)))
        moved = torch.tensor(pos[::-1], dtype=torch.int32, device="cuda")
        moved[b] = pos[b]
        assert torch.equal(call(moved)[b], out[b]), b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_paged_int8_rows_at_tp2_are_tp1(dtype):
    """The gather fallback over an int8 pool on the card: every slot's rows
    gathered in one batch reach the decode kernel at the position vector
    (one launch a layer); the same bytes cut into two per-shard pools
    gather into the same rows, contiguous, so tp = 2 gives tp = 1's
    logits bit for bit; the written rows scatter back per shard."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from byteps_tpu_torch.models import transformer as tm
    from byteps_tpu_torch.serving.blocks import init_paged_cache

    cfg = tm.TransformerConfig(vocab_size=300, num_layers=2, num_heads=8,
                               num_kv_heads=2, d_model=256, d_ff=512,
                               max_seq_len=256, pos_emb="rope", dtype=dtype)
    model = tm.Transformer(cfg, device="cuda", param_dtype=dtype)
    tm.init_weights(model, 3)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    pools = {tp: init_paged_cache(cfg, 40, 16, kv_dtype="int8", tp=tp,
                                  device="cuda") for tp in (1, 2)}
    for l1, l2 in zip(pools[1], pools[2]):
        for n, t in l1.items():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                      device="cuda", dtype=torch.int8))
            else:
                t.copy_(torch.rand(t.shape, generator=gen, device="cuda")
                        * 0.02 + 1e-3)
            # shard s holds KV heads [s * KV/2, (s+1) * KV/2)
            l2[n].copy_(t.reshape(*t.shape[:2], 2, -1).permute(2, 0, 1, 3))
    tables = torch.arange(1, 33, dtype=torch.int32,
                          device="cuda").reshape(4, 8)
    pos = torch.tensor([5, 40, 77, 120], dtype=torch.int32, device="cuda")
    toks = torch.randint(0, 300, (4, 1), generator=gen, device="cuda")
    out = {}
    for tp in (1, 2):
        launches = da.design_launches["device_pos"]
        logits, rows = model.decode_paged(toks, pools[tp], tables, pos,
                                          hw_blocks=8, tp=tp)
        assert da.design_launches["device_pos"] - launches == 2
        assert all(t.is_contiguous() for r in rows for t in r.values())
        out[tp] = (logits, rows)
    assert torch.equal(out[1][0], out[2][0])
    for r1, r2 in zip(out[1][1], out[2][1]):
        for n in r1:
            assert torch.equal(r1[n], r2[n]), n
    wblk = tables.gather(1, (pos // 16).long()[:, None])
    tm.scatter_paged_rows(pools[2], out[2][1], pos[:, None], wblk,
                          (pos % 16)[:, None], 2)
    tm.scatter_paged_rows(pools[1], out[1][1], pos[:, None], wblk,
                          (pos % 16)[:, None], 1)
    for l1, l2 in zip(pools[1], pools[2]):
        for n, t in l1.items():
            assert torch.equal(
                t.reshape(*t.shape[:2], 2, -1).permute(2, 0, 1, 3), l2[n])


@pytest.mark.cuda
def test_spec_on_an_int8_gather_pool_is_refused_on_the_card():
    """JAX's refusal where the decode kernel serves tq = 1: speculation
    over the gather on an int8 pool (its tick and its verify would attend
    by different sums); the paged kernel takes it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from byteps_tpu_torch.models import transformer as tm
    from byteps_tpu_torch.serving import ServingEngine

    cfg = tm.TransformerConfig(vocab_size=64, num_layers=1, num_heads=2,
                               d_model=64, d_ff=64, max_seq_len=64,
                               dtype=torch.float32)
    model = tm.Transformer(cfg, device="cuda")
    kw = dict(n_slots=2, paged=True, block=16, kv_dtype="int8", spec_k=4,
              device="cuda")
    with pytest.raises(ValueError, match="requires the fused paged kernel"):
        ServingEngine(model, paged_kernel="off", **kw)
    assert ServingEngine(model, **kw).paged_kernel


def _quant_inputs(seed, M, N, K, dtype, bias):
    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(dev, dtype)
    w, scale = qd.quantize_weight(torch.from_numpy(
        (rng.randn(N, K) * 0.02).astype(np.float32)))
    b = (torch.from_numpy(rng.randn(N).astype(np.float32)).to(dev)
         if bias else None)
    return x, w.to(dev), scale.to(dev), b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("M,N,K,bias", [
    (8, 2048, 2048, False),     # decode: split-K over one row of tiles
    (8, 512, 2048, True),       # decode k/v projection, bias
    (300, 1000, 200, True),     # ragged rows, columns and depth
    (300, 8192, 2048, False),   # the MLP up projection
    (5, 96, 40, False),         # K % 16 != 0: scalar loads
])
def test_quant_linear_kernel_matches_plain_version(dtype, out_dtype, M, N, K,
                                                   bias):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, w, scale, b = _quant_inputs(8, M, N, K, dtype, bias)
    before = qd.launches
    out = qd.quant_linear(x, w, scale, b, out_dtype)
    torch.cuda.synchronize()
    assert qd.launches == before + 1
    ref = qd.quant_linear_reference(x, w, scale, b, out_dtype)
    assert out.shape == ref.shape and out.dtype == ref.dtype == out_dtype
    assert torch.isfinite(out.float()).all()
    top = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    tol = (torch.finfo(torch.bfloat16).eps if dtype == torch.bfloat16
           else 1e-5) * top
    assert err <= tol, (err, tol)
    # reruns are bit-identical (split-K adds the splits in order)
    assert torch.equal(out, qd.quant_linear(x, w, scale, b, out_dtype))


# Llama-3.2-1B's projections (K, N), and ragged N and K (K % 64 != 0)
QUANT_SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
                (208, 1000)]


def _quant_check(out, ref, dtype):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.isfinite(out.float()).all()
    top = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    tol = (torch.finfo(torch.bfloat16).eps if dtype == torch.bfloat16
           else 1e-5) * top
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("bias,out_dtype", [
    (False, torch.bfloat16), (True, torch.bfloat16), (True, torch.float32)])
@pytest.mark.parametrize("K,N", QUANT_SHAPES)
@pytest.mark.parametrize("M", [1, 8, 16, 40, 64, 65, 300, 4096])
def test_quant_linear_designs_match_plain_version(M, K, N, bias, out_dtype):
    """bf16 x: rows up to 64 on the swap design (one launch, the split
    merge inside), more on the TMA + wgmma one; the design the rule names
    is the one the library launched; reruns bit-identical; the swap
    design's tickets all back at zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, w, scale, b = _quant_inputs(M + K, M, N, K, torch.bfloat16, bias)
    want = qd.SWAP if M <= qd.SWAP_MAX_ROWS else qd.TMA
    before = dict(qd.design_launches)
    out = qd.quant_linear(x, w, scale, b, out_dtype)
    torch.cuda.synchronize()
    took = {k: qd.design_launches[k] - before[k] for k in qd.DESIGNS}
    assert took == {k: int(i == want) for i, k in enumerate(qd.DESIGNS)}
    _quant_check(out, qd.quant_linear_reference(x, w, scale, b, out_dtype),
                 torch.bfloat16)
    assert torch.equal(out, qd.quant_linear(x, w, scale, b, out_dtype))
    torch.cuda.synchronize()
    if want == qd.SWAP:
        assert not qd._tickets[x.device].any()


@pytest.mark.cuda
def test_quant_tickets_are_zero_after_calls_of_many_shapes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    outs = []
    for M, K, N in [(8, 2048, 512), (3, 8192, 2048), (64, 2048, 2048),
                    (8, 768, 3072), (33, 1024, 1000)]:
        x, w, scale, _ = _quant_inputs(M, M, N, K, torch.bfloat16, False)
        assert qd._swap_plan(M, N, K, torch.cuda.get_device_properties(
            0).multi_processor_count)[0] > 1
        outs.append(qd.quant_linear(x, w, scale))
    torch.cuda.synchronize()
    assert not qd._tickets[torch.device("cuda", 0)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,design", [
    (8, 2048, 2048, qd.TILE), (8, 2048, 512, qd.TILE),
    (4096, 2048, 2048, qd.TILE), (300, 208, 1000, qd.TMA),
    (64, 208, 1000, qd.SWAP), (8, 2048, 2048, qd.TMA)])
def test_quant_linear_named_design_matches_plain_version(M, K, N, design):
    """Each design named at shapes the rule may give another: the first
    design at decode and prefill rows, tma at 8 and 300 rows, swap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, w, scale, b = _quant_inputs(3, M, N, K, torch.bfloat16, True)
    before = qd.design_launches[qd.DESIGNS[design]]
    out = qd.quant_linear_design(x, w, scale, b, design=design)
    torch.cuda.synchronize()
    assert qd.design_launches[qd.DESIGNS[design]] > before
    _quant_check(out, qd.quant_linear_reference(x, w, scale, b),
                 torch.bfloat16)
    assert torch.equal(out, qd.quant_linear_design(x, w, scale, b,
                                                   design=design))


@pytest.mark.cuda
def test_quant_rule_is_the_library_rule_and_refusals_raise():
    """The C ``choose`` and the Python ``_design`` agree (the pointers are
    only read for their alignment); a design that does not take a shape
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lib = qd._library()
    for dt in (torch.float32, torch.bfloat16):
        for M in (1, 64, 65, 4096):
            for N, K in ((2048, 2048), (1001, 2048), (512, 40)):
                for xp, wp, op in ((16, 32, 48), (16, 33, 48), (16, 32, 50),
                                   (8, 32, 48)):
                    assert lib.bps_quant_dot_choose(
                        int(dt == torch.bfloat16), M, N, K, xp, wp, op) == \
                        qd._design(dt, M, N, K, xp, wp, op)
    x, w, scale, _ = _quant_inputs(2, 65, 512, 2048, torch.bfloat16, False)
    with pytest.raises(RuntimeError, match="swap launch failed"):
        qd.quant_linear_design(x, w, scale, design=qd.SWAP)
    xf = x.float()
    with pytest.raises(RuntimeError, match="tma launch failed"):
        qd.quant_linear_design(xf, w, scale, design=qd.TMA)


@pytest.mark.cuda
def test_quant_unaligned_weight_takes_the_tile_design():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, w, scale, _ = _quant_inputs(4, 8, 512, 2048, torch.bfloat16, False)
    buf = torch.empty(w.numel() + 1, dtype=torch.int8, device=w.device)
    wu = buf[1:].view(w.shape)
    wu.copy_(w)
    assert wu.data_ptr() % 16 and wu.is_contiguous()
    before = qd.design_launches["tile"]
    out = qd.quant_linear(x, wu, scale)
    torch.cuda.synchronize()
    assert qd.design_launches["tile"] > before
    assert torch.equal(out, qd.quant_linear_design(x, w, scale,
                                                   design=qd.TILE))


@pytest.mark.cuda
def test_new_wrappers_raise_on_mixed_devices():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, ck, cv, _, _ = _decode_inputs(1, 2, 64, 4, 2, 16, torch.float32, False)
    with pytest.raises(ValueError, match="one CUDA device"):
        da.decode_attention(q, ck.cpu(), cv, 10)
    x, w, scale, _ = _quant_inputs(1, 4, 32, 64, torch.bfloat16, False)
    with pytest.raises(ValueError, match="one CUDA device"):
        qd.quant_linear(x, w.cpu(), scale)
    with pytest.raises(ValueError, match="one CUDA device"):
        qd.quant_linear(x.cpu(), w, scale)


@pytest.mark.cuda
def test_disagg_ship_and_adoption_on_the_card():
    """Two CUDA paged engines (tiny fp32 model) behind two frontends: each
    prompt's prefill leg ships its KV to the decode replica, whose resume
    leg adopts the blocks.  Tokens equal a colocated engine's; paged
    launches = the decode replica's ticks x layers (the prefill replica
    never decodes); both pools back at their base."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.serving import (RemoteServeClient, ServeMetrics,
                                          ServingEngine, serve)

    cfg = TransformerConfig(vocab_size=97, num_layers=2, num_heads=4,
                            num_kv_heads=2, d_model=64, d_ff=128,
                            max_seq_len=128, dtype=torch.float32)
    model = Transformer(cfg, device="cuda")
    init_weights(model, 3)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 97, size=(n,)).astype(np.int32)
               for n in (16, 23, 40)]

    def engine():
        return ServingEngine(model, n_slots=4, max_seq=128, paged=True,
                             block=16, device="cuda", metrics=ServeMetrics())

    solo = engine()
    reqs = [solo.submit(p, 12) for p in prompts]
    solo.drain(timeout=120)
    want = [r.result().tolist() for r in reqs]
    engines = [engine(), engine()]
    base = [e.pool.alloc.used_count for e in engines]
    srvs = [serve(e, 0, host="127.0.0.1", in_thread=True) for e in engines]
    addrs = [f"127.0.0.1:{s.server_address[1]}" for s, _ in srvs]
    try:
        ticks0 = engines[1].decode_ticks
        before = pa.launches
        got = []
        for i, p in enumerate(prompts):
            c = RemoteServeClient(addrs[0], timeout=120)
            first, info = c.prefill_ship(p, ship_to=addrs[1],
                                         kv_ship=f"s{i}")
            c.close()
            assert info["shipped"] and info["blocks"] == -(-len(p) // 16)
            d = RemoteServeClient(addrs[1], timeout=120)
            got.append([int(first[0])] + list(d.stream(
                p, 12, resume=[int(first[0])], extra={"kv_ship": f"s{i}"})))
            d.close()
        torch.cuda.synchronize()
        ticks = engines[1].decode_ticks - ticks0
        assert got == want
        assert engines[0].decode_ticks == 0
        assert engines[1].step_counts()["prefill_chunks"] == 0
        assert ticks > 0 and pa.launches - before == ticks * cfg.num_layers
        assert [e.pool.alloc.used_count for e in engines] == base
    finally:
        for s, t in srvs:
            s.shutdown()
            s.server_close()
            t.join(timeout=30)


@pytest.mark.cuda
def test_ship_copies_wait_for_writes_queued_on_the_tick_stream():
    """A block freed while a K/V write into it is still queued on the
    default stream (a prefill chunk's, its request then cancelled) and
    staged at once for a ship: the ship's write lands after the queued
    one, never under it; and a parked block's extract reads what the
    default stream queued before it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig)
    from byteps_tpu_torch.serving import ServingEngine

    cfg = TransformerConfig(vocab_size=97, num_layers=2, num_heads=4,
                            num_kv_heads=2, d_model=64, d_ff=128,
                            max_seq_len=128, dtype=torch.float32)
    e = ServingEngine(Transformer(cfg, device="cuda"), n_slots=2,
                      max_seq=128, paged=True, block=16, device="cuda")
    nbytes = sum(int(np.prod(shape)) * dt.itemsize
                 for layer in e.kv_block_schema() for _, shape, dt in layer)
    rows = torch.randn(nbytes // 4).view(torch.uint8).reshape(1, nbytes)
    [bid] = e.stage_alloc(1)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)         # ~0.1 s of the default stream
    for layer in e.pool.caches:
        for c in layer.values():
            c[bid].fill_(7.0)
    e.release_kv_ids([bid])
    assert e.stage_alloc(1) == [bid]
    e.write_kv_payloads([bid], rows)
    torch.cuda.synchronize()
    assert torch.equal(e.extract_kv_payloads([bid]), rows)
    torch.cuda._sleep(200_000_000)
    for layer in e.pool.caches:
        for c in layer.values():
            c[bid].fill_(3.0)
    got = e._split_rows(e.extract_kv_payloads([bid]))
    assert all(bool((t == 3.0).all()) for layer in got for t in layer.values())
    e.release_kv_ids([bid])


@pytest.mark.cuda
def test_router_fails_a_stream_over_across_a_replica_kill_on_the_card():
    """A port router over two CUDA paged replicas (tiny fp32 model): the
    replica holding a stream is killed after 3 tokens and the router
    re-dispatches it with ``resume`` to the survivor.  The spliced stream
    equals its own control (the tokens received, then the survivor's own
    resumed continuation, alone); every paged-attention call of the run
    was a kernel launch (launches = the replicas' decode ticks x layers,
    no plain call)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from byteps_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig,
                                                     init_weights)
    from byteps_tpu_torch.observability.metrics import MetricsRegistry
    from byteps_tpu_torch.resilience.policy import RetryPolicy
    from byteps_tpu_torch.serving import (RemoteServeClient, ServeMetrics,
                                          ServeRouter, ServingEngine, serve)
    from byteps_tpu_torch.serving import router as rt

    cfg = TransformerConfig(vocab_size=97, num_layers=2, num_heads=4,
                            num_kv_heads=2, d_model=64, d_ff=128,
                            max_seq_len=128, dtype=torch.float32)
    model = Transformer(cfg, device="cuda")
    init_weights(model, 5)
    prompt = np.random.RandomState(6).randint(0, 97, (23,)).astype(np.int32)
    engines = [ServingEngine(model, n_slots=2, max_seq=128, paged=True,
                             block=16, device="cuda", metrics=ServeMetrics())
               for _ in range(2)]
    resumed = []
    for e in engines:
        submit = e.submit

        def recording(p, n, _submit=submit, **kw):
            if kw.get("resume_tokens") is not None:
                resumed.append(len(kw["resume_tokens"]))
            return _submit(p, n, **kw)

        e.submit = recording
    srvs = [serve(e, 0, host="127.0.0.1", in_thread=True) for e in engines]
    addrs = [f"127.0.0.1:{s.server_address[1]}" for s, _ in srvs]
    router = ServeRouter(addrs, credits=2, deadline=120.0,
                         stream_timeout=60.0, ping_timeout=30.0,
                         registry=MetricsRegistry(),
                         retry=RetryPolicy(max_attempts=6, backoff_base=0.02,
                                           jitter=0.0, backoff_cap=0.2,
                                           deadline=0.0)).start()
    try:
        torch.cuda.synchronize()
        ticks0 = sum(e.decode_ticks for e in engines)
        pa.launches = pa.plain_calls = 0
        got, killed = [], None
        for tok in router.stream(prompt, 24, rid="k"):
            got.append(int(tok))
            if len(got) == 3:
                killed = router._inflight["k"]["r"]
                srvs[killed][0].kill()
        survivor = 1 - killed
        c = RemoteServeClient(addrs[survivor], timeout=120)
        k = resumed[-1]
        control = got[:k] + [int(t) for t in c.stream(
            prompt, 24, resume=got[:k])]
        c.close()
        torch.cuda.synchronize()
        ticks = sum(e.decode_ticks for e in engines) - ticks0
        assert len(got) == 24 and got == control
        assert router.stats()[rt.REDISPATCHES] >= 1
        assert pa.plain_calls == 0
        assert ticks > 0 and pa.launches == ticks * cfg.num_layers
    finally:
        router.close()
        for s, t in srvs:
            s.shutdown()
            s.server_close()
            t.join(timeout=30)


@pytest.mark.cuda
def test_eager_api_at_one_worker_on_nccl():
    """``api.init()`` on ``cuda`` takes ``nccl``; declare, push_pull
    (average on and off), the async handle, the sparse sum, broadcast and
    broadcast_parameters give what a world of one must, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from byteps_tpu_torch import api

    api.init()
    try:
        assert (api.size(), api.backend()) == (1, "nccl")
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(4099, device="cuda", generator=g)
        assert api.declare("x") == 0
        assert torch.equal(api.push_pull(x, name="x"), x)
        assert torch.equal(api.push_pull(x, average=False, name="y"), x)
        h = api.push_pull_async(x, name="z")
        out = api.synchronize(h)
        assert torch.equal(out, x)
        idx = torch.tensor([3, 3, 7], device="cuda")
        vals = torch.randn(3, 8, device="cuda", generator=g)
        want = torch.zeros(10, 8, device="cuda")
        want[3] = vals[0] + vals[1]
        want[7] = vals[2]
        assert torch.equal(api.push_pull_sparse(idx, vals, 10), want)
        assert torch.equal(api.broadcast(x), x)
        m = torch.nn.Linear(8, 8).cuda()
        assert api.broadcast_parameters(m) is m
    finally:
        api.shutdown()


def _gloo_shard_on_cuda(rank, world):
    from byteps_tpu_torch import api
    from byteps_tpu_torch.parallel import collectives as C

    api.init(device="cuda", backend="gloo")
    rng = np.random.RandomState(40 + rank)
    host = rng.randn(1001).astype(np.float32)
    x = torch.from_numpy(host).cuda()
    y = C.push_pull_shard(x, api.mesh().group("dp"))
    ybf = C.push_pull_shard(x, api.mesh().group("dp"), average=True,
                            wire_dtype=torch.bfloat16)
    return (host, y.cpu().numpy(), ybf.cpu().numpy(), y.is_cuda,
            api.backend())


@pytest.mark.cuda
def test_two_gloo_processes_push_pull_shard_on_cuda_tensors():
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    GPU): reduce-scatter and all-gather take the CUDA tensors directly,
    nothing is staged through host buffers, and the sum is the host sum's
    bits (two terms)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch_dist_workers import run_workers

    res = run_workers(2, _gloo_shard_on_cuda)
    want = res[0][0] + res[1][0]
    wbf = ((torch.from_numpy(res[0][0]).bfloat16()
            + torch.from_numpy(res[1][0]).bfloat16()) / 2).float().numpy()
    for host, y, ybf, on_cuda, backend in res:
        assert on_cuda and backend == "gloo"
        np.testing.assert_array_equal(y, want)
        np.testing.assert_array_equal(ybf, wbf)
    print("gloo on CUDA tensors: host staging used: no")
