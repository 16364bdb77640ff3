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
before each product, in both).  Decode attention (fp and int8 caches):
fp32 1e-4 absolute (online softmax over splits vs one dense softmax);
bf16 and int8 2e-2 of the largest reference magnitude (p is rounded to
bf16 before the PV product at other running maxima).  The int8 product:
bf16 within one bf16 ulp of the largest output (2^-7 of it: the same
rounding points on both sides, fp32 sums in other orders), fp32 within
1e-5 of the largest output.
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


@pytest.mark.cuda
def test_flash_autograd_on_the_card_matches_the_cpu_function():
    """The same Function on CUDA tensors (the kernels) and on CPU tensors
    (the plain versions), fp32, GQA, causal, lse variant with a nonzero
    lse cotangent; reruns on the card are bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, do, _, _ = _flash_inputs(3, 2, 150, 8, 2, 64, torch.float32,
                                      False, False)
    dlse = torch.randn(2, 150, 8, device="cuda")
    grads = []
    for dev in ("cuda", "cpu", "cuda"):
        qq, kk, vv = (t.detach().to(dev).requires_grad_() for t in (q, k, v))
        o, lse = fa.flash_attention_with_lse(qq, kk, vv, causal=True)
        torch.autograd.backward((o, lse), (do.to(dev), dlse.to(dev)))
        grads.append([t.cpu() for t in (o.detach(), lse.detach(), qq.grad,
                                        kk.grad, vv.grad)])
    for a, b in zip(grads[0], grads[1]):
        assert (a - b).abs().max().item() <= 1e-4
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,quant,tol", [
    (torch.float32, False, 1e-4), (torch.bfloat16, False, 2e-2),
    (torch.float32, True, 1e-4), (torch.bfloat16, True, 2e-2)])
@pytest.mark.parametrize("B,S,H,KV,D,pos,window", [
    (8, 2048, 32, 8, 64, 2047, None),    # Llama-3.2-1B, full cache
    (8, 2048, 32, 8, 64, 1000, 256),     # window
    (3, 2000, 8, 2, 128, 1999, None),    # ragged tail chunk, head_dim 128
    (2, 160, 4, 4, 16, 150, None),       # MHA, head_dim 16, S % 64 != 0
    (4, 300, 32, 1, 64, 0, None),        # MQA at pos 0
    (2, 513, 4, 4, 32, 300, 48),         # head_dim 32, window
])
def test_decode_attention_kernel_matches_plain_version(dtype, quant, tol, B,
                                                       S, H, KV, D, pos,
                                                       window):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, ck, cv, ks, vs = _decode_inputs(6, B, S, H, KV, D, dtype, quant)
    before = da.launches
    out = da.decode_attention(q, ck, cv, pos, k_scale=ks, v_scale=vs,
                              window=window)
    torch.cuda.synchronize()
    assert da.launches == before + 1
    ref = da.decode_attention_reference(q, ck, cv, pos, k_scale=ks,
                                        v_scale=vs, window=window)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    if dtype == torch.bfloat16:
        err /= ref.float().abs().max().item()
    assert err <= tol, err
    # the grouped [B, S, KV, D] view of the same cache gives the same bits
    again = da.decode_attention(q, ck.view(B, S, KV, D),
                                cv.view(B, S, KV, D), pos, k_scale=ks,
                                v_scale=vs, window=window)
    assert torch.equal(out, again)


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
