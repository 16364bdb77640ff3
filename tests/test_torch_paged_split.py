"""The paged-attention kernel's split of the block axis, on the CPU: the
host-side plan (``ops/paged_attention.py:split_plan``) and the launch that
carries it (``_launch``, driven through a stand-in for the CUDA library,
so that it runs without a card).

* every logical block of every slot falls in exactly one live split (the
  kernel's range arithmetic, restated below), and no split is empty;
* the plan is the same for tp 1, 2 and 4 (it takes the total KV heads),
  so one launch over per-shard pools does the unsharded arithmetic;
* the plan and the launch read no value of ``pos`` or ``table``: the
  plan runs on tensors without storage, the launch on tensors that refuse
  every value read — so a tick's launches can be captured in a CUDA graph.
"""

import numpy as np
import pytest
import torch

from byteps_tpu_torch.ops import paged_attention as pa


def _meta(B, tq, H, KV, D, block, max_blocks, tp=1, n_blocks=33):
    q = torch.empty(B, tq, H, D, device="meta")
    if tp == 1:
        ck = torch.empty(n_blocks, block, KV * D, device="meta")
    else:
        ck = torch.empty(tp, n_blocks, block, KV // tp * D, device="meta")
    table = torch.empty(B, max_blocks, dtype=torch.int32, device="meta")
    return q, ck, table


def _live_blocks(p, tq, window, block, max_blocks, nsplit, per):
    """The blocks each CTA of one (slot, KV head) reads, as the kernel
    computes them from the cursor ``p``; returns (blocks in split order,
    the slot's readable range)."""
    j_hi = min((p + tq - 1) // block, max_blocks - 1)
    j_lo = max(p - window + 1, 0) // block if window else 0
    s_lo, s_hi = j_lo // per, j_hi // per
    seen = []
    for s in range(nsplit):
        if s < s_lo or s > s_hi:
            continue                            # exits at once
        j0, j1 = max(j_lo, s * per), min(j_hi, s * per + per - 1)
        assert j0 <= j1, (s, j0, j1)            # a live split reads a block
        seen += range(j0, j1 + 1)
    return seen, (j_lo, j_hi)


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("B,KV,max_blocks", [
    (8, 8, 128),     # Llama-3.2-1B serving: 8 slots, 2048 keys, block 16
    (8, 8, 130),     # max_blocks not a multiple of the split
    (8, 2, 32),      # block 64 at 2048 keys
    (1, 1, 1),       # one block
    (64, 8, 7),      # more CTAs than the aim: one split
    (3, 4, 2048),    # a long table
])
def test_splits_cover_every_block_once(sms, B, KV, max_blocks):
    nsplit, per = pa.split_plan(*_meta(B, 1, KV * 4, KV, 64, 16, max_blocks),
                                sms)
    assert nsplit >= 1 and per >= 1
    assert nsplit * per >= max_blocks            # every block has a split
    assert (nsplit - 1) * per < max_blocks       # no split is empty
    owner = [j // per for j in range(max_blocks)]
    assert sorted(set(owner)) == list(range(nsplit))
    if B * KV < pa.CTAS_PER_SM * sms and max_blocks > 1:
        assert nsplit > 1                        # the card is filled
    rng = np.random.RandomState(max_blocks + sms)
    S = max_blocks * 16
    cursors = {0, 1, S - 1, S - 2, per * 16, per * 16 - 1, per * 16 + 1,
               *(int(x) for x in rng.randint(0, S, size=20))}
    for p in sorted(cursors):
        for tq in (1, 5):
            for window in (None, 1, 37, 256):
                seen, (lo, hi) = _live_blocks(p, tq, window, 16, max_blocks,
                                              nsplit, per)
                assert seen == list(range(lo, hi + 1)), (p, tq, window)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("B,tq,H,KV,D,block,max_blocks", [
    (8, 1, 32, 8, 64, 16, 128),
    (8, 5, 32, 8, 64, 16, 128),
    (3, 5, 8, 4, 128, 64, 32),
    (2, 1, 4, 4, 32, 8, 9),
])
def test_plan_is_the_same_for_every_tp(tp, B, tq, H, KV, D, block,
                                       max_blocks):
    whole = pa.split_plan(*_meta(B, tq, H, KV, D, block, max_blocks), 132)
    shards = pa.split_plan(*_meta(B, tq, H, KV, D, block, max_blocks, tp=tp),
                           132)
    assert shards == whole


class _NoValues(torch.Tensor):
    """A tensor whose values may not be read on the host: shapes, dtype,
    device and the data pointer only."""

    READS = {"item", "tolist", "numpy", "cpu", "cuda", "to", "__bool__",
             "__int__", "__float__", "__index__", "__iter__", "__getitem__",
             "__repr__", "__format__", "max", "min", "amax", "sum", "long",
             "int", "float", "eq", "__eq__", "any", "all", "clone",
             "contiguous"}

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in cls.READS:
            raise AssertionError(f"the launch read values: {name}")
        return super().__torch_function__(func, types, args, kwargs or {})


class _FakeLib:
    """Stands in for the CUDA library: records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def bps_paged_attention_smem(self, R, D, block, elt):
        return 1024

    def bps_paged_attention(self, *args):
        self.calls.append(args)
        return 0


class _Stream:
    cuda_stream = 0


def _launch_args(lib):
    """The launch's (B, tq, H, KV, tp, n_blocks, D, block, max_blocks,
    window, nsplit, per, dtype, quant) as the C function receives them."""
    return lib.calls[-1][10:24]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_launch_reads_no_cursor_or_table_value(monkeypatch, tp, quant):
    lib = _FakeLib()
    monkeypatch.setattr(pa, "_library", lambda: lib)
    monkeypatch.setattr(pa, "_tickets", {})
    monkeypatch.setattr(pa._build, "sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    B, tq, H, KV, D, block, max_blocks, n = 8, 5, 32, 8, 64, 16, 128, 40
    q = torch.zeros(B, tq, H, D, dtype=torch.bfloat16)
    pool_dtype = torch.int8 if quant else torch.bfloat16
    ck = torch.zeros(tp, n, block, KV // tp * D, dtype=pool_dtype)
    cv = torch.zeros_like(ck)
    scales = ((torch.zeros(tp, n, block, KV // tp),) * 2 if quant
              else (None, None))
    table = torch.zeros(B, max_blocks, dtype=torch.int32).as_subclass(
        _NoValues)
    pos = torch.full((B,), 3, dtype=torch.int32).as_subclass(_NoValues)
    before = pa.launches
    out = pa._launch(q, ck, cv, table, pos, *scales, 256)
    assert pa.launches == before + 1            # one launch at any tp
    assert out.shape == q.shape and out.dtype == q.dtype
    plan = pa.split_plan(q, ck, table, 132)
    assert _launch_args(lib) == (B, tq, H, KV, tp, n, D, block, max_blocks,
                                 256, *plan, 1, int(quant))
    # the unsharded launch of the same heads takes the same plan
    whole = _meta(B, tq, H, KV, D, block, max_blocks)
    assert pa.split_plan(*whole, 132) == plan
