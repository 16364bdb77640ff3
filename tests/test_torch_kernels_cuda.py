"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the GPU.  Imports torch and the port only (no JAX), so it
runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a GPU every test here skips.  Tolerances: fp32 1e-4 (online vs
dense softmax accumulation order); bf16 2e-2 (p is rounded to bf16
before the PV product, so a bf16 ulp of a probability reaches the
output).
"""

import numpy as np
import pytest
import torch

from byteps_tpu_torch.ops import paged_attention as pa


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
                                        (4, 4, 64, 8), (32, 1, 64, 16)])
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
