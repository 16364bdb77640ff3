"""The port's paged attention (byteps_tpu_torch/ops/paged_attention.py)
held against the JAX kernel.

The same numpy inputs go through ``byteps_tpu``'s Pallas
``paged_decode_attention`` in interpret mode (how the JAX suite runs it
on the CPU) and through the port's wrapper on CPU tensors, which runs
the plain PyTorch version.  Tolerance 2e-5 absolute in fp32: the JAX
suite's own bound for an online-softmax kernel against a dense softmax
(tests/test_paged_attention.py), which is what the two compute here.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds
it against the plain version there, as does
tests/test_torch_kernels_cuda.py when a GPU is present.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops.paged_attention import paged_decode_attention
from byteps_tpu_torch.ops import paged_attention as pa

TOL = 2e-5


def _case(seed, B, tq, H, KV, D, blk, mb, pos, ragged=True):
    """Random flat pools and per-slot tables: each slot holds only the
    blocks covering ``pos + tq`` (ragged) or all ``mb`` (dense
    equivalent); the rest stay on the null block 0."""
    rng = np.random.RandomState(seed)
    n_blocks = 1 + B * mb
    q = rng.randn(B, tq, H, D).astype(np.float32)
    ck = rng.randn(n_blocks, blk, KV * D).astype(np.float32)
    cv = rng.randn(n_blocks, blk, KV * D).astype(np.float32)
    table = np.zeros((B, mb), np.int32)
    nxt = iter(rng.permutation(np.arange(1, n_blocks)))
    for b in range(B):
        need = -(-(int(pos[b]) + tq) // blk) if ragged else mb
        for j in range(need):
            table[b, j] = next(nxt)
    return q, ck, cv, table, np.asarray(pos, np.int32)


def _jax(q, ck, cv, table, pos, window):
    return np.asarray(paged_decode_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(table), jnp.asarray(pos), window=window,
        interpret=True))


def _port(q, ck, cv, table, pos, window):
    return pa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
        torch.from_numpy(table), torch.from_numpy(pos),
        window=window).numpy()


@pytest.mark.parametrize("KV", [4, 2, 1])
@pytest.mark.parametrize("tq", [1, 3])
@pytest.mark.parametrize("window", [None, 5])
def test_plain_version_matches_jax_kernel(KV, tq, window):
    """MHA (KV=4), GQA (KV=2) and MQA (KV=1) at H=4; ragged tables with
    null-padded tails and a slot at pos 0; cursors straddling block
    boundaries; with and without a sliding window."""
    pos = [0, 5, 11, 17]
    args = _case(KV * 10 + tq, 4, tq, 4, KV, 8, 4, 6, pos)
    np.testing.assert_allclose(_port(*args, window), _jax(*args, window),
                               atol=TOL, rtol=0)


def test_dense_equivalent_tables_match_jax_kernel():
    """Every table entry allocated (no null padding), GQA, tq=1."""
    args = _case(7, 3, 1, 4, 2, 8, 4, 5, [3, 9, 19], ragged=False)
    np.testing.assert_allclose(_port(*args, None), _jax(*args, None),
                               atol=TOL, rtol=0)


def test_cpu_wrapper_runs_plain_version_without_launching():
    args = _case(3, 2, 1, 4, 2, 8, 4, 4, [2, 9])
    before_l, before_p = pa.launches, pa.plain_calls
    tensors = [torch.from_numpy(a) for a in args]
    out = pa.paged_attention(*tensors)
    assert pa.launches == before_l
    assert pa.plain_calls == before_p + 1
    ref = pa.paged_attention_reference(*tensors)
    assert torch.equal(out, ref)


def test_wrapper_rejects_non_cpu_non_cuda_and_bad_shapes():
    q, ck, cv, table, pos = (torch.from_numpy(a) for a in
                             _case(4, 2, 1, 4, 2, 8, 4, 4, [2, 9]))
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention(q.to("meta"), ck, cv, table, pos)
    with pytest.raises(ValueError, match="kv_heads"):
        pa.paged_attention(q, ck[..., :12], cv[..., :12], table, pos)
    with pytest.raises(ValueError, match="window"):
        pa.paged_attention(q, ck, cv, table, pos, window=0)


@pytest.mark.parametrize("dtype,head_dim,block,match", [
    (torch.float16, 64, 16, "float32 or bfloat16"),
    (torch.float32, 48, 16, "head_dim"),
    (torch.bfloat16, 128, 65, "blocks"),
])
def test_kernel_config_refuses_what_the_kernel_does_not_take(
        dtype, head_dim, block, match):
    for d in (16, 32, 64, 128):  # 16 and 32: the serve role's defaults
        pa.check_kernel_config(torch.bfloat16, d, 16)
    pa.check_kernel_config(torch.float32, 128, 64)
    with pytest.raises(ValueError, match=match):
        pa.check_kernel_config(dtype, head_dim, block)


def test_cuda_path_raises_cleanly_without_a_gpu(monkeypatch):
    """Without nvcc the build raises a typed error instead of leaving a
    wrapper that could fall back; without a GPU the entry points refuse
    to run instead of moving to the CPU."""
    from byteps_tpu_torch.serving.engine import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the CPU-only host")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pa.build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA"):
        resolve_device("cuda")


def test_kv_bytes_read_counts_only_covered_blocks():
    # block 16, KV*D 512, bf16: pos 0 -> 1 block; pos 31 tq 1 -> 2;
    # window 8 at pos 40 -> blocks 2..2 only
    per = 16 * 512 * 2 * 2
    assert pa.kv_bytes_read([0, 31], 1, 16, 512, 2) == 3 * per
    assert pa.kv_bytes_read([40], 1, 16, 512, 2, window=8) == per
