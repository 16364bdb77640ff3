"""The port's fused LM-head cross-entropy (byteps_tpu_torch/ops/
fused_cross_entropy.py) held against the JAX Pallas kernels of
byteps_tpu/ops/fused_cross_entropy.py.

On the CPU the port's wrapper runs its plain versions; the JAX kernels
run in interpret mode with explicit blocks (16 rows, 32 vocabulary
columns), as tests/test_fused_cross_entropy.py runs them.  Inputs come
from numpy with a fixed seed and go through both.  The loss and the
gradients of x and w (``jax.vjp`` with a non-uniform cotangent) compare
in fp32 within 1e-5: the two sum the same fp32 products in other orders
(blockwise online logsumexp vs chunked logsumexp), which moves results by
~1e-7.  bf16 inputs compare within 2e-2 (dlogits is rounded to bf16
before each product on both sides; the products sum in other orders).

Also: ignored (-100) rows give loss 0 and zero gradient; a vocabulary
the Pallas ``fit_block`` refuses (61) against dense ``F.cross_entropy``;
the autograd Function against dense autograd; ``gradcheck`` in fp64; the
chunked plain versions equal to one chunk; the rule that sends bf16
operands to the kernels on TMA and wgmma (read from dtypes, shapes,
strides and addresses, so CPU tensors show it) and the persistent
forward's vocabulary splits; the backward's prediction of TMA launches
(dlogits, dx and dW of every chunk) held to a stand-in library that
applies the C rule, on bf16, fp32 and a table of row stride H + 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from byteps_tpu.ops.fused_cross_entropy import \
    fused_linear_cross_entropy as jax_fce
from byteps_tpu_torch.ops import fused_cross_entropy as fce


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU tests run tiny torch ops beside other test workers: one
    intra-op thread each keeps them from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5


def _inputs(seed, N, H, V, ignore):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H).astype(np.float32)
    w = (rng.randn(H, V) * 0.1).astype(np.float32)
    t = rng.randint(0, V, size=N).astype(np.int32)
    if ignore:
        t[::4] = -100
    dl = np.linspace(0.1, 1.0, N).astype(np.float32)
    return x, w, t, dl


def _jax(x, w, t, dl, dtype=jnp.float32):
    loss, vjp = jax.vjp(lambda a, b: jax_fce(a, b, jnp.asarray(t), 16, 32),
                        jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    dx, dw = vjp(jnp.asarray(dl))
    return loss, dx, dw


def _port(x, w, t, dl, dtype=torch.float32):
    xx = torch.from_numpy(x).to(dtype).requires_grad_()
    ww = torch.from_numpy(w).to(dtype).requires_grad_()
    loss = fce.fused_linear_cross_entropy(xx, ww, torch.from_numpy(t))
    loss.backward(torch.from_numpy(dl))
    return loss.detach(), xx.grad, ww.grad


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if isinstance(
        a, jax.Array) else a.float().numpy()


@pytest.mark.parametrize("ignore", [False, True])
@pytest.mark.parametrize("N,H,V", [(32, 16, 64), (40, 24, 96)])
def test_plain_versions_match_the_jax_kernels(N, H, V, ignore):
    x, w, t, dl = _inputs(N + V, N, H, V, ignore)
    jl, jdx, jdw = _jax(x, w, t, dl)
    pl, pdx, pdw = _port(x, w, t, dl)
    for name, a, b in (("loss", pl, jl), ("dx", pdx, jdx), ("dw", pdw, jdw)):
        np.testing.assert_allclose(_np(a), _np(b), atol=TOL, rtol=0,
                                   err_msg=name)
    if ignore:  # loss 0 and no gradient on the ignored rows
        assert (pl[t < 0] == 0).all() and (pdx[t < 0] == 0).all()


def test_bf16_inputs_match_jax_with_its_output_dtypes():
    N, H, V = 32, 32, 128
    x, w, t, dl = _inputs(5, N, H, V, True)
    jl, jdx, jdw = _jax(x, w, t, dl, jnp.bfloat16)
    pl, pdx, pdw = _port(x, w, t, dl, torch.bfloat16)
    assert jdx.dtype == jnp.bfloat16 and jdw.dtype == jnp.bfloat16
    assert pdx.dtype == torch.bfloat16 and pdw.dtype == torch.bfloat16
    assert pl.dtype == torch.float32 and jl.dtype == jnp.float32
    for name, a, b in (("loss", pl, jl), ("dx", pdx, jdx), ("dw", pdw, jdw)):
        a, b = _np(a), _np(b)
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max(), name


def test_a_vocabulary_pallas_refuses_against_dense_cross_entropy():
    """V = 61 has no Pallas block (gcd with 32 is 1); the port takes it.
    Held against ``F.cross_entropy`` with dense autograd."""
    N, H, V = 40, 24, 61
    x, w, t, dl = _inputs(9, N, H, V, True)
    with pytest.raises(ValueError, match="no usable block"):
        _jax(x, w, t, dl)
    pl, pdx, pdw = _port(x, w, t, dl)
    xx = torch.from_numpy(x).requires_grad_()
    ww = torch.from_numpy(w).requires_grad_()
    tt = torch.from_numpy(t).long()
    dense = F.cross_entropy(xx @ ww, tt.clamp(min=0), reduction="none")
    dense = torch.where(tt >= 0, dense, 0.0)
    dense.backward(torch.from_numpy(dl))
    for name, a, b in (("loss", pl, dense.detach()), ("dx", pdx, xx.grad),
                       ("dw", pdw, ww.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0,
                                   err_msg=name)


def test_autograd_function_matches_dense_autograd_on_a_tied_view():
    """``w`` as the ``[H, V]`` transpose view of a ``[V, H]`` table (the
    tied head): the gradient reaches the table."""
    N, H, V = 24, 16, 50
    x, w, t, dl = _inputs(2, N, H, V, True)
    grads = []
    for fused in (True, False):
        xx = torch.from_numpy(x).requires_grad_()
        tab = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
        tt = torch.from_numpy(t)
        if fused:
            loss = fce.fused_linear_cross_entropy(xx, tab.t(), tt)
        else:
            loss = torch.where(tt >= 0, F.cross_entropy(
                xx @ tab.t(), tt.long().clamp(min=0), reduction="none"), 0.0)
        (loss * torch.from_numpy(dl)).sum().backward()
        grads.append((loss.detach(), xx.grad, tab.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0)


def test_gradcheck_fp64():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(6, 5)).requires_grad_()
    w = torch.from_numpy(rng.randn(5, 7) * 0.3).requires_grad_()
    t = torch.tensor([0, 6, -100, 3, 3, 1])
    assert torch.autograd.gradcheck(
        lambda a, b: fce.fused_linear_cross_entropy(a, b, t), (x, w))


def test_chunked_plain_versions_equal_one_chunk_and_blocks_change_nothing():
    N, H, V = 20, 8, 45
    x, w, t, dl = (torch.from_numpy(a) for a in _inputs(6, N, H, V, True))
    dl = dl * (t >= 0)
    lse1, tl1 = fce.fce_forward_reference(x, w, t)
    lse7, tl7 = fce.fce_forward_reference(x, w, t, chunk=7)
    np.testing.assert_allclose(lse7.numpy(), lse1.numpy(), atol=TOL, rtol=0)
    assert torch.equal(tl7, tl1)
    for ref in (fce.fce_backward_dx_reference, fce.fce_backward_dw_reference):
        np.testing.assert_allclose(ref(x, w, t, lse1, dl, chunk=7).numpy(),
                                   ref(x, w, t, lse1, dl).numpy(), atol=TOL,
                                   rtol=0)
    a = fce.fused_linear_cross_entropy(x, w, t)
    b = fce.fused_linear_cross_entropy(x, w, t, block_n=8, block_v=16)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="positive"):
        fce.fused_linear_cross_entropy(x, w, t, block_n=0)
    assert fce.vocab_chunks(128256) == 16 and fce.vocab_chunks(61) == 1


def _table(V, H, dtype, layout):
    """A ``[V, H]`` head table laid out as the case names: its own
    tensor, a view one element past an aligned base, a view whose row
    stride is H + 1, or a view 8 elements into rows of H + 8."""
    if layout == "offset":
        return torch.zeros(V * H + 1, dtype=dtype)[1:].view(V, H)
    if layout == "stride":
        return torch.zeros(V, H + 1, dtype=dtype)[:, :H]
    if layout == "wide":
        return torch.zeros(V, H + 8, dtype=dtype)[:, 8:]
    return torch.zeros(V, H, dtype=dtype)


@pytest.mark.parametrize("H,dtype,layout,want", [
    (2048, torch.bfloat16, "table", True),    # the training width
    (72, torch.bfloat16, "table", True),      # a multiple of 8, not of 64
    (64, torch.bfloat16, "wide", True),       # row stride H + 8, aligned
    (36, torch.bfloat16, "table", False),     # rows of 72 bytes
    (2048, torch.float32, "table", False),    # fp32 keeps scalar FMA
    (64, torch.bfloat16, "offset", False),    # base 2 bytes off 16
    (64, torch.bfloat16, "stride", False),    # row stride H + 1
])
def test_tma_rule_on_the_kernel_operands(H, dtype, layout, want):
    """The rule that sends bf16 to the kernels on TMA and wgmma, on the
    operands the wrapper hands the C side (CPU tensors: the rule reads
    dtypes, shapes, strides and addresses only)."""
    N, V = 24, 100
    x = torch.zeros(N, H, dtype=dtype)
    w = _table(V, H, dtype, layout).t()
    x, rows, ldw, _, _ = fce._kernel_args(x, w, torch.zeros(N).long())
    assert fce._tma_ok(H, ldw, fce._chunk(V), x, rows) is want


class _Library:
    """Stands in for the kernel library's count of TMA launches."""

    def __init__(self, n):
        self.n = n

    def bps_fce_tma_launches(self):
        return self.n


@pytest.mark.parametrize("took,want,ok", [(3, 3, True), (0, 0, True),
                                          (0, 1, False), (2, 1, False)])
def test_tma_launches_are_held_to_the_rule(took, want, ok, monkeypatch):
    """The wrapper counts the TMA launches the library reports and raises
    where they are not the ones the path rule predicted."""
    monkeypatch.setattr(fce, "tma_launches", 5)
    lib = _Library(10 + took)
    if ok:
        fce._count_tma(lib, 10, want, "forward")
        assert fce.tma_launches == 5 + took
    else:
        with pytest.raises(RuntimeError, match="predicted"):
            fce._count_tma(lib, 10, want, "forward")
        assert fce.tma_launches == 5


def test_forward_splits_fill_whole_waves_on_the_tma_path():
    """The persistent forward's (row tile, split) units are a whole number
    of waves of 132 SMs at the training and ragged shapes; a split is at
    least one vocabulary tile; the first design keeps ~4 blocks an SM."""
    for N, V in ((8192, 128256), (8188, 50257)):
        s = fce._fwd_splits(N, V, True, 132)
        assert s == 33 and (-(-N // 128) * s) % 132 == 0
    assert fce._fwd_splits(300, 1000, True, 132) == 4   # 4 tiles of 256
    assert fce._fwd_splits(8192, 128256, False, 132) == 9


class _RuleLibrary:
    """Stands in for the kernel library's backward: each entry point counts
    a TMA launch where the C ``tma_ok`` holds for its operands (H, the row
    strides ldw and ldd multiples of 8 elements, bf16 bases 16-byte
    aligned), as the C side dispatches."""

    def __init__(self):
        self.n = 0
        self.names = []

    def bps_fce_tma_launches(self):
        return self.n

    def _rule(self, name, H, ldw, ldd, dtype, *ptrs):
        self.names.append(name)
        self.n += int(dtype == 1 and H % 8 == 0 and ldw % 8 == 0
                      and ldd % 8 == 0 and all(p % 16 == 0 for p in ptrs))
        return 0

    def bps_fce_dlogits(self, x, wc, t, t64, lse, dl, d, N, H, Vw, c0, V,
                        ldw, ldd, dtype, stream):
        return self._rule("dlogits", H, ldw, ldd, dtype, x, wc, d)

    def bps_fce_dx(self, d, wc, acc, dx, N, H, Vw, ldd, ldw, first, last,
                   dtype, stream):
        return self._rule("dx", H, ldw, ldd, dtype, d, wc)

    def bps_fce_dw(self, d, x, dwc, N, H, Vw, ldd, ldw, dtype, stream):
        return self._rule("dw", H, ldw, ldd, dtype, x, dwc, d)


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("dtype,layout,need,per_chunk", [
    (torch.bfloat16, "table", (True, True), 3),   # every operand qualifies
    (torch.bfloat16, "table", (False, True), 2),  # no dx: dlogits and dW
    (torch.bfloat16, "table", (True, False), 2),  # no dW
    (torch.float32, "table", (True, True), 0),    # fp32 keeps scalar FMA
    (torch.bfloat16, "stride", (True, True), 0),  # row stride H + 1: dW too
])
def test_backward_predicts_the_tma_launches_of_every_chunk(
        monkeypatch, dtype, layout, need, per_chunk):
    """The wrapper's prediction for a backward chunk (dlogits, dx, dW),
    held by ``_count_tma`` to what a library applying the C rule
    launches: 3 a chunk where every operand qualifies, 0 in fp32, and on a
    table of row stride H + 1 none, dW included (the chunk's one rule
    reads the table's stride)."""
    lib = _RuleLibrary()
    monkeypatch.setattr(fce, "_library", lambda: lib)
    monkeypatch.setattr(fce._build, "on_cuda", lambda *a: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(fce, "tma_launches", 0)
    N, H, V = 16, 64, 20000            # three vocabulary chunks
    x = torch.zeros(N, H, dtype=dtype)
    w = _table(V, H, dtype, layout).t()
    t = torch.zeros(N, dtype=torch.long)
    lse, dl = torch.zeros(N), torch.ones(N)
    dx, dw = fce.fce_backward(x, w, t, lse, dl, *need)
    nc = fce.vocab_chunks(V)
    assert nc == 3
    assert fce.tma_launches == per_chunk * nc
    assert len(lib.names) == nc * (1 + sum(need))
    assert (dx is not None, dw is not None) == need
