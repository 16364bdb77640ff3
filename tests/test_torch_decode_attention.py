"""The plain version of the port's decode-attention kernel
(byteps_tpu_torch/ops/decode_attention.py) held against the JAX Pallas
kernel ``byteps_tpu.ops.decode_attention.decode_attention`` run in
interpret mode with 64-key chunks, on the same numpy inputs.

Tolerance 2e-5 absolute in fp32: the JAX kernel folds the chunks with an
online softmax, the plain version takes one dense softmax over the same
keys; the two sum the same fp32 products in other orders.  The int8 mode
runs both on the same ``_quantize_kv`` values, which are bit-equal
between the packages.

The position-vector form (``pos`` a ``[B]`` int32 tensor, one position a
row: the dense serving engine's decode tick): the plain version against
the JAX kernel ``vmap``-ed over the rows with one traced position each
(the JAX engine's form), mixed positions, fp and int8, with and without
a window, 2e-5; at equal positions it equals the int call bit for bit.
The port's ``Transformer.decode`` at a position vector against the JAX
``Transformer.decode`` ``vmap``-ed over rows (the JAX dense engine's
decode step) on converted weights, grouped and flat, fp and int8 rows:
logits and the written rows within 1e-5 (fp32).

Also, without a card: the kernel's split plan (``_splits``) covers every
attended chunk once with no empty split, and the ring design's splits
stream at least 8 chunks where the cache has them; the device form's plan
(sized by ``_max_chunks``, from shapes alone) covers every row's chunks
once from its own first chunk, only trailing splits empty; the wrapper's
launch, driven through a stand-in for the CUDA library that reports the
C side's per-design counts, takes the design its rule names (``_ring_ok``:
bf16 q on tensor cores, fp32 on the first design) with that plan, hands
the ring its ticket buffer, is held to the counts, and in the device form
reads no value of the position vector.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models import transformer as jt
from byteps_tpu.models.transformer import _quantize_kv as jax_quantize_kv
from byteps_tpu.ops.decode_attention import decode_attention as jax_decode
from byteps_tpu.ops.decode_attention import (
    decode_attention_usable as jax_usable)
from byteps_tpu_torch.models import transformer as pt
from byteps_tpu_torch.models.convert import from_jax_params
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
    """Stands in for the CUDA library: records each launch's arguments and
    reports the kernels the C side launches for them (ring, or the first
    design with its combine kernel where it splits; and a launch reading
    the position vector in the device form)."""

    def __init__(self):
        self.calls = []

    def bps_decode_attention_smem(self, G, D, dtype, quant, ring):
        return 1024

    def bps_decode_attention(self, *args):
        self.calls.append(args)
        nsplit, ring, pos_dev, counts = args[15], args[19], args[21], args[22]
        counts[0 if ring else 1] = 1
        counts[2] = int(not ring and nsplit > 1)
        counts[3] = int(pos_dev is not None)
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
    (B_, S_, H_, KV_, D_, pos_, window, nsplit, per, dt, q8,
     rg) = args[8:20]
    assert (B_, S_, H_, KV_, D_, pos_, window) == (B, S, H, KV, D, pos, 0)
    assert (nsplit, per) == da._splits(B, KV, pos // da.CHUNK + 1, 132, ring)
    assert (dt, q8, rg) == (int(dtype == torch.bfloat16), int(quant),
                            int(ring))
    assert da._ring_ok(dtype, H // KV) is ring
    assert (part is None) == (nsplit == 1)
    assert (tickets is not None) == (ring and nsplit > 1)


# ------------------------------------------------ the position-vector form

POSV = [0, 15, 64, 130, 255]   # one position a row of a 256-row cache


def _jax_rows(q, k, v, pos, window=None, ks=None, vs=None):
    """The JAX kernel ``vmap``-ed over rows, each at its own traced
    position (interpret mode, 64-key chunks): the JAX engine's form."""
    B, S = k.shape[:2]

    def one(qb, kb, vb, p, *sc):
        kw = ({} if not sc else {"k_scale": sc[0][None],
                                 "v_scale": sc[1][None]})
        return jax_decode(qb[None], kb[None], vb[None], p, window=window,
                          block_s=64, interpret=True, **kw)[0]

    args = [jnp.asarray(q), jnp.asarray(k).reshape(B, S, -1),
            jnp.asarray(v).reshape(B, S, -1), jnp.asarray(pos, jnp.int32)]
    if ks is not None:
        args += [jnp.asarray(ks), jnp.asarray(vs)]
    return np.asarray(jax.jit(jax.vmap(one))(*args))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
def test_position_vector_matches_jax_rows(H, KV, window, quant):
    B, S, D = len(POSV), 256, 16
    q, k, v = _inputs(31 + H, B, S, H, KV, D)
    ks = vs = None
    if quant:
        k, ks = (np.array(a) for a in jax_quantize_kv(jnp.asarray(k)))
        v, vs = (np.array(a) for a in jax_quantize_kv(jnp.asarray(v)))
    want = _jax_rows(q, k, v, POSV, window, ks, vs)
    t = {n: None if a is None else torch.from_numpy(a)
         for n, a in (("ks", ks), ("vs", vs))}
    args = (torch.from_numpy(q), torch.from_numpy(k).reshape(B, S, -1),
            torch.from_numpy(v).reshape(B, S, -1))
    kw = dict(k_scale=t["ks"], v_scale=t["vs"], window=window)
    plain = da.plain_calls
    got = da.decode_attention(*args, torch.tensor(POSV, dtype=torch.int32),
                              **kw)
    assert da.plain_calls == plain + 1
    assert got.shape == (B, 1, H, D)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # at equal positions the vector is the int call, bit for bit
    for p in (0, 100, 255):
        vec = torch.full((B,), p, dtype=torch.int32)
        assert torch.equal(da.decode_attention(*args, vec, **kw),
                           da.decode_attention(*args, p, **kw))


def test_position_vector_is_checked():
    B, S, H, KV, D = 2, 96, 4, 2, 32
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, B, S, H, KV, D))
    for bad in (torch.zeros(B, dtype=torch.int64),
                torch.zeros(B + 1, dtype=torch.int32),
                torch.zeros(B, 1, dtype=torch.int32)):
        with pytest.raises(ValueError, match="position vector"):
            da.decode_attention(q, k, v, bad)


@pytest.mark.parametrize("S", [96, 256, 2000, 2048])
@pytest.mark.parametrize("window", [None, 1, 48, 64, 65, 256])
def test_max_chunks_bounds_every_row(S, window):
    """``_max_chunks`` is the most chunks any row attends: no position
    attends more, and some position attends exactly that many."""
    counts = [p // da.CHUNK - (max(p - window + 1, 0) if window else 0)
              // da.CHUNK + 1 for p in range(S)]
    assert max(counts) == da._max_chunks(S, window)


@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("window", [None, 37, 256])
@pytest.mark.parametrize("B,KV,S", [(8, 8, 2048), (8, 1, 2000),
                                    (3, 4, 160), (1, 8, 2048)])
def test_device_plan_covers_each_row_once(ring, window, B, KV, S):
    """The device form's plan, from shapes alone, walked as the kernel
    walks it from each row's own first chunk: every attended chunk once,
    in order, and the empty splits all trail the live ones."""
    nsplit, per = da._splits(B, KV, da._max_chunks(S, window), 132, ring)
    for pos in sorted({0, 1, 63, 64, 130, 1000 % S, S - 2, S - 1}):
        c_lo = (max(pos - window + 1, 0) if window else 0) // da.CHUNK
        c_hi = pos // da.CHUNK
        seen, live = [], []
        for split in range(nsplit):
            j0 = c_lo + split * per
            j1 = min(c_hi + 1, j0 + per)
            live.append(j0 < j1)
            seen += range(j0, j1)
        assert seen == list(range(c_lo, c_hi + 1)), (pos, nsplit, per)
        assert live == sorted(live, reverse=True)


class _NoValues(torch.Tensor):
    """A tensor whose values may not be read on the host: shapes, dtype,
    device and the data pointer only."""

    READS = {"item", "tolist", "numpy", "cpu", "cuda", "to", "__bool__",
             "__int__", "__float__", "__index__", "__iter__", "__getitem__",
             "__repr__", "__format__", "max", "min", "amax", "sum", "long",
             "int", "float", "eq", "__eq__", "any", "all", "clone"}

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in cls.READS:
            raise AssertionError(f"the launch read values: {name}")
        return super().__torch_function__(func, types, args, kwargs or {})


@pytest.mark.parametrize("dtype,quant,KV,window", [
    (torch.bfloat16, False, 8, None), (torch.bfloat16, True, 32, 256),
    (torch.float32, False, 8, None), (torch.float32, True, 32, 256)])
def test_device_form_launch_reads_no_position(monkeypatch, dtype, quant, KV,
                                              window):
    lib = _FakeLib()
    monkeypatch.setattr(da, "_library", lambda: lib)
    monkeypatch.setattr(da, "_tickets", {})
    monkeypatch.setattr(da._build, "on_cuda", lambda *a: True)
    monkeypatch.setattr(da._build, "sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    B, S, H, D = 8, 2048, 32, 64
    ring = da._ring_ok(dtype, H // KV)
    q = torch.zeros(B, 1, H, D, dtype=dtype)
    ck = torch.zeros(B, S, KV * D, dtype=torch.int8 if quant else dtype)
    scales = ((torch.zeros(B, S, KV), torch.zeros(B, S, KV)) if quant
              else (None, None))
    pos = torch.tensor([0, 15, 16, 63, 255, 1000, 1919, 2047],
                       dtype=torch.int32).as_subclass(_NoValues)
    before, by = da.launches, dict(da.design_launches)
    out = da.decode_attention(q, ck, ck.clone(), pos, k_scale=scales[0],
                              v_scale=scales[1], window=window)
    assert da.launches == before + 1 and out.shape == q.shape
    args = lib.calls[0]
    n = da._max_chunks(S, window)
    nsplit, per = da._splits(B, KV, n, 132, ring)
    assert args[13:17] == (0, window or 0, nsplit, per)
    assert args[21] == pos.data_ptr()
    took = [da.design_launches[k] - by[k] for k in da.COUNTS]
    assert took == da._kernels_for(ring, nsplit, True)
    assert took[3] == 1 and sum(took[:2]) == 1


def test_launch_is_held_to_the_library_counts(monkeypatch):
    """A library that reports other kernels than the rule predicts makes
    the call raise."""
    class _Wrong(_FakeLib):
        def bps_decode_attention(self, *args):
            super().bps_decode_attention(*args)
            args[22][2] += 1          # a combine launch the ring never makes
            return 0

    monkeypatch.setattr(da, "_library", lambda: _Wrong())
    monkeypatch.setattr(da, "_tickets", {})
    monkeypatch.setattr(da._build, "on_cuda", lambda *a: True)
    monkeypatch.setattr(da._build, "sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    q = torch.zeros(2, 1, 32, 64, dtype=torch.bfloat16)
    ck = torch.zeros(2, 512, 512, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="the rule predicted"):
        da.decode_attention(q, ck, ck.clone(), 300)


# ------------------------------------ Transformer.decode at a vector of rows

SCALING = (("factor", 32.0), ("high_freq_factor", 4.0),
           ("low_freq_factor", 1.0), ("original_max_position_embeddings", 16),
           ("rope_type", "llama3"))
LLAMA = dict(vocab_size=97, num_layers=2, num_heads=4, num_kv_heads=2,
             d_model=64, d_ff=128, max_seq_len=64, norm_eps=1e-5,
             pos_emb="rope", rope_theta=500000.0, rope_scaling=SCALING,
             mlp="swiglu", tie_embeddings=True)


@pytest.fixture(scope="module")
def llama():
    jmodel = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **LLAMA))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                     jnp.zeros((1, 8), jnp.int32))
    cfg = pt.TransformerConfig(dtype=torch.float32, **LLAMA)
    model = pt.Transformer(cfg)
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables), cfg))
    return jmodel, variables, cfg, model.eval()


def _random_rows(cfg, B, S, quant, layout, seed):
    """The same random cache rows for both packages (numpy), as a half-
    served pool holds them."""
    rng = np.random.RandomState(seed)
    shape = ((B, S, cfg.kv_heads * cfg.d_head) if layout == "flat"
             else (B, S, cfg.kv_heads, cfg.d_head))
    layers = []
    for _ in range(cfg.num_layers):
        if quant:
            layer = {n: rng.randint(-127, 128, size=shape).astype(np.int8)
                     for n in ("k", "v")}
            for n in ("k_scale", "v_scale"):
                layer[n] = rng.uniform(0.005, 0.02, size=(B, S, cfg.kv_heads)
                                       ).astype(np.float32)
        else:
            layer = {n: rng.randn(*shape).astype(np.float32)
                     for n in ("k", "v")}
        layers.append(layer)
    return layers


@pytest.mark.parametrize("layout,quant", [("grouped", False), ("flat", False),
                                          ("grouped", True), ("flat", True)])
def test_decode_at_a_position_vector_matches_jax_vmapped_decode(
        llama, layout, quant):
    """One decode step of 5 slots at their own positions: the port's
    batched ``decode`` (per-row rope, write and mask; on a flat cache the
    decode kernel's wrapper with the vector) against the JAX per-row
    ``decode`` under ``vmap`` (the JAX dense engine's decode step)."""
    jmodel, variables, cfg, model = llama
    B, S = 5, 64
    pos = np.array([0, 7, 31, 40, 63], np.int32)
    toks = np.random.RandomState(8).randint(0, 97, size=(B,)).astype(np.int32)
    rows = _random_rows(cfg, B, S, quant, layout, seed=9)

    def one(row, tok, p):
        rowb = jax.tree_util.tree_map(lambda c: c[None], row)
        logits, new = jmodel.apply(variables, tok[None, None], rowb, p,
                                   method=jt.Transformer.decode)
        return logits[0], jax.tree_util.tree_map(lambda c: c[0], new)

    jrows = tuple({n: jnp.asarray(a) for n, a in r.items()} for r in rows)
    want, jnew = jax.jit(jax.vmap(one))(jrows, jnp.asarray(toks),
                                        jnp.asarray(pos))
    prows = [{n: torch.from_numpy(a.copy()) for n, a in r.items()}
             for r in rows]
    plain = da.plain_calls
    got, _ = model.decode(torch.from_numpy(toks).long()[:, None], prows,
                          torch.from_numpy(pos))
    assert da.plain_calls - plain == (cfg.num_layers if layout == "flat"
                                      else 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # the rows each slot wrote at its own position (fresh fp32 K/V from
    # products summed in other orders: 1e-5, as the logits; an int8 row's
    # values and scales come out of the same quantization)
    for pr, jr in zip(prows, jnew):
        for n in pr:
            np.testing.assert_allclose(pr[n].numpy(), np.asarray(jr[n]),
                                       atol=1e-5, rtol=0, err_msg=n)
