"""The port's compression registry (byteps_tpu_torch/compression) held
against the JAX package's, scheme by scheme, in both domains.

Roundtrip domain (torch tensors vs ``jnp`` arrays, the same seeded numpy
inputs with ties and zeros in them): none, bf16, fp16, topk and int8
without a seed are bit-equal; onebit's scale is the float64 mean
rounded once, within 2 ulps of JAX's float32 mean (which is itself up to
2 ulps from the exact one), with the signs equal; the
seeded schemes (int8 dither, randomk) cannot draw JAX's ``jax.random``
stream and are held statistically: randomk keeps exactly k coordinates,
equal to x there, the same set for the same seed; int8's error is at
most one scale and its mean over 200 seeds unbiased (within 5 standard
errors at each element, 4 over all).

Wire domain (numpy, both packages): every scheme's ``wire_encode`` bytes
and ``wire_decode`` values, ``bpsc1`` blobs both ways, ``derive_seed``,
``CompressionPolicy``'s choices, ``WireCompressor``'s residuals over 3
mutations and ``CompressionStats.summary`` are equal; the bf16 bytes
(torch's cast) equal ``ml_dtypes``' on finite values, ±0, ±inf and
subnormals, and NaN stays NaN.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from byteps_tpu import compression as jc
from byteps_tpu_torch import compression as pc
from byteps_tpu_torch.ops import quantization as pq

ROUNDTRIP_EXACT = ["none", "bf16", "fp16", "topk", "int8"]
ALL = ["none", "bf16", "fp16", "int8", "topk", "randomk", "onebit"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape=(25, 40), seed=0):
    """Seeded normal values with ties in |x| (±1.5 three times each, a
    repeated run) and zeros."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32).reshape(-1)
    n = x.size
    x[[3, 17 % n, 400 % n]] = 1.5
    x[[9, 250 % n, 777 % n]] = -1.5
    x[n // 10:n // 10 + 10] = x[n // 20]
    x[[5, 6, 600 % n]] = 0.0
    x[-1] = -0.0
    return x.reshape(shape)


def _ulp(v: float) -> float:
    return float(np.spacing(np.float32(abs(v))))


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("name", ROUNDTRIP_EXACT)
def test_roundtrip_bit_equal_to_jax(name, ratio):
    x = _x()
    got = pc.get_scheme(name).roundtrip(torch.from_numpy(x), ratio=ratio)
    want = np.asarray(jc.get_scheme(name).roundtrip(jnp.asarray(x),
                                                    ratio=ratio))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "topk":    # the ties at the boundary went to lower indices
        assert int((got.numpy() != 0).sum()) == max(1, int(x.size * ratio))


def test_topk_breaks_ties_toward_the_lower_index():
    """``|x| = [1, 1, 1, .5, 1, 1, 0, 0]``, k = 3: lax.top_k keeps 0, 1, 2;
    ``torch.topk`` would not."""
    x = np.array([1, -1, 1, 0.5, -1, 1, 0, 0], np.float32)
    got = pc.get_scheme("topk").roundtrip(torch.from_numpy(x), ratio=3 / 8)
    want = np.asarray(jc.get_scheme("topk").roundtrip(jnp.asarray(x),
                                                      ratio=3 / 8))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.nonzero(want)[0], [0, 1, 2])


@pytest.mark.parametrize("n", [35, 1000, 65536])
def test_onebit_scale_correctly_rounded_and_signs_equal(n):
    """The port's scale is the mean |x| rounded once from float64; JAX's
    float32 mean lands within 2 ulps of it (2 at n = 35 and 1000 here),
    so the two scales are held within 2 ulps, and the port's to the
    float64 mean exactly."""
    x = _x((n,), seed=n)
    got = pc.get_scheme("onebit").roundtrip(torch.from_numpy(x)).numpy()
    want = np.asarray(jc.get_scheme("onebit").roundtrip(jnp.asarray(x)))
    exact = np.float32(np.abs(x.astype(np.float64)).mean())
    scale = float(np.abs(want).max())
    assert np.unique(np.abs(got)).size == 1
    assert np.abs(got).max() == exact
    assert abs(float(exact) - scale) <= 2 * _ulp(exact)
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    np.testing.assert_array_equal(got >= 0, x >= 0)   # -0.0 maps to +scale


def test_roundtrips_keep_dtype_and_shape_in_bf16():
    x = torch.from_numpy(_x()).to(torch.bfloat16)
    for name in ALL:
        s = pc.get_scheme(name)
        y = s.roundtrip(x, seed=7 if s.seeded else None, ratio=0.1)
        assert y.dtype == torch.bfloat16 and y.shape == x.shape, name
        assert torch.isfinite(y.float()).all(), name


def test_randomk_keeps_k_values_of_x_the_same_set_for_a_seed():
    x = torch.from_numpy(_x())
    s = pc.get_scheme("randomk")
    for ratio in (0.01, 0.1, 0.5):
        k = max(1, int(x.numel() * ratio))
        a = s.roundtrip(x, seed=123, ratio=ratio)
        b = s.roundtrip(x, seed=123, ratio=ratio)   # another rank, same seed
        c = s.roundtrip(x, seed=124, ratio=ratio)
        kept = a.reshape(-1) != 0
        # x's zeros can fall in the kept set: count positions, not values
        idx = torch.randperm(x.numel(), generator=torch.Generator()
                             .manual_seed(123))[:k]
        assert set(torch.nonzero(kept).flatten().tolist()) <= set(
            idx.tolist())
        mask = torch.zeros(x.numel(), dtype=torch.bool)
        mask[idx] = True
        np.testing.assert_array_equal(a.reshape(-1)[mask].numpy(),
                                      x.reshape(-1)[mask].numpy())
        assert not a.reshape(-1)[~mask].any()
        assert torch.equal(a, b)
        assert not torch.equal(a, c)


def test_int8_dither_error_within_a_scale_and_unbiased():
    x = torch.from_numpy(_x((4000,), seed=3))
    scale = float(x.abs().max()) / 127.0
    s = pc.get_scheme("int8")
    outs = torch.stack([s.roundtrip(x, seed=i) for i in range(200)])
    assert float((outs - x).abs().max()) <= scale * (1 + 1e-6)
    # dithered rounding is stochastic rounding: each draw's error has
    # mean 0 and sd <= scale / 2.  The mean of 200 draws lies within 5
    # standard errors at every one of the 4000 elements (a 2e-3 chance
    # to miss somewhere), and the mean over all draws and elements
    # within 4 of its own
    err = outs - x
    assert float(err.mean(0).abs().max()) <= 5 * scale / 2 / np.sqrt(200)
    assert abs(float(err.mean())) <= 4 * scale / 2 / np.sqrt(err.numel())
    assert not torch.equal(outs[0], outs[1])


def test_quantize_dequantize_bit_equal_to_jax():
    from byteps_tpu.ops import quantization as jq

    for x in (_x(), np.zeros((3, 4), np.float32)):
        q, sc = pq.quantize(torch.from_numpy(x))
        jqv, jsc = jq.quantize(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
        assert float(sc) == float(jsc)
        np.testing.assert_array_equal(
            pq.dequantize(q, sc).numpy(),
            np.asarray(jq.dequantize(jqv, jsc)))


# ------------------------------------------------------------ wire domain


@pytest.mark.parametrize("name", ALL)
def test_wire_encode_decode_byte_identical_to_jax(name):
    x = _x()
    for seed in (0, 99, jc.derive_seed(5, "w", 3)):
        ctx, data = pc.get_scheme(name).wire_encode(x, seed=seed,
                                                    ratio=0.05)
        jctx, jdata = jc.get_scheme(name).wire_encode(x, seed=seed,
                                                      ratio=0.05)
        assert (ctx, data) == (jctx, jdata)
        got = pc.get_scheme(name).wire_decode(ctx, data, x.size)
        want = jc.get_scheme(name).wire_decode(ctx, data, x.size)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ALL)
def test_bpsc1_blobs_byte_identical_both_ways(name):
    for arr in (_x(), _x((7, 3), seed=4).astype(np.float16)):
        blob, deq = pc.encode_blob(pc.get_scheme(name), arr, seed=11,
                                   ratio=0.1)
        jblob, jdeq = jc.encode_blob(jc.get_scheme(name), arr, seed=11,
                                     ratio=0.1)
        assert blob.data == jblob.data and blob.shape == jblob.shape
        assert blob.nbytes == jblob.nbytes
        assert blob.raw_nbytes == jblob.raw_nbytes
        np.testing.assert_array_equal(deq, jdeq)
        for dec in (pc.decode_blob, jc.decode_blob):
            a = dec(pc.WIRE_TAG, jblob.data, arr.shape)
            b = dec(jc.WIRE_TAG, blob.data, arr.shape)
            assert a.dtype == arr.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="bpsc2"):
        pc.decode_blob("bpsc2", blob.data, arr.shape)
    with pytest.raises(ValueError, match="truncated"):
        pc.decode_blob(pc.WIRE_TAG, blob.data[:-1], arr.shape)


def test_a_bf16_blob_decodes_to_float32_values_without_ml_dtypes():
    arr = _x((5, 8)).astype(ml_dtypes.bfloat16)
    jblob, _ = jc.encode_blob(jc.get_scheme("bf16"), arr)
    got = pc.decode_blob(pc.WIRE_TAG, jblob.data, arr.shape)
    want = jc.decode_blob(jc.WIRE_TAG, jblob.data, arr.shape)
    assert got.dtype == np.float32 and want.dtype == arr.dtype
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_bf16_bytes_equal_ml_dtypes():
    tiny = np.finfo(np.float32).tiny
    special = np.array([0.0, -0.0, np.inf, -np.inf, tiny, -tiny, tiny / 3,
                        tiny * 1.5, 1e-40, -1e-42, 3.4e38, -3.3e38,
                        1.00390625, 1.01171875, 1.0 + 2 ** -9,
                        1.0 + 3 * 2 ** -9], np.float32)
    vals = np.concatenate([special, _x((4096,), seed=8),
                           _x((4096,), seed=9) * 1e-39])
    assert np.isfinite(vals[4:]).all()
    ctx, data = pc.get_scheme("bf16").wire_encode(vals)
    assert data == vals.astype(ml_dtypes.bfloat16).tobytes()
    back = pc.get_scheme("bf16").wire_decode(ctx, data, vals.size)
    np.testing.assert_array_equal(
        back, vals.astype(ml_dtypes.bfloat16).astype(np.float32))
    nan = np.array([np.nan, -np.nan], np.float32)
    _, d = pc.get_scheme("bf16").wire_encode(nan)
    assert np.isnan(pc.get_scheme("bf16").wire_decode(b"", d, 2)).all()


def test_derive_seed_equal():
    for base, name, count in [(0, "", 0), (7, "w", 1), (2 ** 40, "emb_3", 9),
                              (5, "DistributedOptimizer1.bucket4", 123)]:
        assert pc.derive_seed(base, name, count) == jc.derive_seed(
            base, name, count)


def test_policy_choices_equal():
    kw = dict(default="onebit", min_bytes=1024,
              overrides="emb=topk, bias=none,head=bf16", ratio=0.02, seed=3)
    pol, jpol = pc.CompressionPolicy(**kw), jc.CompressionPolicy(**kw)
    for name in ("emb.weight", "layer0.bias", "head", "q_proj", "emb_1"):
        for nbytes in (0, 1023, 1024, 10 ** 6):
            for dt in (np.float32, np.float16, np.int32, np.int8,
                       np.dtype(ml_dtypes.bfloat16), np.float64):
                got = pol.scheme_for(name, nbytes, dt)
                want = jpol.scheme_for(name, nbytes, dt)
                assert (got and got.name) == (want and want.name), (
                    name, nbytes, dt)
    # the port also names dtypes as torch dtypes and names
    assert pol.scheme_for("q", 4096, torch.bfloat16).name == "onebit"
    assert pol.scheme_for("q", 4096, "bfloat16").name == "onebit"
    assert pol.scheme_for("q", 4096, torch.int64) is None
    for bad in (dict(overrides="noequals"), dict(overrides="a=nope"),
                dict(default="nope")):
        with pytest.raises((ValueError, KeyError)):
            pc.CompressionPolicy(**bad)
        with pytest.raises((ValueError, KeyError)):
            jc.CompressionPolicy(**bad)


@pytest.mark.parametrize("scheme", ["onebit", "topk", "randomk", "int8",
                                    "bf16"])
def test_wire_compressor_residuals_equal_over_three_mutations(scheme):
    pol = dict(default=scheme, min_bytes=16, ratio=0.1, seed=4)
    wc = pc.WireCompressor(pc.CompressionPolicy(**pol))
    jwc = jc.WireCompressor(jc.CompressionPolicy(**pol))
    for step in range(3):
        delta = _x((300,), seed=20 + step)
        blob, commit = wc.encode_mutation("w", delta)
        jblob, jcommit = jwc.encode_mutation("w", delta)
        assert blob.data == jblob.data
        assert (commit is None) == (jcommit is None)
        if commit is not None:
            if step != 1:   # an unacknowledged push folds nothing
                commit()
                jcommit()
            np.testing.assert_array_equal(wc._residual["w"],
                                          jwc._residual["w"])
            assert wc.residual_norm("w") == jwc.residual_norm("w")
            assert wc.residual_bytes() == jwc.residual_bytes()
    raw, _ = wc.encode_mutation("small", np.ones(2, np.float32))
    assert isinstance(raw, np.ndarray)


def test_stats_summary_and_reply_leg_equal():
    from byteps_tpu.compression.stats import CompressionStats as JStats
    from byteps_tpu_torch.compression.stats import CompressionStats

    st, jst = CompressionStats(), JStats()
    for name, raw, wire in [("a", 4000, 125), ("b", 4000, 4000),
                            ("a", 800, 400)]:
        st.observe(name, raw, wire)
        jst.observe(name, raw, wire)
    assert st.summary() == jst.summary()
    assert st.per_tensor() == jst.per_tensor()
    assert st.log_summary() == jst.log_summary()
    assert CompressionStats().log_summary() is None
    snap = st.registry.snapshot()["counters"]
    assert snap["compression.wire_bytes_sent"] == 4525
    assert snap["compression.wire_bytes_saved"] == 4275
    x = _x()
    for name in ("bf16", "onebit", "none", ""):
        got = pc.maybe_compress_reply(x, name, 1024)
        want = jc.maybe_compress_reply(x, name, 1024)
        assert type(got).__name__ == type(want).__name__
        if hasattr(got, "data"):
            assert got.data == want.data
    pc.get_compression_stats().observe("z", 10, 5)
    pc.reset_compression_stats()
    assert pc.get_compression_stats().summary()["raw_bytes"] == 0


def test_compression_modules_import_neither_jax_nor_ml_dtypes():
    code = ("import sys\n"
            "import byteps_tpu_torch.compression\n"
            "import byteps_tpu_torch.ops.quantization\n"
            "import byteps_tpu_torch.ops.sparsification\n"
            "import byteps_tpu_torch.training.callbacks\n"
            "import byteps_tpu_torch.training.checkpoint\n"
            "import byteps_tpu_torch.training.overlap\n"
            "from byteps_tpu_torch.compression import get_scheme\n"
            "import numpy as np\n"
            "x = np.arange(64, dtype=np.float32)\n"
            "for n in ('bf16', 'onebit', 'int8'):\n"
            "    s = get_scheme(n); s.wire_decode(*s.wire_encode(x), 64)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'byteps_tpu', 'ml_dtypes')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
