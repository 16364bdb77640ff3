"""The port's native host library (byteps_tpu_torch/native, its own copy
of the C++ source in byteps_tpu_torch/csrc/byteps_native.cc) held bit
for bit against the JAX package's (byteps_tpu/native): the elementwise
sums of all six dtypes — NaN, infinities, subnormals and rounding ties
included — and the key -> shard hash.  bfloat16 is a CPU tensor on the
port's side and an ``ml_dtypes`` array on JAX's; both are compared as
their raw 16-bit patterns.  Inputs come from numpy with fixed seeds."""

import ml_dtypes
import numpy as np
import pytest
import torch

from byteps_tpu.native import reducer as jax_reducer
from byteps_tpu_torch.engine.async_ps import AsyncParameterServer
from byteps_tpu_torch.native import reducer

N = 4099   # odd: the OpenMP loop's ragged tail


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _half_bits(rng, n, exp_bits):
    """Raw 16-bit patterns spanning every class of a 16-bit float: zeros,
    subnormals, normals, infinities and NaNs, both signs, plus exact
    rounding ties (x and an addend of half its last place)."""
    raw = rng.randint(0, 1 << 16, size=n).astype(np.uint16)
    man_bits = 15 - exp_bits
    exp_mask = ((1 << exp_bits) - 1) << man_bits
    special = np.array([0x0000, 0x8000, 0x0001, 0x8001, exp_mask,
                        exp_mask | 0x8000, exp_mask | 1,
                        exp_mask | (1 << (man_bits - 1))], np.uint16)
    raw[:len(special)] = special
    return raw


def _ties(dtype_bits):
    """(a, b) pairs whose exact sum lies halfway between two neighbours:
    1 + half an ulp of 1, and (1 + ulp) + half an ulp — one tie rounds
    down to even, the other up."""
    if dtype_bits == "f16":
        one, half_ulp = 0x3C00, 0x1000       # 1.0, 2**-11
        odd = 0x3C01
    else:
        one, half_ulp = 0x3F80, 0x3B80       # 1.0, 2**-8
        odd = 0x3F81
    a = np.array([one, odd, one | 0x8000], np.uint16)
    b = np.array([half_ulp, half_ulp, half_ulp | 0x8000], np.uint16)
    return a, b


def _pair16(seed, kind):
    rng = np.random.RandomState(seed)
    exp_bits = 5 if kind == "f16" else 8
    a, b = _half_bits(rng, N, exp_bits), _half_bits(rng, N, exp_bits)
    ta, tb = _ties(kind)
    a[8:8 + len(ta)], b[8:8 + len(tb)] = ta, tb
    return a, b


@pytest.mark.parametrize("kind", ["f32", "f64", "i32", "i64", "f16",
                                  "bf16"])
def test_sum_into_bit_equal_to_jax(kind):
    rng = np.random.RandomState(3)
    if kind in ("f16", "bf16"):
        a, b = _pair16(4, kind)
        if kind == "f16":
            ja, jb = a.view(np.float16).copy(), b.view(np.float16)
            pa, pb = a.view(np.float16).copy(), b.view(np.float16)
            jax_reducer.sum_into(ja, jb)
            reducer.sum_into(pa, pb)
            got, want = pa.view(np.uint16), ja.view(np.uint16)
        else:
            ja = a.view(ml_dtypes.bfloat16).copy()
            jax_reducer.sum_into(ja, b.view(ml_dtypes.bfloat16))
            pa = torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
            pb = torch.from_numpy(b.view(np.int16).copy()).view(
                torch.bfloat16)
            reducer.sum_into(pa, pb)
            got = pa.view(torch.int16).numpy().view(np.uint16)
            want = ja.view(np.uint16)
        np.testing.assert_array_equal(got, want)
        # the ties did round (one down to even, one up), so they test
        assert len(set(got[8:11].tolist())) == 3
        return
    dt = {"f32": np.float32, "f64": np.float64, "i32": np.int32,
          "i64": np.int64}[kind]
    if kind.startswith("f"):
        a = (rng.randn(N) * 10.0 ** rng.randint(-40, 38, N)).astype(dt)
        b = (rng.randn(N) * 10.0 ** rng.randint(-40, 38, N)).astype(dt)
        a[:7] = [np.nan, np.inf, -np.inf, np.finfo(dt).tiny / 4, 0.0,
                 np.finfo(dt).max, -np.nan]
        b[:7] = [1.0, -np.inf, 1.0, np.finfo(dt).tiny / 4, -0.0,
                 np.finfo(dt).max, np.nan]
    else:
        info = np.iinfo(dt)
        a = rng.randint(info.min, info.max, N, dtype=dt)
        b = rng.randint(info.min, info.max, N, dtype=dt)   # wraps
    ja, pa = a.copy(), a.copy()
    jax_reducer.sum_into(ja, b)
    reducer.sum_into(pa, b)
    assert ja.tobytes() == pa.tobytes()


def test_key_to_shard_equal_over_ten_thousand_keys():
    assert jax_reducer.available()
    rng = np.random.RandomState(5)
    keys = [int(k) for k in rng.randint(0, 1 << 62, size=10_000,
                                        dtype=np.int64)]
    keys[:4] = [0, 1, 65535, 1 << 16]
    for n in (1, 2, 3, 7, 16):
        assert [reducer.key_to_shard(k, n) for k in keys] == \
            [jax_reducer.key_to_shard(k, n) for k in keys]
    assert reducer.omp_max_threads() >= 1


def test_library_is_built_from_the_port_source_into_the_build_dir():
    path = reducer.library_path()
    reducer.load()
    assert path.exists()
    assert path.parent.parts[-2:] == ("build", "byteps_tpu_torch")
    assert reducer._SRC.parts[-3:] == ("byteps_tpu_torch", "csrc",
                                       "byteps_native.cc")
    # no -march=native: the library may be loaded on another host
    assert not any("march" in f for f in reducer._FLAGS)
    assert "-fopenmp" in reducer._FLAGS


def test_a_toolchain_without_openmp_builds_the_loops_serially(
        monkeypatch, tmp_path):
    """A compiler that refuses -fopenmp (a toolchain without libgomp)
    still gives the library, serial and said so; its sums are the same
    bits."""
    wrapper = tmp_path / "cxx"
    wrapper.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = -fopenmp ] '
                       '&& exit 1; done\nexec g++ "$@"\n')
    wrapper.chmod(0o755)
    monkeypatch.setattr(reducer, "_lib", None)
    monkeypatch.setattr(reducer, "_compilers", lambda: [str(wrapper)])
    monkeypatch.setattr(reducer, "_BUILD_DIR", tmp_path / "build")
    assert reducer.omp_max_threads() == 1
    a, b = _pair16(8, "f16")
    x, y = a.view(np.float16).copy(), a.view(np.float16).copy()
    reducer.sum_into(x, b.view(np.float16))
    monkeypatch.undo()
    monkeypatch.setattr(reducer, "_lib", None)
    reducer.sum_into(y, b.view(np.float16))
    assert x.tobytes() == y.tobytes()


def test_failed_build_raises_and_numpy_is_explicit(monkeypatch):
    """``use_native=True`` whose build fails raises; no silent numpy
    fallback.  ``use_native=False`` is the numpy path by name."""
    monkeypatch.setattr(reducer, "_lib", None)
    monkeypatch.setattr(reducer, "_compilers", lambda: ["/bin/false"])
    with pytest.raises(RuntimeError, match="native reducer build failed"):
        AsyncParameterServer(use_native=True)
    assert not reducer.available()
    store = AsyncParameterServer(use_native=False)
    assert store.reducer == "numpy"
    monkeypatch.undo()
    monkeypatch.setattr(reducer, "_lib", None)
    assert AsyncParameterServer(use_native=True).reducer == "native"


def test_store_sums_every_dtype_as_the_jax_store():
    """The two packages' in-process shards (native reducers) give the
    same bits after the same pushes, bf16 held as a tensor here."""
    from byteps_tpu.engine.async_ps import \
        AsyncParameterServer as JaxStore

    a16, b16 = _pair16(6, "bf16")
    j, p = JaxStore(use_native=True), AsyncParameterServer(use_native=True)
    j.init_tensor("bf", a16.view(ml_dtypes.bfloat16))
    p.init_tensor("bf", torch.from_numpy(a16.view(np.int16).copy()).view(
        torch.bfloat16))
    j.push_delta("bf", b16.view(ml_dtypes.bfloat16))
    p.push_delta("bf", torch.from_numpy(b16.view(np.int16).copy()).view(
        torch.bfloat16))
    rng = np.random.RandomState(7)
    x = rng.randn(N).astype(np.float32)
    d = rng.randn(N).astype(np.float64)   # cast to the store's dtype
    j.init_tensor("w", x)
    p.init_tensor("w", x)
    jw, jv = j.push_pull_versioned("w", d)
    pw, pv = p.push_pull_versioned("w", d)
    assert jv == pv == 1 and jw.tobytes() == pw.tobytes()
    assert p.pull("bf").view(torch.int16).numpy().view(np.uint16).tobytes() \
        == j.pull("bf").view(np.uint16).tobytes()
    assert p.sum_bytes == 2 * N + 4 * N and p.sum_seconds > 0
