"""The port's mesh and collectives (byteps_tpu_torch.parallel) held
against the JAX package's (byteps_tpu.parallel).

The port runs 2 and 4 ``gloo`` processes on loopback, each with its own
contribution made by numpy from a seed (tests/torch_dist_workers.py);
the JAX side makes the same contributions, stacks them on a leading
worker axis and runs its collectives on a 2- or 4-device CPU mesh.
Rank ``r`` is device ``r`` of the mesh (row-major in the canonical axis
order on both sides).

Tolerances: at world 2 every result is bit-identical (a sum of two
terms, an average by 2, a bf16/fp16 wire and the scatter-adds of
duplicate rows do not depend on order).  At world 4 the summation order
of gloo's ring and XLA's all-reduce differ, so a sum is held within
``world - 1`` ulps of the sum of the contributions' magnitudes,
elementwise (in bf16 ulps for a bf16 wire): each order's three roundings
are each at most half an ulp of that magnitude, so two orders differ by
at most three.  One ulp, asked for first, does not hold: results differ
by two (seen on this host's gloo).  A broadcast and the span layout stay
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from byteps_tpu.parallel import collectives as jc
from byteps_tpu.parallel import mesh as jmesh
from byteps_tpu_torch.parallel import mesh as pmesh
from torch_dist_workers import (SPARSE_ROWS, collective_cases,
                                collective_inputs, run_workers)

SEED = 3


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request):
    return request.param


_RUNS = {}


def _port(world):
    """Every rank's results of ``collective_cases`` (one spawn a world)."""
    if world not in _RUNS:
        _RUNS[world] = run_workers(world, collective_cases, SEED)
    return _RUNS[world]


@pytest.fixture(scope="module")
def port(world):
    return _port(world)


@pytest.fixture(scope="module")
def port4():
    return _port(4)


def _stack(world, key):
    return np.stack([collective_inputs(SEED, r)[key] for r in range(world)])


def _mesh(world, names=("dp",), dims=None):
    devs = np.array(jax.devices()[:world])
    return Mesh(devs.reshape(dims or (world,)), names)


def _close(got, want, world, stacked=None, dtype=np.float32):
    """Bit-identical at world 2; at world 4 within ``world - 1`` ulps (of
    ``dtype``) of the summed magnitudes."""
    got, want = np.asarray(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if world == 2:
        np.testing.assert_array_equal(got, want)
        return
    mag = np.abs(stacked).sum(0).reshape(want.shape).astype(np.float32)
    # bf16 keeps 8 significand bits and fp16 11, against fp32's 24
    ulp = np.spacing(mag) * {jnp.bfloat16: 2 ** 16,
                             np.float16: 2 ** 13}.get(dtype, 1)
    bad = np.abs(got - want) > (world - 1) * ulp
    assert not bad.any(), (np.abs(got - want)[bad][:5], ulp[bad][:5])


def _stacked_pp(world, key, average, wire=None, names=("dp",), dims=None):
    mesh = _mesh(world, names, dims)
    return np.asarray(jc.push_pull_stacked(
        jnp.asarray(_stack(world, key)), mesh, names, average=average,
        wire_dtype=wire))


@pytest.mark.parametrize("case,key,average,wire", [
    ("sum", "odd", False, None), ("avg", "odd", True, None),
    ("bf16", "small", True, "bfloat16"), ("fp16", "small", False,
                                           "float16")])
def test_push_pull_shard_matches_jax(world, port, case, key, average,
                                     wire):
    """Sizes 1001 and 777 do not divide the world: the pad and the trim
    match too; the wire casts round where JAX's do."""
    want = _stacked_pp(world, key, average, wire)
    dtype = {"bfloat16": jnp.bfloat16, "float16": np.float16}.get(
        wire, np.float32)
    for r in range(world):
        _close(port[r][case], want, world, _stack(world, key), dtype)


def test_sum_without_a_scatter_axis_matches_jax(world, port):
    mesh = _mesh(world)
    fn = jax.jit(jc.shard_map(
        lambda x: jc.push_pull_shard(x[0], scatter_axis=None,
                                     sum_axes=("dp",)),
        mesh, in_specs=P("dp"), out_specs=P()))
    want = np.asarray(fn(jnp.asarray(_stack(world, "odd"))))
    for r in range(world):
        _close(port[r]["sum_only"], want, world, _stack(world, "odd"))


def test_broadcast_shard_is_the_roots_value(world, port):
    want = np.asarray(jc.broadcast_stacked(
        jnp.asarray(_stack(world, "odd")), _mesh(world), ("dp",),
        root_rank=1))
    for r in range(world):
        np.testing.assert_array_equal(port[r]["bcast"], want)
        np.testing.assert_array_equal(port[r]["bcast"],
                                      collective_inputs(SEED, 1)["odd"])


def _jax_sparse(world, names=("dp",), dims=None):
    mesh = _mesh(world, names, dims)
    fn = jax.jit(jc.shard_map(
        lambda i, v: jc.sparse_push_pull(i[0], v[0], SPARSE_ROWS,
                                         axes=names),
        mesh, in_specs=(P(names), P(names)), out_specs=P()))
    idx = _stack(world, "sparse_idx").astype(np.int32)
    val = _stack(world, "sparse_val")
    if dims:
        idx, val = idx.reshape(dims + idx.shape[1:]), \
            val.reshape(dims + val.shape[1:])
    return np.asarray(fn(jnp.asarray(idx), jnp.asarray(val)))


def test_sparse_push_pull_with_duplicate_rows_matches_jax(world, port):
    want = _jax_sparse(world)
    vals = _stack(world, "sparse_val")
    mag = np.zeros((SPARSE_ROWS, vals.shape[-1]), np.float32)
    for r in range(world):
        for i, row in zip(collective_inputs(SEED, r)["sparse_idx"],
                          vals[r]):
            if i < SPARSE_ROWS:
                mag[i] += np.abs(row)
    for r in range(world):
        _close(port[r]["sparse"], want, world, mag[None])


def test_reduce_scatter_spans_keep_the_ceil_chunk_layout(world, port):
    """Span r of the sum is ``[r*c, (r+1)*c)`` with ``c = ceil(n/world)``,
    the last one clipped (1003 does not divide 2 or 4)."""
    spans = jc.reduce_scatter_spans(_stack(world, "spans"), _mesh(world),
                                    "dp")
    n, c = 1003, -(-1003 // world)
    for r in range(world):
        assert port[r]["spans"].shape[0] == min(c, n - r * c)
        _close(port[r]["spans"], spans[r], world,
               _stack(world, "spans")[:, r * c:(r + 1) * c])


def test_local_reduce_scatter_and_all_gather_match_jax(world, port):
    mesh = _mesh(world)
    flat = np.asarray(jc.local_reduce_scatter(_stack(world, "even"), mesh,
                                              "dp"))
    full = np.asarray(jc.local_all_gather(flat, mesh, "dp"))
    c = 1000 // world
    stacked = _stack(world, "even")
    for r in range(world):
        _close(port[r]["lrs"], flat[r * c:(r + 1) * c], world,
               stacked[:, r * c:(r + 1) * c])
        _close(port[r]["lag"], full, world, stacked)


def test_push_pull_tree_matches_jax(world, port):
    """Three leaves over 400-byte buckets (leaf b splits across buckets);
    the port's list order is JAX's sorted-key order."""
    mesh = _mesh(world)
    trees = [dict(collective_inputs(SEED, r)["tree"]) for r in range(world)]
    stacked = {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    fn = jax.jit(jc.shard_map(
        lambda t: jc.push_pull_tree(jax.tree_util.tree_map(lambda x: x[0],
                                                           t),
                                    scatter_axis="dp", average=True,
                                    partition_bytes=400),
        mesh, in_specs=P("dp"), out_specs=P()))
    want = fn({k: jnp.asarray(v) for k, v in stacked.items()})
    for r in range(world):
        for i, k in enumerate(("a", "b", "c")):
            _close(port[r][f"tree{i}"], np.asarray(want[k]), world,
                   stacked[k])


def test_push_pull_gradients_matches_jaxs_tree_reduce(world, port):
    """``training.optimizer.push_pull_gradients`` over the mesh's data
    axes is JAX's in-graph ``push_pull_tree`` (average on)."""
    mesh = _mesh(world)
    trees = [dict(collective_inputs(SEED, r)["tree"]) for r in range(world)]
    stacked = {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    fn = jax.jit(jc.shard_map(
        lambda t: jc.push_pull_tree(jax.tree_util.tree_map(lambda x: x[0],
                                                           t),
                                    scatter_axis="dp", average=True,
                                    partition_bytes=400),
        mesh, in_specs=P("dp"), out_specs=P()))
    want = fn({k: jnp.asarray(v) for k, v in stacked.items()})
    for r in range(world):
        for i, k in enumerate(("a", "b", "c")):
            _close(port[r][f"ppg{i}"], np.asarray(want[k]), world,
                   stacked[k])


def test_resolve_local_axis_matches_jax():
    from byteps_tpu.training.optimizer import resolve_local_axis as jrla
    from byteps_tpu_torch.training.optimizer import resolve_local_axis

    for axes, local in ((("dp",), None), (("dcn", "dp"), None),
                        (("dcn", "dp"), "dcn"), (("dcn", "dp", "fsdp"),
                                                 "dp")):
        assert resolve_local_axis(axes, local) == jrla(axes, local)
    with pytest.raises(ValueError, match="local_axis"):
        resolve_local_axis(("dp",), "dcn")


@pytest.mark.parametrize("case,key,average,wire", [
    ("h_sum", "odd", False, None), ("h_avg", "odd", True, None),
    ("h_bf16", "small", True, "bfloat16")])
def test_hierarchical_push_pull_over_dcn_and_dp(port4, case, key, average,
                                                wire):
    """World 4 as ``dcn=2,dp=2``: reduce-scatter over dp, sum over dcn,
    all-gather over dp, against JAX's stacked push_pull over
    ``("dcn", "dp")`` on a 2x2 mesh."""
    port = port4
    want = _stacked_pp(4, key, average, wire, ("dcn", "dp"), (2, 2))
    dtype = jnp.bfloat16 if wire else np.float32
    for r in range(4):
        assert tuple(port[r]["h_coords"]) == (r // 2, r % 2)
        _close(port[r][case], want, 4, _stack(4, key), dtype)


def test_mesh_shapes_and_axis_lines_match_jax():
    """The port sizes its mesh as JAX's ``build_mesh`` does, and rank r
    sits where device r sits in JAX's device array."""
    devs = jax.devices()
    for world, shape, force in ((4, None, False), (4, {"dcn": 2}, False),
                                (4, {"dp": 2, "dcn": 2}, False),
                                (8, {"dcn": 2}, False),
                                (8, None, True), (6, {"fsdp": 3}, False)):
        jm = jmesh.build_mesh(devices=devs[:world], mesh_shape=shape,
                              force_distributed=force)
        got = pmesh.mesh_shape_for(world, shape, force_distributed=force)
        assert dict(got) == dict(jm.shape)
        assert tuple(got) == tuple(jm.axis_names)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        for k, axis in enumerate(got):
            lines = np.moveaxis(ids, k, -1).reshape(-1, got[axis])
            assert sorted(pmesh._lines(got, axis)) == \
                sorted(row.tolist() for row in lines)
    assert pmesh.parse_mesh_shape("dcn=2, dp=4") == \
        jmesh.parse_mesh_shape("dcn=2, dp=4")
    for spec in ("tp=2", "dp=2,sp=2", "pp=2", "ep=4"):
        jmesh.parse_mesh_shape(spec)   # JAX takes it
        with pytest.raises(NotImplementedError, match="item 12"):
            pmesh.parse_mesh_shape(spec)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        pmesh.parse_mesh_shape("xx=2")
