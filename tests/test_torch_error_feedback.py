"""Error-feedback compression in the port (compression/error_feedback.py,
ops/quantization.py, ops/sparsification.py, the DistributedOptimizer's
error feedback and ``api.push_pull``'s biased roundtrip) held against the
JAX package.

* ``error_feedback_compress`` over 4 steps fed the same gradients as
  JAX's: updates and residuals bit-equal for topk and the casts; onebit
  within 2 ulps of each step's scale (the port's float64 mean rounded
  once against JAX's float32 mean).
* At two gloo processes against JAX's 2-device ``dp`` mesh (each rank
  the gradients of JAX's device r): the bf16 roundtrip and the int8 error
  feedback each followed by ``push_pull_gradients``, and
  ``topk_ef_push_pull_gradients``, over 3 steps — updates and residuals
  bit-equal (sums of two fp32 values, one order), but for int8's: JAX's
  jitted ``absmax / 127`` is a product by the reciprocal there, a scale
  1 ulp off its eager one (which the port's equals), so those are held
  within 2 ulps of the leaf's largest update (the residuals 2 a step, as
  the carry adds the drift up).
* ``make_data_parallel_step(compression="onebit" | "topk")`` at two
  workers, 1 and 2 backward passes a step, 3 SGD-momentum steps of the
  2-layer model of test_torch_training_dp.py, against JAX's 2-device
  step: the averaged losses within 1e-5 relative and the weights within
  1e-5 (the backward sums in other orders, ≈1e-7 apart, which the
  compressors' sign and rank decisions do not reach here); both ranks
  identical; the residuals survive ``state_dict`` -> ``load_state_dict``.
* ``api.push_pull`` with a biased scheme at two workers against JAX's
  stacked eager push_pull: topk bit-equal, onebit within 2 ulps of the
  scales, randomk the same mask on both ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from byteps_tpu import compression as jc
from byteps_tpu.models import transformer as jt
from byteps_tpu.ops.quantization import \
    error_feedback_quantize_gradients as jax_ef_int8
from byteps_tpu.ops.sparsification import \
    topk_ef_push_pull_gradients as jax_topk_ef
from byteps_tpu.parallel.collectives import shard_map
from byteps_tpu.training.optimizer import \
    push_pull_gradients as jax_push_pull_gradients
from byteps_tpu.training.step import lm_loss_fn as jax_lm_loss_fn
from byteps_tpu.training.step import make_data_parallel_step as jax_step
from byteps_tpu_torch import api
from byteps_tpu_torch import compression as pc
from byteps_tpu_torch.models import transformer as pt
from byteps_tpu_torch.models.convert import from_jax_params
from byteps_tpu_torch.training import lm_loss_fn, make_data_parallel_step
from torch_dist_workers import (EF_COMBOS, EF_SHAPES, ef_grads,
                                ef_train_cases, ef_transform_cases,
                                np_of, run_workers)

SEED = 3
STEPS = 3
TOL = 1e-5
V, T, B = 97, 32, 4
CFG = dict(vocab_size=V, num_layers=2, num_heads=4, num_kv_heads=2,
           d_model=64, d_ff=128, max_seq_len=64, norm_eps=1e-5,
           pos_emb="rope", rope_theta=500000.0, mlp="swiglu",
           tie_embeddings=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_api():
    yield
    api.shutdown()


def _ulp(v) -> float:
    return float(np.spacing(np.float32(abs(v))))


# --------------------------------------------------- the transform alone


@pytest.mark.parametrize("scheme", ["topk", "bf16", "fp16", "onebit"])
def test_error_feedback_compress_matches_jax_over_four_steps(scheme):
    tx = pc.error_feedback_compress(scheme, ratio=0.1, seed=0)
    jtx = jc.error_feedback_compress(scheme, ratio=0.1, seed=0)
    g0 = [torch.from_numpy(g) for g in ef_grads(SEED, 0, 0)]
    st, jst = tx.init(g0), jtx.init([jnp.asarray(g.numpy()) for g in g0])
    for step in range(4):
        g = ef_grads(SEED, 0, step)
        up, st = tx.update([torch.from_numpy(x) for x in g], st)
        jup, jst = jtx.update([jnp.asarray(x) for x in g], jst)
        assert st.count == int(jst.count) == step + 1
        for u, ju, e, je in zip(up, jup, st.error, jst.error):
            ju, je = np.asarray(ju), np.asarray(je)
            if scheme != "onebit":
                np.testing.assert_array_equal(u.numpy(), ju)
                np.testing.assert_array_equal(e.numpy(), je)
                continue
            # the dequantized leaf is ±scale: the port's the float64
            # mean of |g + e| rounded once, JAX's within 2 ulps of it;
            # the signs equal, and the residuals as close
            scale = float(np.abs(ju).max())
            assert abs(float(u.abs().max()) - scale) <= 2 * _ulp(scale)
            np.testing.assert_array_equal(np.sign(u.numpy()), np.sign(ju))
            np.testing.assert_allclose(e.numpy(), je, rtol=0,
                                       atol=(step + 1) * 2 * _ulp(scale))


def test_error_feedback_residual_is_the_unsent_part():
    """``e' = g + e - deq`` exactly; a seeded scheme replays from the same
    state and moves its mask with the count."""
    tx = pc.error_feedback_compress("randomk", ratio=0.1, seed=5)
    g = [torch.from_numpy(x) for x in ef_grads(SEED, 1, 0)]
    st = tx.init(g)
    up, st1 = tx.update(g, st)
    for a, d, e in zip(g, up, st1.error):
        assert torch.equal(e, a - d)
    again, _ = tx.update(g, st)
    assert all(torch.equal(a, b) for a, b in zip(up, again))
    later, _ = tx.update(g, pc.EFCompressState(st.error, 7))
    assert not torch.equal(up[1], later[1])


# ------------------------------------------- two processes vs two devices


@pytest.fixture(scope="module")
def port_transforms():
    return run_workers(2, ef_transform_cases, SEED, STEPS)


def _jax_transform_runs():
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    steps = [[np.stack([ef_grads(SEED, r, s)[i] for r in range(2)])
              for i in range(len(EF_SHAPES))] for s in range(STEPS)]

    def sq(t):
        return jax.tree_util.tree_map(lambda a: a[0], t)

    def ex(t):
        return jax.tree_util.tree_map(lambda a: a[None], t)

    out = {}
    for name, tx in (
            ("bf16", optax.chain(jc.compression_roundtrip("bf16"),
                                 jax_push_pull_gradients(
                                     "dp", partition_bytes=512))),
            ("int8", optax.chain(jax_ef_int8(), jax_push_pull_gradients(
                "dp", partition_bytes=512))),
            ("topk", jax_topk_ef(ratio=0.1, axis_name="dp"))):
        init = jax.jit(shard_map(lambda g: ex(tx.init(sq(g))), mesh,
                                 in_specs=(P("dp"),), out_specs=P("dp")))
        upd = jax.jit(shard_map(
            lambda g, s: ex(tx.update(sq(g), sq(s))), mesh,
            in_specs=(P("dp"), P("dp")), out_specs=P("dp")))
        st = init(steps[0])
        rows = []
        for g in steps:
            up, st = upd(g, st)
            err = (st[0].error if name == "int8" else
                   st.error if name == "topk" else [])
            rows.append(([np.asarray(u) for u in up],
                         [np.asarray(e) for e in err]))
        out[name] = rows
    return out


@pytest.mark.parametrize("name", ["bf16", "int8", "topk"])
def test_transforms_at_two_processes_bit_equal_to_two_devices(
        port_transforms, name):
    want = _jax_transform_runs()[name]

    def same(a, b, ref, steps):
        if name != "int8":
            np.testing.assert_array_equal(a, b)
        else:   # XLA's jit divides by 127 as a product: scales 1 ulp off
            np.testing.assert_allclose(
                a, b, rtol=0, atol=2 * steps * _ulp(np.abs(ref).max()))

    for r in range(2):
        for s, ((up, err), (jup, jerr)) in enumerate(
                zip(port_transforms[r][name], want)):
            for u, ju in zip(up, jup):
                same(u, ju[r], ju, 1)
            assert len(err) == len(jerr)
            for e, je, ju in zip(err, jerr, jup):
                same(e, je[r], ju, s + 1)
    # the updates are the mean over the ranks: the same on both
    for a, b in zip(port_transforms[0][name], port_transforms[1][name]):
        for u0, u1 in zip(a[0], b[0]):
            np.testing.assert_array_equal(u0, u1)


# ------------------------------------- the step with a biased compressor


def _batches():
    return [np.random.RandomState(s).randint(0, V, size=(B, T)).astype(
        np.int32) for s in (21, 22, 23)]


def _sd(tree):
    pcfg = pt.TransformerConfig(dtype=torch.float32, **CFG)
    return {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, tree), pcfg).items()}


@pytest.fixture(scope="module")
def jax_params():
    return jt.Transformer(jt.TransformerConfig(
        dtype=jnp.float32, **CFG)).init(
            jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def port_train(jax_params):
    return run_workers(2, ef_train_cases, CFG, _sd(jax_params), _batches(),
                       timeout=150)


def _jax_train(params, bpps, scheme):
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    model = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **CFG))
    step = jax_step(jax_lm_loss_fn(model), optax.sgd(0.1, momentum=0.9),
                    mesh, compression=scheme, backward_passes_per_step=bpps)
    state = step.init_state(params)
    losses = []
    for b in _batches():
        state, m = step(state, {"tokens": jnp.asarray(b)})
        losses.append(float(m["loss"]))
    return losses, _sd(state.params)


@pytest.mark.parametrize("bpps,scheme", EF_COMBOS)
def test_two_worker_compressed_step_matches_jax(port_train, jax_params,
                                                bpps, scheme):
    jlosses, jparams = _jax_train(jax_params, bpps, scheme)
    (l0, p0, e0, c0, ok0), (l1, p1, e1, c1, ok1) = (
        port_train[0][(bpps, scheme)], port_train[1][(bpps, scheme)])
    assert l0 == l1
    for got, want in zip(l0, jlosses):
        assert abs(got - want) <= TOL * abs(want), (l0, jlosses)
    for n in jparams:
        np.testing.assert_array_equal(p0[n], p1[n], err_msg=n)
        np.testing.assert_allclose(p0[n], jparams[n], rtol=0, atol=TOL,
                                   err_msg=n)
    # JAX's MultiSteps steps the chain once a cycle: 3 steps, 1 pass
    # each: 3 counts; 2 passes each: 1 (steps 1-2), step 3 half a cycle
    assert c0 == c1 == (3 if bpps == 1 else 1)
    assert ok0 and ok1     # residuals through state_dict / load_state_dict
    assert any(np.abs(e).max() > 0 for e in e0)
    if bpps == 2:
        assert l0[0] != l0[1]


def test_world1_compressed_step_runs_error_feedback_locally():
    """One worker: a biased name wraps the optimizer with local error
    feedback (JAX's world-1 chain), a cast rounds the gradients, a
    registry class applies its stateless roundtrip; the residuals ride
    the optimizer's ``state_dict`` and a mismatched one is refused."""
    from byteps_tpu_torch.ops.compression import Compression

    api.init(device="cpu")
    torch.manual_seed(0)
    lin = torch.nn.Linear(6, 3)
    x = torch.randn(5, 6)

    def loss_fn(m, ms, b):
        return m(b["x"]).square().mean(), ms

    base = torch.optim.SGD(lin.parameters(), lr=0.1)
    step = make_data_parallel_step(loss_fn, base, compression="onebit")
    st = step.init_state(lin)
    before = lin.weight.detach().clone()
    st, _ = step(st, {"x": x})
    opt = step.optimizer
    assert opt is base and opt.ef_state.count == 1
    delta = (lin.weight.detach() - before).abs()
    assert torch.allclose(delta, delta[0, 0].expand_as(delta))  # ±lr*scale
    sd = opt.state_dict()
    assert sd["bps_compression"]["count"] == 1
    other = make_data_parallel_step(
        loss_fn, torch.optim.SGD(torch.nn.Linear(6, 3).parameters(), lr=0.1),
        compression="topk").optimizer
    other.load_state_dict(sd)
    assert all(torch.equal(a, b) for a, b in zip(other.ef_state.error,
                                                 opt.ef_state.error))
    with pytest.raises(ValueError, match="error-feedback"):
        opt.load_state_dict({k: v for k, v in sd.items()
                             if k != "bps_compression"})
    for spec in (Compression.resolve("onebit"), "bf16"):
        lin2 = torch.nn.Linear(6, 3)
        s2 = make_data_parallel_step(
            loss_fn, torch.optim.SGD(lin2.parameters(), lr=0.1),
            compression=spec)
        assert not hasattr(s2.optimizer, "ef_state")
        s2(s2.init_state(lin2), {"x": x})


# ------------------------------------------------------ api.push_pull


def test_push_pull_biased_schemes_at_two_workers_match_jax_stacked(
        port_transforms):
    """Each worker's contribution rounds before the collective, with its
    own scale (JAX's stacked eager form rounds each row)."""
    import byteps_tpu as bps

    xs = np.stack([ef_grads(SEED, r, 9)[1] for r in range(2)])
    bps.init(mesh=Mesh(np.array(jax.devices()[:2]), ("dp",)))
    try:
        want = {n: np.asarray(bps.push_pull(jnp.asarray(xs), average=True,
                                            name=f"pp_{n}", compression=n))
                for n in ("onebit", "topk")}
    finally:
        bps.shutdown()
    got = [port_transforms[r]["push_pull"] for r in range(2)]
    for n in ("onebit", "topk", "randomk"):
        np.testing.assert_array_equal(got[0][n], got[1][n])
    np.testing.assert_array_equal(got[0]["topk"], want["topk"])
    scales = np.abs(xs).mean(axis=1)
    np.testing.assert_allclose(got[0]["onebit"], want["onebit"], rtol=0,
                               atol=2 * max(_ulp(s) for s in scales))
    # randomk: one mask on both ranks, drawn from derive_seed(config
    # seed, name, first call), the mean of both contributions there
    k = max(1, int(xs.shape[1] * 0.01))
    gen = torch.Generator().manual_seed(pc.derive_seed(0, "pp_randomk", 1))
    idx = torch.randperm(xs.shape[1], generator=gen)[:k].numpy()
    expect = np.zeros(xs.shape[1], np.float32)
    expect[idx] = (xs[0, idx] + xs[1, idx]) / 2
    np.testing.assert_array_equal(got[0]["randomk"], expect)
