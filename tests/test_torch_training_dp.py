"""The port's data-parallel train step at two workers
(``make_data_parallel_step`` over the DistributedOptimizer and the eager
engine, byteps_tpu_torch.training) held against the JAX package's
``make_data_parallel_step`` on a 2-device ``dp`` mesh.

A 2-layer, width-64 LLaMA-shaped ``Transformer`` (local attention) is
made by the JAX model's init from a seed and carried across with
``models/convert.py``; three global batches of 4 x 32 tokens come from
numpy, rank r taking rows 2r and 2r+1 (the rows JAX's device r gets).
Three SGD-momentum steps with ``backward_passes_per_step`` 1 and 2 (the
JAX step's ``optax.MultiSteps``: the first of two steps leaves the
weights, the second applies the mean of both passes), on a wire of none
or bf16.  Tolerances: the averaged loss within 1e-5 relative, the
weights within 1e-5 absolute (fp32 sums in other orders); both ranks'
losses and weights identical.  On the bf16 wire a gradient that sits
within fp32 noise of a bf16 rounding boundary rounds to neighbouring
bf16 values on the two sides, a step of lr x one bf16 ulp of the
gradient, carried by momentum: there the weights are held within 1e-4
(4.9e-5 seen) and at most 1% of them may exceed 1e-5 (0.4% seen).  Then ``broadcast_parameters`` and
``broadcast_optimizer_state`` from rank 1 (exact), and ``Trainer.fit``
at two workers (rank 0's weights broadcast at start, identical losses
and weights on both ranks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from byteps_tpu.models import transformer as jt
from byteps_tpu.training.step import lm_loss_fn as jax_lm_loss_fn
from byteps_tpu.training.step import make_data_parallel_step as jax_step
from byteps_tpu_torch.models import transformer as pt
from byteps_tpu_torch.models.convert import from_jax_params
from torch_dist_workers import TRAIN_COMBOS, run_workers, train_cases

TOL = 1e-5
V, T, B = 97, 32, 4
CFG = dict(vocab_size=V, num_layers=2, num_heads=4, num_kv_heads=2,
           d_model=64, d_ff=128, max_seq_len=64, norm_eps=1e-5,
           pos_emb="rope", rope_theta=500000.0, mlp="swiglu",
           tie_embeddings=True)


def _batches():
    return [np.random.RandomState(s).randint(0, V, size=(B, T)).astype(
        np.int32) for s in (11, 12, 13)]


@pytest.fixture(scope="module")
def jax_params():
    return jt.Transformer(jt.TransformerConfig(
        dtype=jnp.float32, **CFG)).init(
            jax.random.PRNGKey(2), jnp.zeros((1, 8), jnp.int32))["params"]


def _sd(tree):
    pcfg = pt.TransformerConfig(dtype=torch.float32, **CFG)
    return {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, tree), pcfg).items()}


@pytest.fixture(scope="module")
def port(jax_params):
    return run_workers(2, train_cases, CFG, _sd(jax_params), _batches(),
                       timeout=150)


@pytest.fixture(scope="module")
def jax_runs(jax_params):
    """JAX's two-device runs of every combo (set-up: the jitted step's
    compile is the slow part)."""
    return {c: _jax_run(jax_params, *c) for c in TRAIN_COMBOS}


def _jax_run(params, bpps, wire):
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    model = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **CFG))
    step = jax_step(jax_lm_loss_fn(model), optax.sgd(0.1, momentum=0.9),
                    mesh, compression=wire, backward_passes_per_step=bpps)
    state = step.init_state(params)
    losses = []
    for b in _batches():
        state, m = step(state, {"tokens": jnp.asarray(b)})
        losses.append(float(m["loss"]))
    return losses, _sd(state.params)


@pytest.mark.parametrize("bpps,wire", TRAIN_COMBOS)
def test_two_worker_step_matches_jax_two_device_step(port, jax_runs,
                                                     bpps, wire):
    jlosses, jparams = jax_runs[(bpps, wire)]
    (l0, p0), (l1, p1) = port[0][(bpps, wire)], port[1][(bpps, wire)]
    assert l0 == l1
    for got, want in zip(l0, jlosses):
        assert abs(got - want) <= TOL * abs(want), (l0, jlosses)
    for n in jparams:
        np.testing.assert_array_equal(p0[n], p1[n], err_msg=n)
        np.testing.assert_allclose(p0[n], jparams[n], rtol=0, err_msg=n,
                                   atol=TOL if wire == "none" else 1e-4)
        assert np.mean(np.abs(p0[n] - jparams[n]) > TOL) <= 0.01, n
    if bpps == 2:   # the first mini step left the weights as they were
        assert l0[0] != l0[1]


def test_broadcast_parameters_and_optimizer_state_from_rank_1(port):
    (before1, _), (after0, after1) = (port[1]["bcast"][0], None), \
        (port[0]["bcast"][1], port[1]["bcast"][1])
    params1, state1, lr1 = before1
    for after in (after0, after1):
        params, state, lr = after
        assert lr == lr1 == 2e-3
        for n in params1:
            np.testing.assert_array_equal(params[n], params1[n], err_msg=n)
        assert set(state) == set(state1)
        for k in state1:
            np.testing.assert_array_equal(state[k], state1[k], err_msg=k)
    # rank 0 really held other values before
    p0 = port[0]["bcast"][0][0]
    assert any(not np.array_equal(p0[n], params1[n]) for n in p0)


def test_trainer_fit_at_two_workers_agrees_across_ranks(port):
    (l0, ev0, p0), (l1, ev1, p1) = port[0]["trainer"], port[1]["trainer"]
    assert l0 == l1 and ev0 == ev1
    assert all(np.isfinite(l0))
    for n in p0:
        np.testing.assert_array_equal(p0[n], p1[n], err_msg=n)


def test_distributed_optimizer_used_directly(port):
    """Named parameters and an explicit ``synchronize()``: ``p.grad`` is
    the mean of both ranks' gradients (each computed on both ranks from
    the seeded data); at two passes a step the first ``step()`` returns
    None and leaves the weights; a second backward before ``step()`` is
    refused."""
    for res in port:
        got, want = res["dopt_grads"]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)
        stepped, mid, before = res["dopt_first_pass"]
        assert stepped is None
        for a, b in zip(mid, before):
            np.testing.assert_array_equal(a, b)
        assert any(not np.array_equal(a, b)
                   for a, b in zip(res["dopt_after"], before))
        assert res["dopt_buckets"] >= 2      # 32-byte buckets split W
        assert "more than once" in res["dopt_twice"]
    for a, b in zip(port[0]["dopt_after"], port[1]["dopt_after"]):
        np.testing.assert_array_equal(a, b)
