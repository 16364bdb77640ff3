"""The rest of the worker's training path in the port — callbacks and
schedules, checkpoints, the delayed-gradient overlap step and the serve
role's checkpoint — held against the JAX package where it has the same
function.

* The schedules' values at steps 0..N equal JAX's bit for bit (both in
  float32); ``MomentumCorrectedSGD`` across a drop of the learning rate
  gives JAX's ``momentum_corrected_sgd`` updates within 1e-6.
* ``CheckpointManager``'s names, ``save_every`` and ``keep``; a save that
  dies mid-write leaves the last good step; save -> restore -> continue
  on the CPU is bit-identical to the uninterrupted run, the onebit
  residuals and the overlap step's pending gradients included, and a
  zeroed residual is not (the residual is in the checkpoint).
* ``make_delayed_grad_step`` and ``Trainer(overlap=True)`` at two gloo
  processes against JAX's delayed step on a 2-device mesh (the 2-layer
  model of test_torch_training_dp.py, 3 SGD-momentum steps and a flush):
  losses within 1e-5 relative, weights within 1e-5; the exact staleness
  (update N uses g_{N-1}) at one worker against a hand computation.
* A string compression spec under overlap is refused by the port; JAX's
  delayed step drops it without a word (its result equals the
  uncompressed one) — pinned here, ROADMAP queue C.
* At two workers: ``average_metrics``, ``BroadcastGlobalVariablesCallback``
  from rank 1, and a checkpoint written by rank 0 alone and restored on
  both ranks through the broadcast (rank 1's own directory stays empty).
* ``serve_from_env`` with ``BYTEPS_SERVE_CHECKPOINT`` serves the saved
  weights: its tokens equal ``generate()`` on them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from byteps_tpu.models import transformer as jt
from byteps_tpu.training import callbacks as jcb
from byteps_tpu.training.overlap import make_delayed_grad_step as jax_delayed
from byteps_tpu.training.step import lm_loss_fn as jax_lm_loss_fn
from byteps_tpu_torch import api
from byteps_tpu_torch.models import transformer as pt
from byteps_tpu_torch.models.convert import from_jax_params
from byteps_tpu_torch.ops.compression import Compression
from byteps_tpu_torch.training import (CheckpointManager,
                                       MomentumCorrectedSGD, Trainer,
                                       lm_loss_fn, make_delayed_grad_step,
                                       multiplier_schedule, restore_checkpoint,
                                       save_checkpoint, scaled_lr,
                                       warmup_schedule)
from byteps_tpu_torch.training import checkpoint as ckpt_mod
from torch_dist_workers import extras_cases, run_workers

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


def _batches(n=3):
    return [np.random.RandomState(s).randint(0, V, size=(B, T)).astype(
        np.int32) for s in range(31, 31 + n)]


def _model(seed):
    m = pt.Transformer(pt.TransformerConfig(dtype=torch.float32, **CFG))
    pt.init_weights(m, seed)
    return m


def _weights(m):
    return {n: p.detach().numpy().copy() for n, p in m.named_parameters()}


# ------------------------------------------------------------- schedules


def test_schedules_equal_jax_bit_for_bit():
    cases = [
        (warmup_schedule(0.1, 8, 10), jcb.warmup_schedule(0.1, 8, 10)),
        (warmup_schedule(0.05, 3, 7), jcb.warmup_schedule(0.05, 3, 7)),
        (warmup_schedule(0.1, 4, 0), jcb.warmup_schedule(0.1, 4, 0)),
        (warmup_schedule(0.1, 4, 10, after=multiplier_schedule(
            0.4, {5: 0.1})),
         jcb.warmup_schedule(0.1, 4, 10, after=jcb.multiplier_schedule(
             0.4, {5: 0.1}))),
        (multiplier_schedule(0.4, {30: 0.1, 60: 0.01}),
         jcb.multiplier_schedule(0.4, {30: 0.1, 60: 0.01})),
        (multiplier_schedule(0.3, {}), jcb.multiplier_schedule(0.3, {}))]
    for got, want in cases:
        for step in range(0, 80):
            assert got(step) == float(want(step)), step
    assert scaled_lr(0.1, 8) == jcb.scaled_lr(0.1, 8)


def test_schedule_through_lambda_lr():
    w = torch.nn.Parameter(torch.zeros(2))
    opt = torch.optim.SGD([w], lr=1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(opt,
                                              warmup_schedule(0.1, 4, 3))
    seen = []
    for _ in range(5):
        seen.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    want = jcb.warmup_schedule(0.1, 4, 3)
    assert seen == [float(want(s)) for s in range(5)]


def test_momentum_corrected_sgd_matches_jax_across_a_rate_drop():
    sched = multiplier_schedule(0.1, {2: 0.1, 4: 0.5})
    jtx = jcb.momentum_corrected_sgd(
        jcb.multiplier_schedule(0.1, {2: 0.1, 4: 0.5}), momentum=0.9)
    rng = np.random.RandomState(0)
    w0 = rng.randn(6, 5).astype(np.float32)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = MomentumCorrectedSGD([w], sched, momentum=0.9)
    jw = jnp.asarray(w0)
    jst = jtx.init(jw)
    for step in range(6):
        g = rng.randn(6, 5).astype(np.float32)
        before = w.detach().clone()
        w.grad = torch.from_numpy(g)
        opt.step()
        up, jst = jtx.update(jnp.asarray(g), jst)
        jw = optax.apply_updates(jw, up)
        np.testing.assert_allclose((w.detach() - before).numpy(),
                                   np.asarray(up), rtol=0, atol=1e-6)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw),
                                   rtol=0, atol=1e-6)
    assert opt.param_groups[0]["step"] == 6
    sd = opt.state_dict()
    assert sd["param_groups"][0]["prev_lr"] == float(np.float32(0.05))


# ------------------------------------------------------------ checkpoints


def test_checkpoint_manager_names_every_and_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), save_every=2, keep=2)
    st = {"w": torch.arange(4.0), "n": 3, "nested": [torch.ones(2), "x"]}
    paths = [mgr.maybe_save(st, s) for s in range(1, 8)]
    assert paths[0] is None and paths[1].endswith("step_0000000002")
    assert [p is not None for p in paths] == [False, True, False, True,
                                             False, True, False]
    assert mgr.steps() == [4, 6]
    assert sorted(os.listdir(mgr.directory)) == ["step_0000000004",
                                                 "step_0000000006"]
    tree, step = mgr.restore_latest()
    assert step == 6 and tree["n"] == 3 and tree["nested"][1] == "x"
    assert torch.equal(tree["w"], st["w"])
    # the file holds tensors and plain containers: weights_only reads it
    torch.load(os.path.join(mgr.directory, "step_0000000006",
                            "checkpoint.pt"), weights_only=True)
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest() == \
        (None, -1)
    os.makedirs(os.path.join(mgr.directory, "step_junk"))
    assert mgr.steps() == [4, 6]
    with pytest.raises(FileExistsError):
        save_checkpoint(os.path.join(mgr.directory, "step_0000000006"), st,
                        force=False)


def test_a_save_that_dies_mid_write_leaves_the_last_good_step(
        tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), save_every=1, keep=3)
    mgr.maybe_save({"w": torch.ones(3)}, 1)
    real = torch.save

    def dying(obj, f, *a, **k):
        real(obj, f, *a, **k)
        f.truncate(10)
        raise KeyboardInterrupt("killed mid-save")

    monkeypatch.setattr(ckpt_mod.torch, "save", dying)
    with pytest.raises(KeyboardInterrupt):
        mgr.maybe_save({"w": torch.zeros(3)}, 2)
    with pytest.raises(KeyboardInterrupt):   # over an existing step too
        mgr.maybe_save({"w": torch.zeros(3)}, 1)
    monkeypatch.setattr(ckpt_mod.torch, "save", real)
    assert mgr.steps() == [1]
    assert os.listdir(tmp_path) == ["step_0000000001"]   # no temp left
    tree, step = mgr.restore_latest()
    assert step == 1 and torch.equal(tree["w"], torch.ones(3))


def _sha(m) -> bytes:
    import hashlib

    h = hashlib.sha256()
    for _, p in m.named_parameters():
        h.update(p.detach().numpy().tobytes())
    return h.digest()


def _run(batches, d=None, seed=0, zero_residual=False, every=2, **kw):
    m = _model(seed)
    tr = Trainer(lm_loss_fn(m), torch.optim.AdamW(
        m.parameters(), lr=1e-3, weight_decay=1e-4), device="cpu",
        checkpoint_dir=d, checkpoint_every=every, checkpoint_keep=1,
        log_every=0, **kw)
    losses = []
    tr.callbacks.append(lambda st: losses.append(tr.metrics["loss"].item()))
    tr.state = tr.init_state(m)
    if zero_residual:
        for e in tr.state.optimizer.ef_state.error:
            e.zero_()
    tr.fit(m, {}, [{"tokens": b} for b in batches])
    out = (losses, _sha(m), tr.state.step)
    api.shutdown()
    return out


@pytest.mark.parametrize("kw", [dict(compression="onebit"),
                                dict(overlap=True),
                                dict(compression="topk",
                                     backward_passes_per_step=2, every=3)],
                         ids=["onebit", "overlap", "topk_two_passes"])
def test_resume_is_bit_identical_to_the_uninterrupted_run(tmp_path, kw):
    """Saved after step 2 (after step 3 at two passes a step: mid-cycle,
    the running mean in the state), resumed on other weights."""
    batches = _batches(4)
    every = kw.get("every", 2)
    full = _run(batches, **kw)
    d = str(tmp_path / "ck")
    first = _run(batches[:every], d, **kw)
    assert os.listdir(d) == [f"step_{every:010d}"]
    second = _run(batches[every:], d, seed=9, **kw)
    assert first[0] + second[0] == full[0]
    assert second[1] == full[1] and second[2] == full[2] == 4
    if every == 2:
        assert os.listdir(d) == ["step_0000000004"]   # keep=1
    if "compression" in kw and kw.get("backward_passes_per_step", 1) == 1:
        # control: the same resume with the residual zeroed differs
        d2 = str(tmp_path / "ck2")
        _run(batches[:2], d2, **kw)
        control = _run(batches[2:], d2, seed=9, zero_residual=True, **kw)
        assert control[1] != full[1] and control[0] != second[0]


def test_overlap_pending_rides_the_checkpoint(tmp_path):
    """The pending gradients g_2 are in the saved state: the save at step
    2 comes before the flush that ends ``fit``."""
    batches = _batches(3)
    d = str(tmp_path / "ck")
    _run(batches[:2], d, overlap=True)
    tree = torch.load(os.path.join(d, "step_0000000002", "checkpoint.pt"),
                      weights_only=True)
    # pending after the flush is zero; the flush came after the save
    assert any(p.abs().max() > 0 for p in tree["pending"])
    assert tree["step"] == 2 and "bps_compression" not in tree["optimizer"]


def test_restore_into_a_module_and_as_a_tree(tmp_path):
    m, other = _model(1), _model(2)
    p = save_checkpoint(str(tmp_path / "m"), m)
    assert restore_checkpoint(p, other) is other
    assert _sha(other) == _sha(m)
    tree = restore_checkpoint(p)
    assert set(tree) == set(m.state_dict())


# ------------------------------------------------------------ the overlap


def test_delayed_step_exact_staleness_at_one_worker():
    """Update N applies g_{N-1}, computed at params_{N-1}; the first
    update applies the zero pending; the flush the last gradient."""
    api.init(device="cpu")
    rng = np.random.RandomState(0)
    X = torch.from_numpy(rng.randn(8, 4).astype(np.float32))
    Y = torch.from_numpy(rng.randn(8, 2).astype(np.float32))
    lin = torch.nn.Linear(4, 2, bias=False)

    def loss_fn(m, ms, b):
        return ((m(b["x"]) - b["y"]) ** 2).mean(), ms

    lr = 0.1
    step = make_delayed_grad_step(loss_fn, torch.optim.SGD(
        lin.parameters(), lr=lr))
    state = step.init_state(lin)

    def grad_at(w):
        w = w.clone().requires_grad_(True)
        ((X @ w.t() - Y) ** 2).mean().backward()
        return w.grad

    w = lin.weight.detach().clone()
    prev = torch.zeros_like(w)
    for _ in range(4):
        g = grad_at(w)
        state, _ = step(state, {"x": X, "y": Y})
        w = w - lr * prev
        prev = g
        assert torch.allclose(lin.weight.detach(), w, atol=1e-7)
    state = step.flush(state)
    assert torch.allclose(lin.weight.detach(), w - lr * prev, atol=1e-7)
    assert state.step == 4 and all(not p.any() for p in state.pending)


def test_overlap_refuses_what_jax_drops_and_jax_drops_it():
    api.init(device="cpu")
    lin = torch.nn.Linear(3, 2)
    for spec in ("onebit", "bf16", Compression.resolve("topk")):
        with pytest.raises(ValueError, match="drops"):
            make_delayed_grad_step(lambda *a: None, torch.optim.SGD(
                lin.parameters(), lr=0.1), compression=spec)
    with pytest.raises(ValueError, match="drops"):
        Trainer(lm_loss_fn(lin), torch.optim.SGD(lin.parameters(), lr=0.1),
                device="cpu", overlap=True, compression="onebit")
    for spec in (None, "none", Compression.none, Compression.bf16,
                 Compression.fp16):
        make_delayed_grad_step(lambda *a: None, torch.optim.SGD(
            lin.parameters(), lr=0.1), compression=spec)
    with pytest.raises(ValueError, match="backward_passes_per_step"):
        Trainer(lm_loss_fn(lin), torch.optim.SGD(lin.parameters(), lr=0.1),
                device="cpu", overlap=True, backward_passes_per_step=2)
    # the JAX step: "onebit" and "bf16" as strings leave the run as it is
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    X = jnp.asarray(np.random.RandomState(1).randn(8, 4), jnp.float32)
    Y = jnp.asarray(np.random.RandomState(2).randn(8, 2), jnp.float32)

    def jloss(p, ms, b):
        return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2), ms

    def run(spec):
        st_fn = jax_delayed(jloss, optax.sgd(0.1), mesh, compression=spec,
                            donate=False)
        st = st_fn.init_state({"w": jnp.full((4, 2), 0.3)})
        for _ in range(3):
            st, _ = st_fn(st, {"x": X, "y": Y})
        return np.asarray(st.params["w"])

    base = run(Compression.none)
    for spec in ("onebit", "bf16"):
        np.testing.assert_array_equal(run(spec), base)


@pytest.fixture(scope="module")
def jax_params():
    return jt.Transformer(jt.TransformerConfig(
        dtype=jnp.float32, **CFG)).init(
            jax.random.PRNGKey(6), jnp.zeros((1, 8), jnp.int32))["params"]


def _sd(tree):
    pcfg = pt.TransformerConfig(dtype=torch.float32, **CFG)
    return {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, tree), pcfg).items()}


@pytest.fixture(scope="module")
def port(jax_params, tmp_path_factory):
    return run_workers(2, extras_cases, CFG, _sd(jax_params), _batches(),
                       str(tmp_path_factory.mktemp("ck")), timeout=150)


@pytest.fixture(scope="module")
def jax_delayed_run(jax_params):
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    model = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **CFG))
    step = jax_delayed(jax_lm_loss_fn(model), optax.sgd(0.1, momentum=0.9),
                       mesh, donate=False)
    state = step.init_state(jax_params)
    losses = []
    for b in _batches():
        state, m = step(state, {"tokens": jnp.asarray(b)})
        losses.append(float(m["loss"]))
    before = _sd(state.params)
    state = step.flush(state)
    return losses, before, _sd(state.params)


def test_delayed_step_at_two_workers_matches_jax_two_devices(
        port, jax_delayed_run):
    jl, jbefore, jafter = jax_delayed_run
    for res in port:
        losses, before, after, steps = res["delayed"]
        assert steps == 3
        for got, want in zip(losses, jl):
            assert abs(got - want) <= TOL * abs(want), (losses, jl)
        for n in jafter:
            np.testing.assert_allclose(before[n], jbefore[n], rtol=0,
                                       atol=TOL, err_msg=n)
            np.testing.assert_allclose(after[n], jafter[n], rtol=0,
                                       atol=TOL, err_msg=n)
    assert port[0]["delayed"][0] == port[1]["delayed"][0]
    for n in jafter:
        np.testing.assert_array_equal(port[0]["delayed"][2][n],
                                      port[1]["delayed"][2][n])


def test_trainer_overlap_at_two_workers_matches_jax(port, jax_delayed_run):
    """``fit`` runs the delayed step and flushes at its end."""
    jl, _, jafter = jax_delayed_run
    for res in port:
        losses, after = res["trainer_overlap"]
        assert losses == port[0]["delayed"][0]
        for got, want in zip(losses, jl):
            assert abs(got - want) <= TOL * abs(want)
        for n in jafter:
            np.testing.assert_allclose(after[n], jafter[n], rtol=0,
                                       atol=TOL, err_msg=n)


def test_average_metrics_and_broadcast_callback_at_two_workers(port):
    for res in port:
        # float32 sums over the workers, divided by the world (JAX's)
        assert res["metrics"] == {"acc": float(np.float32(0.25)) / 2,
                                  "loss": float(np.float32(4.0)) / 2}
    w0, bn0, lr0, mom0 = port[0]["callback"]
    w1, bn1, lr1, mom1 = port[1]["callback"]
    assert bn0 == bn1 == [1.0, 1.0, 1.0] and lr0 == lr1 == 0.2
    for n in w1:
        np.testing.assert_array_equal(w0[n], w1[n])
        np.testing.assert_array_equal(mom0[n], mom1[n])


def test_checkpoint_at_two_workers_rank0_writes_and_both_resume(port):
    saved0, listing0, resumed0, step0, res0, got0 = port[0]["checkpoint"]
    saved1, listing1, resumed1, step1, res1, got1 = port[1]["checkpoint"]
    assert listing0 == ["step_0000000002", "step_0000000003"]
    assert listing1 == []                   # only rank 0 writes
    assert step0 == step1 == 3
    for n in saved0:
        np.testing.assert_array_equal(saved0[n], saved1[n])
        np.testing.assert_array_equal(resumed0[n], saved0[n])
        np.testing.assert_array_equal(resumed1[n], saved0[n])
    # the residuals are rank 0's on both (JAX saves process 0's state)
    assert any(not np.array_equal(a, b) for a, b in zip(res0, res1))
    for a, b, c in zip(res0, got0, got1):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


# ------------------------------------------------------- the serve role


def test_serve_role_serves_a_checkpoint(tmp_path, monkeypatch):
    from byteps_tpu_torch.common.config import reset_config
    from byteps_tpu_torch.inference import generate
    from byteps_tpu_torch.serving import RemoteServeClient
    from byteps_tpu_torch.serving.frontend import _model_from_env, \
        serve_from_env

    kw = "vocab_size=61,num_layers=2,num_heads=2,d_model=32,d_ff=64," \
         "max_seq_len=64"
    model = _model_from_env(kw, "cpu", seed=5)      # not the role's seed 0
    path = save_checkpoint(str(tmp_path / "serve"), model)
    prompt = np.arange(1, 9, dtype=np.int32) % 61
    want = generate(model, torch.from_numpy(prompt[None]), 6,
                    temperature=0)["tokens"][0].numpy()
    default = generate(_model_from_env(kw, "cpu"),
                       torch.from_numpy(prompt[None]), 6,
                       temperature=0)["tokens"][0].numpy()
    assert not np.array_equal(want, default)
    monkeypatch.setenv("BYTEPS_SERVE_MODEL", kw)
    monkeypatch.setenv("BYTEPS_SERVE_CHECKPOINT", path)
    srv, thread = serve_from_env(device="cpu", port=0, in_thread=True)
    try:
        c = RemoteServeClient(f"127.0.0.1:{srv.server_address[1]}",
                              timeout=60)
        got = c.generate(prompt, 6)
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        reset_config()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(backward_passes_per_step=2),
                                dict(compression="onebit"),
                                dict(overlap=True)],
                         ids=["distributed", "onebit", "overlap"])
def test_a_dropped_trainer_frees_its_parameters_and_state(kw):
    """The DistributedOptimizer's gradient hooks live on the parameters
    and once held the optimizer strongly: a cycle through autograd that
    the collector cannot see, so a dropped trainer kept its parameters,
    optimizer state and residuals alive (a second full-width trainer in
    the process ran out of memory)."""
    import gc
    import weakref

    def run():
        m = _model(3)
        opt = torch.optim.AdamW(m.parameters(), lr=1e-3)
        tr = Trainer(lm_loss_fn(m), opt, device="cpu", log_every=0, **kw)
        tr.fit(m, {}, [{"tokens": b} for b in _batches(2)])
        return weakref.ref(opt), weakref.ref(next(m.parameters()))

    opt, param = run()
    gc.collect()
    assert opt() is None and param() is None
