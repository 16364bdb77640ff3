"""The port's LM training step (byteps_tpu_torch.training) held against the
JAX package's (byteps_tpu.training.step) on the same weights and data.

Weights are made by the JAX model's init from a seed and carried across
with ``from_jax_params`` (fp32, flax's parameter dtype); the JAX
gradient tree converts the same way, so gradients compare leaf by leaf.
Tokens come from numpy with a fixed seed.  Two tiny fp32 configs
(2 layers, head_dim 16, T = 32):

* LLaMA-shaped — rope, swiglu, rmsnorm, GQA 4/2, tied embeddings;
* GPT-2-shaped — layernorm, learned positions, gelu, biases, untied.

Both sides run ``attn_impl="flash"``: the JAX Pallas kernels in
interpret mode, the port's flash autograd Function with its plain
versions.  The fused LM head (``fused_head=True``) likewise: the JAX
fused cross-entropy kernels in interpret mode, jitted, with
``block_n=B*T, block_v=vocab`` so their grid is one block, against the
port's fused Function with its plain versions; also with -100 labels
and with the ``early_exit`` term under both heads.  Tolerances: 1e-5 on losses, gradients and weights after
three SGD-momentum steps (fp32 sums in other orders move them by
~1e-7); 1e-6 on one AdamW step from identical given gradients (no
model in the loop — Adam divides by sqrt(v), which turns rounding of a
near-zero gradient into an update of up to lr, so the optimizer is
compared apart from the gradients).
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
from byteps_tpu.training.step import \
    make_data_parallel_step as jax_make_step
from byteps_tpu_torch import api
from byteps_tpu_torch.common.config import reset_config
from byteps_tpu_torch.inference import truncated_draft
from byteps_tpu_torch.models import transformer as pt
from byteps_tpu_torch.models.convert import from_jax_params
from byteps_tpu_torch.ops import fused_cross_entropy as fce
from byteps_tpu_torch.training import (Trainer, lm_loss_fn,
                                       make_data_parallel_step)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU tests run tiny torch ops beside other test workers: one
    intra-op thread each keeps them from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5
V, T = 97, 32
CONFIGS = {
    "llama": dict(vocab_size=V, num_layers=2, num_heads=4, num_kv_heads=2,
                  d_model=64, d_ff=128, max_seq_len=64, norm_eps=1e-5,
                  pos_emb="rope", rope_theta=500000.0, mlp="swiglu",
                  tie_embeddings=True),
    "gpt2": dict(vocab_size=V, num_layers=2, num_heads=4, d_model=64,
                 d_ff=128, max_seq_len=64, norm="layernorm", norm_eps=1e-5,
                 use_bias=True, mlp="gelu", pos_emb="learned"),
}


@pytest.fixture(autouse=True)
def _fresh_api():
    yield
    api.shutdown()


def _tokens(seed, B=2):
    return np.random.RandomState(seed).randint(0, V, size=(B, T)).astype(
        np.int32)


class Pair:
    """One config on both sides: the JAX model and params, and a factory
    of port models loaded with the same weights."""

    def __init__(self, name):
        kw = CONFIGS[name]
        # init through the local impl (same tree, no interpret kernels)
        params = jt.Transformer(jt.TransformerConfig(
            dtype=jnp.float32, **kw)).init(
                jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
        self.params = params["params"]
        self.jmodel = jt.Transformer(jt.TransformerConfig(
            dtype=jnp.float32, attn_impl="flash", **kw))
        self.pcfg = pt.TransformerConfig(dtype=torch.float32,
                                         attn_impl="flash", **kw)
        self.sd = from_jax_params(jax.tree_util.tree_map(
            np.asarray, self.params), self.pcfg)
        self._vgs = {}

    def port_model(self):
        m = pt.Transformer(self.pcfg)
        m.load_state_dict(self.sd, strict=True)
        return m

    def jax_value_and_grad(self, batch, **loss_kw):
        """JAX loss and gradients of ``lm_loss_fn(model, **loss_kw)``; the
        batch is an argument: one compile per options and batch
        structure.  The fused head gets one block over all B*T rows and
        the whole vocabulary."""
        key = tuple(sorted(loss_kw.items()))
        if key not in self._vgs:
            if loss_kw.get("fused_head"):
                loss_kw = {**loss_kw, "block_n": 2 * T, "block_v": V}
            lf = jax_lm_loss_fn(self.jmodel, **loss_kw)
            self._vgs[key] = jax.jit(jax.value_and_grad(
                lambda p, b: lf(p, {}, b)[0]))
        return self._vgs[key](self.params,
                              {k: jnp.asarray(v) for k, v in batch.items()})


_PAIRS = {}


def _pair(name) -> "Pair":
    if name not in _PAIRS:
        _PAIRS[name] = Pair(name)
    return _PAIRS[name]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def llama():
    return _pair("llama")


@pytest.fixture(scope="module")
def jax_tied_grads(llama):
    return llama.jax_value_and_grad(_tied_batch())


def _labels_batch():
    toks = _tokens(1)
    labels = toks.copy()
    labels[0, 20:] = -100
    labels[1, :5] = -100
    return {"tokens": toks, "labels": labels}


def _tied_batch():
    # tokens from the lower half of the vocab only
    return {"tokens": np.random.RandomState(8).randint(
        0, V // 2, size=(2, T)).astype(np.int32)}


@pytest.fixture(scope="module")
def jax_grads(pair):
    """JAX loss and gradients (set-up: the jit compile is the slow
    part) for a plain batch and for one with ignored labels."""
    return {"plain": pair.jax_value_and_grad({"tokens": _tokens(0)}),
            "labels": pair.jax_value_and_grad(_labels_batch())}


def _sgd_batches():
    return [{"tokens": _tokens(s)} for s in (2, 3, 4)]


@pytest.fixture(scope="module")
def jax_sgd(pair):
    """Three SGD-momentum steps of the JAX step on a 1-device mesh (run
    here, at set-up: the jitted step's compile is the slow part)."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    jstep = jax_make_step(jax_lm_loss_fn(pair.jmodel),
                          optax.sgd(0.1, momentum=0.9), mesh)
    jstate = jstep.init_state(pair.params)
    losses = []
    for b in _sgd_batches():
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, jax.tree_util.tree_map(np.asarray, jstate.params)


def _port_loss_and_grads(model, batch, **loss_kw):
    loss, _ = lm_loss_fn(model, **loss_kw)(
        model, {}, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()}


def _assert_grads_match(pair, grads, jgrads):
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads),
                           pair.pcfg)
    assert set(want) == set(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=TOL,
                                   rtol=0, err_msg=n)


def test_lm_loss_and_grads_match_jax(pair, jax_grads):
    jloss, jgrads = jax_grads["plain"]
    model = pair.port_model()
    loss, grads = _port_loss_and_grads(model, {"tokens": _tokens(0)})
    assert abs(loss.item() - float(jloss)) <= TOL
    _assert_grads_match(pair, grads, jgrads)


def test_ignored_labels_match_jax_and_leave_the_mean_over_valid(pair,
                                                               jax_grads):
    """HF ``labels`` with -100 on ignored positions: the loss is the
    mean over valid targets only, on both sides."""
    batch = _labels_batch()
    toks, labels = batch["tokens"], batch["labels"]
    jloss, jgrads = jax_grads["labels"]
    model = pair.port_model()
    loss, grads = _port_loss_and_grads(model, batch)
    assert abs(loss.item() - float(jloss)) <= TOL
    _assert_grads_match(pair, grads, jgrads)
    # the same loss by hand: per-token CE over the valid targets
    with torch.no_grad():
        logits = model(torch.from_numpy(toks))[:, :-1]
    t = torch.from_numpy(np.roll(labels, -1, axis=1))[:, :-1].long()
    keep = t >= 0
    ce = torch.nn.functional.cross_entropy(logits[keep], t[keep])
    assert abs(loss.item() - ce.item()) <= TOL


def test_three_sgd_momentum_steps_match_jax(pair, jax_sgd):
    jlosses, jparams = jax_sgd
    api.init(device="cpu")
    model = pair.port_model()
    step = make_data_parallel_step(
        lm_loss_fn(model), torch.optim.SGD(model.parameters(), lr=0.1,
                                           momentum=0.9))
    state = step.init_state(model)
    for b, jl in zip(_sgd_batches(), jlosses):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert abs(m["loss"].item() - jl) <= TOL
    assert state.step == 3
    want = from_jax_params(jparams, pair.pcfg)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=TOL, rtol=0, err_msg=n)


def test_one_adamw_step_matches_optax_adamw():
    """torch.optim.AdamW with optax.adamw's values (weight decay 1e-4,
    not torch's 1e-2 default) on identical parameters and gradients."""
    rng = np.random.RandomState(7)
    shapes = {"w": (16, 8), "b": (8,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = optax.adamw(1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
    upd, _ = tx.update(grads, tx.init(params), params)
    want = optax.apply_updates(params, upd)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = torch.optim.AdamW(tp.values(), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    for k, p in tp.items():
        p.grad = torch.from_numpy(grads[k])
    opt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=0, err_msg=k)


def test_tied_embedding_receives_the_head_gradient(llama, jax_tied_grads):
    """Tokens drawn from the lower half of the vocab: the upper rows of
    the tied table are never looked up, so their gradient can only come
    through the head — and it must, with the JAX value."""
    batch = _tied_batch()
    toks = batch["tokens"]
    model = llama.port_model()
    _, grads = _port_loss_and_grads(model, batch)
    g = grads["embed.weight"][V // 2:]
    assert g.abs().max().item() > 1e-4
    _, jgrads = jax_tied_grads
    want = np.asarray(jgrads["embed"]["embedding"])[V // 2:]
    np.testing.assert_allclose(g.numpy(), want, atol=TOL, rtol=0)
    # the serving head (no autograd: a kept copy) equals the training head
    h = model.hidden(torch.from_numpy(toks).long()).detach()
    trained = model.logits(h)
    assert trained.requires_grad
    with torch.no_grad():
        served = model.logits(h)
    assert torch.equal(trained.detach(), served)


def test_flash_and_local_attention_train_alike(llama):
    p = llama
    losses = {}
    for impl in ("flash", "local"):
        cfg = pt.TransformerConfig(**{**CONFIGS["llama"], "attn_impl": impl},
                                   dtype=torch.float32)
        model = pt.Transformer(cfg)
        model.load_state_dict(p.sd)
        trainer = Trainer(lm_loss_fn(model), torch.optim.SGD(
            model.parameters(), lr=0.1, momentum=0.9), device="cpu",
            log_every=0)
        losses[impl] = []
        for _ in range(2):  # one batch twice: the loss must fall
            trainer.fit(model, {}, [{"tokens": _tokens(2)}])
            losses[impl].append(trainer.metrics["loss"].item())
        assert trainer.state.step == 2
        api.shutdown()
    np.testing.assert_allclose(losses["flash"], losses["local"], atol=TOL,
                               rtol=0)
    assert losses["flash"][1] < losses["flash"][0]


@pytest.mark.parametrize("causal", [False, True])
def test_key_mask_rides_the_flash_segment_ids(causal):
    """A padding mask on the training branch: with ``attn_impl="flash"``
    it becomes the kernels' segment ids (pads see only pads), and the
    valid rows equal the plain masked softmax of ``"local"`` — the JAX
    Attention's no-cache branch (models/transformer.py:734-752)."""
    x = torch.from_numpy(np.random.RandomState(3).randn(2, T, 64).astype(
        np.float32))
    mask = torch.ones(2, T, dtype=torch.int32)
    mask[0, 20:] = 0
    mask[1, 28:] = 0
    outs = {}
    for impl in ("flash", "local"):
        torch.manual_seed(0)  # the same random weights for both blocks
        blk = pt.Block(pt.TransformerConfig(
            **CONFIGS["gpt2"], causal=causal, attn_impl=impl,
            dtype=torch.float32))
        outs[impl] = blk(x, mask).detach()
    keep = mask.bool()
    np.testing.assert_allclose(outs["flash"][keep].numpy(),
                               outs["local"][keep].numpy(), atol=TOL, rtol=0)


def test_trainer_fit_runs_on_cpu_and_refuses_what_is_not_ported(monkeypatch):
    cfg = pt.TransformerConfig(**CONFIGS["gpt2"], dtype=torch.float32,
                               attn_impl="flash")
    model = pt.Transformer(cfg)
    pt.init_weights(model, 0)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    trainer = Trainer(lm_loss_fn(model), opt, device="cpu", log_every=1)
    state = trainer.fit(model, {}, [{"tokens": _tokens(s)} for s in range(5)],
                        steps=2)
    assert state.step == 2 and np.isfinite(trainer.metrics["loss"].item())
    assert all(p.device.type == "cpu" for p in model.parameters())
    # async mode is ported (test_torch_async_ps.py): it takes the process
    # store; checkpoints, callbacks, overlap and the biased compressors
    # are too (test_torch_training_extras.py, test_torch_error_feedback.py)
    from byteps_tpu_torch.engine.async_ps import (AsyncParameterServer,
                                                  reset_async_store,
                                                  set_async_store)

    set_async_store(AsyncParameterServer(use_native=False))
    try:
        at = Trainer(lm_loss_fn(model), opt, device="cpu", async_mode=True)
        assert at.async_mode and at.async_interval == 1
        # refused by name: a synchronous schedule under async mode
        with pytest.raises(ValueError, match="async_mode"):
            Trainer(lm_loss_fn(model), opt, device="cpu", async_mode=True,
                    overlap=True)
    finally:
        reset_async_store()
    for kw in ({"overlap": True}, {"callbacks": [print]},
               {"compression": "onebit"}):
        Trainer(lm_loss_fn(model), torch.optim.SGD(model.parameters(),
                                                   lr=0.1),
                device="cpu", **kw)
    # backward_passes_per_step accumulates (training/optimizer.py): the
    # first of two steps leaves the weights as they are
    acc = Trainer(lm_loss_fn(model), torch.optim.SGD(model.parameters(),
                                                     lr=0.1),
                  device="cpu", backward_passes_per_step=2)
    before = [p.detach().clone() for p in model.parameters()]
    acc.fit(model, {}, [{"tokens": _tokens(7)}], steps=1)
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    acc.fit(model, {}, [{"tokens": _tokens(8)}], steps=1)
    assert not all(torch.equal(a, p)
                   for a, p in zip(before, model.parameters()))
    # the workers are api.init's processes: one here
    with pytest.raises(ValueError, match="world size"):
        make_data_parallel_step(lm_loss_fn(model), opt, world_size=2)
    # the fused head and the early-exit term, refused before their slice,
    # give the plain head's loss and the sum of the two exits
    batch = {"tokens": torch.from_numpy(_tokens(6))}
    with torch.no_grad():
        plain = lm_loss_fn(model)(model, {}, batch)[0]
        fused = lm_loss_fn(model, fused_head=True)(model, {}, batch)[0]
        both = lm_loss_fn(model, early_exit=(1, 0.5))(model, {}, batch)[0]
        exit1 = lm_loss_fn(model)(truncated_draft(model, 1), {}, batch)[0]
    assert abs(fused.item() - plain.item()) <= TOL
    assert abs(both.item() - (plain + 0.5 * exit1).item()) <= TOL
    with pytest.raises(NotImplementedError, match="sequence-parallel"):
        pt.Transformer(pt.TransformerConfig(**CONFIGS["gpt2"],
                                            attn_impl="ring"))
    api.shutdown()
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    reset_config()
    # a second worker is ported, but needs its rendezvous address
    with pytest.raises(ValueError, match="DMLC_NUM_WORKER"):
        api.init(device="cpu")
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    monkeypatch.setenv("BYTEPS_ENABLE_ASYNC", "1")
    monkeypatch.setenv("BYTEPS_HIERARCHICAL", "1")
    reset_config()
    # async mode is ported; hierarchical push/pull under it is refused
    with pytest.raises(NotImplementedError, match="hierarchical"):
        Trainer(lm_loss_fn(model), opt, device="cpu")
    monkeypatch.delenv("BYTEPS_HIERARCHICAL")
    monkeypatch.delenv("BYTEPS_ENABLE_ASYNC")
    reset_config()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.init()


@pytest.fixture(scope="module")
def jax_fused(pair):
    """JAX losses and gradients with the fused head (set-up: the jitted
    compiles are the slow part): a plain batch, -100 labels, and the
    early-exit term under both heads."""
    return {"plain": pair.jax_value_and_grad({"tokens": _tokens(0)},
                                             fused_head=True),
            "labels": pair.jax_value_and_grad(_labels_batch(),
                                              fused_head=True),
            "exit_fused": pair.jax_value_and_grad(
                {"tokens": _tokens(0)}, fused_head=True, early_exit=(1, 0.5)),
            "exit_plain": pair.jax_value_and_grad(
                {"tokens": _tokens(0)}, early_exit=(1, 0.5))}


@pytest.mark.parametrize("kind", ["plain", "labels"])
def test_fused_head_loss_and_grads_match_jax(pair, jax_fused, kind):
    """``fused_head=True``, tied (LLaMA) and untied (GPT-2) heads, with
    and without -100 labels: loss and every gradient within 1e-5."""
    batch = {"tokens": _tokens(0)} if kind == "plain" else _labels_batch()
    jloss, jgrads = jax_fused[kind]
    model = pair.port_model()
    calls = fce.plain_calls
    loss, grads = _port_loss_and_grads(model, batch, fused_head=True)
    assert fce.plain_calls == calls + 2  # the forward and the backward
    assert abs(loss.item() - float(jloss)) <= TOL
    _assert_grads_match(pair, grads, jgrads)


@pytest.mark.parametrize("fused_head", [False, True])
def test_early_exit_matches_jax(pair, jax_fused, fused_head):
    """The LayerSkip term ``0.5 * CE(first layer)`` under both heads."""
    jloss, jgrads = jax_fused["exit_fused" if fused_head else "exit_plain"]
    model = pair.port_model()
    loss, grads = _port_loss_and_grads(model, {"tokens": _tokens(0)},
                                       fused_head=fused_head,
                                       early_exit=(1, 0.5))
    assert abs(loss.item() - float(jloss)) <= TOL
    _assert_grads_match(pair, grads, jgrads)


def test_truncated_draft_shares_the_target_parameters(pair):
    model = pair.port_model()
    draft = truncated_draft(model, 1)
    assert draft.cfg.num_layers == 1 and len(draft.blocks) == 1
    own = {id(p) for p in model.parameters()}
    shared = list(draft.parameters())
    assert shared and all(id(p) in own for p in shared)
    assert draft.embed.weight is model.embed.weight
    assert draft.blocks[0] is model.blocks[0] and draft.ln_f is model.ln_f
    # the draft's loss trains the target's weights
    lm_loss_fn(draft)(draft, {}, {"tokens": torch.from_numpy(
        _tokens(1))})[0].backward()
    assert model.blocks[0].attn.q.weight.grad is not None
    assert model.blocks[1].attn.q.weight.grad is None
    for bad in (0, model.cfg.num_layers + 1):
        with pytest.raises(ValueError, match="num_layers"):
            truncated_draft(model, bad)


def test_trainer_evaluate_is_the_mean_of_the_batch_losses(llama):
    """``Trainer.evaluate`` with the fused-head loss: the mean of the
    per-batch losses, no gradient, the forward only, the model back in
    train mode."""
    model = llama.port_model()
    trainer = Trainer(lm_loss_fn(model, fused_head=True), torch.optim.SGD(
        model.parameters(), lr=0.1), device="cpu", log_every=0)
    with pytest.raises(ValueError, match="fit"):
        trainer.evaluate(lambda st, b: {}, [])
    trainer.fit(model, {}, [{"tokens": _tokens(2)}])
    lf = lm_loss_fn(model, fused_head=True)
    batches = [{"tokens": _tokens(s)} for s in (3, 4, 5, 6, 7, 8)]
    calls = fce.plain_calls
    out = trainer.evaluate(
        lambda st, b: {"loss": lf(st.model, {}, b)[0],
                       "one": torch.tensor(1.0)}, batches)
    assert fce.plain_calls == calls + len(batches)  # forward only
    with torch.no_grad():
        want = np.mean([lf(model, {}, {"tokens": torch.from_numpy(
            b["tokens"])})[0].item() for b in batches])
    assert abs(out["loss"] - want) <= TOL and out["one"] == 1.0
    assert model.training
    assert all(p.grad is None or not p.grad.requires_grad
               for p in model.parameters())
