"""The port's BERT encoder and heads (byteps_tpu_torch/models/bert.py) held
against the JAX package's (byteps_tpu/models/bert.py) on the same weights
and inputs.

Weights are made by the JAX modules' own init from a seed and carried
across with ``from_jax_bert_params``; the JAX gradient trees convert the
same way, so gradients compare leaf by leaf.  Tokens and the ``[B, T]``
padding masks come from numpy with a fixed seed: an unpadded row, a row
with one valid token, and two padded rows.  A tiny fp32 config (2
layers, d_model 64, 4 heads of 16, T = 32) under both attention
implementations: ``"local"`` (the plain masked softmax on both sides) and
``"flash"`` (the JAX Pallas kernels in interpret mode, the port's flash
Function with its plain versions; the mask rides the segment ids,
non-causal).

Tolerances: 2e-5 on fp32 outputs and 1e-4 on the loss and every
gradient — the two frameworks sum the same products in other orders,
which moves fp32 values of this size by ~1e-6; a wrong layout or mask
moves them by O(1e-2) or more.  One AdamW step (lr 2e-5, optax's weight
decay 1e-4 passed to torch): parameters within 1e-4, since Adam's first
step moves a weight by at most lr whatever the gradient's rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh

from byteps_tpu.models import bert as jb
from byteps_tpu.training.step import \
    make_data_parallel_step as jax_make_step
from byteps_tpu_torch import api
from byteps_tpu_torch.models import bert as pb
from byteps_tpu_torch.models.convert import from_jax_bert_params
from byteps_tpu_torch.ops import flash_attention as fa
from byteps_tpu_torch.training import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU tests run tiny torch ops beside other test workers: one
    intra-op thread each keeps them from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_api():
    yield
    api.shutdown()


OUT_TOL = 2e-5
GRAD_TOL = 1e-4
V, T, B, CLASSES = 61, 32, 4, 3
LENGTHS = (T, 1, 20, 7)   # unpadded, one valid token, two padded rows
KW = dict(vocab_size=V, num_layers=2, num_heads=4, d_model=64, d_ff=128,
          max_seq_len=64)
HEADS = ("encoder", "classifier", "mlm")
IMPLS = ("local", "flash")


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, V, size=(B, T)).astype(np.int32)
    mask = (np.arange(T)[None, :] < np.array(LENGTHS)[:, None]).astype(
        np.int32)
    labels = rng.randint(0, CLASSES, size=(B,)).astype(np.int32)
    return tokens, mask, labels


def _jax_module(head, impl):
    cfg = jb.bert_config(dtype=jnp.float32, attn_impl=impl, **KW)
    return {"encoder": lambda: jb.BertEncoder(cfg),
            "classifier": lambda: jb.BertClassifier(cfg, CLASSES),
            "mlm": lambda: jb.BertMLM(cfg)}[head]()


def _port_module(head, impl, sd=None):
    cfg = pb.bert_config(dtype=torch.float32, attn_impl=impl, **KW)
    m = {"encoder": lambda: pb.BertEncoder(cfg, device="cpu"),
         "classifier": lambda: pb.BertClassifier(cfg, CLASSES, device="cpu"),
         "mlm": lambda: pb.BertMLM(cfg, device="cpu")}[head]()
    if sd is not None:
        m.load_state_dict(sd, strict=True)
    return m


_PARAMS = {}


def _params(head):
    """The JAX init's parameters of a head (through the local impl: the
    same tree, no interpret kernels), and the port's state dict."""
    if head not in _PARAMS:
        tokens, mask, _ = _inputs()
        params = _jax_module(head, "local").init(
            jax.random.PRNGKey(1), jnp.asarray(tokens),
            jnp.asarray(mask))["params"]
        cfg = pb.bert_config(dtype=torch.float32, **KW)
        _PARAMS[head] = (params, from_jax_bert_params(
            jax.tree_util.tree_map(np.asarray, params), cfg))
    return _PARAMS[head]


def _jax_loss(head, model, params, tokens, mask, labels):
    out = model.apply({"params": params}, tokens, mask)
    if head == "classifier":
        return optax.softmax_cross_entropy_with_integer_labels(
            out, labels).mean()
    if head == "mlm":   # predict each valid position's own token
        ce = optax.softmax_cross_entropy_with_integer_labels(out, tokens)
        return (ce * mask).sum() / mask.sum()
    return (out * out).sum() / mask.sum()


def _port_loss(head, out, tokens, mask, labels):
    if head == "classifier":
        return F.cross_entropy(out, labels.long())
    if head == "mlm":
        ce = F.cross_entropy(out.reshape(-1, V), tokens.reshape(-1).long(),
                             reduction="none").view(B, T)
        return (ce * mask).sum() / mask.sum()
    return (out * out).sum() / mask.sum()


_JAX = {}


def _jax_run(head, impl):
    """JAX outputs, loss and gradients of one head and impl (jitted once)."""
    key = (head, impl)
    if key not in _JAX:
        params, _ = _params(head)
        model = _jax_module(head, impl)
        tokens, mask, labels = (jnp.asarray(a) for a in _inputs())
        out = model.apply({"params": params}, tokens, mask)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: _jax_loss(head, model, p, tokens, mask, labels)))(
                params)
        _JAX[key] = (np.asarray(out), float(loss),
                     jax.tree_util.tree_map(np.asarray, grads))
    return _JAX[key]


@pytest.fixture
def jax_ref(head, impl):
    """The JAX side of a case, made in the test's set-up: its first jit
    in a worker takes seconds, the port's side a fraction of one."""
    return _jax_run(head, impl)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("head", HEADS)
def test_outputs_match_jax(head, impl, jax_ref):
    want, _, _ = jax_ref
    _, sd = _params(head)
    model = _port_module(head, impl, sd)
    tokens, mask, _ = _inputs()
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long(),
                    torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=0)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("head", HEADS)
def test_loss_and_every_gradient_match_jax(head, impl, jax_ref):
    _, jloss, jgrads = jax_ref
    _, sd = _params(head)
    model = _port_module(head, impl, sd)
    tokens, mask, labels = (torch.from_numpy(a) for a in _inputs())
    fa.plain_calls = 0
    loss = _port_loss(head, model(tokens.long(), mask), tokens, mask, labels)
    loss.backward()
    assert abs(loss.item() - jloss) <= GRAD_TOL
    # flash: 2 forwards, then dq and dk/dv of each layer, on the CPU
    assert fa.plain_calls == (6 if impl == "flash" else 0)
    cfg = pb.bert_config(dtype=torch.float32, **KW)
    want = from_jax_bert_params(jgrads, cfg)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(want) == set(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=GRAD_TOL,
                                   rtol=0, err_msg=n)


def test_converter_consumes_every_leaf_and_refuses_leftovers():
    for head in HEADS:
        params, sd = _params(head)
        assert set(sd) == set(_port_module(head, "local").state_dict())
    params, _ = _params("classifier")
    extra = {**jax.tree_util.tree_map(np.asarray, params),
             "extra": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(ValueError, match="extra"):
        from_jax_bert_params(extra, pb.bert_config(dtype=torch.float32, **KW))


@pytest.fixture(scope="module")
def jax_adamw_step():
    """One AdamW step of the JAX data-parallel step on a 1-device mesh,
    the classifier with the flash impl."""
    params, _ = _params("classifier")
    model = _jax_module("classifier", "flash")

    def loss_fn(p, model_state, batch):
        return _jax_loss("classifier", model, p, batch["tokens"],
                         batch["attention_mask"], batch["label"]), model_state

    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    step = jax_make_step(loss_fn, optax.adamw(2e-5, weight_decay=1e-4),
                         mesh)
    state = step.init_state(params)
    tokens, mask, labels = _inputs()
    state, m = step(state, {"tokens": jnp.asarray(tokens),
                            "attention_mask": jnp.asarray(mask),
                            "label": jnp.asarray(labels)})
    return float(m["loss"]), jax.tree_util.tree_map(np.asarray, state.params)


def test_one_trainer_step_matches_the_jax_step(jax_adamw_step):
    jloss, jparams = jax_adamw_step
    _, sd = _params("classifier")
    model = _port_module("classifier", "flash", sd)

    def loss_fn(m, model_state, batch):
        logits = m(batch["tokens"].long(), batch["attention_mask"])
        return F.cross_entropy(logits, batch["label"].long()), model_state

    trainer = Trainer(loss_fn, torch.optim.AdamW(
        model.parameters(), lr=2e-5, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4), device="cpu", log_every=0)
    tokens, mask, labels = _inputs()
    state = trainer.fit(model, {}, [{"tokens": tokens,
                                     "attention_mask": mask,
                                     "label": labels}])
    assert state.step == 1
    assert abs(trainer.metrics["loss"].item() - jloss) <= GRAD_TOL
    want = from_jax_bert_params(jparams, pb.bert_config(dtype=torch.float32,
                                                        **KW))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=GRAD_TOL, rtol=0, err_msg=n)


@pytest.mark.parametrize("impl", IMPLS)
def test_bert_is_bidirectional(impl):
    """Changing a LATE token changes an EARLY position's hidden state
    (JAX tests/test_bert.py:27)."""
    _, sd = _params("mlm")
    model = _port_module("mlm", impl, sd)
    t1 = torch.arange(T)[None, :] % V
    t2 = t1.clone()
    t2[0, T - 1] = 7
    with torch.no_grad():
        a, b = model(t1), model(t2)
    assert not torch.allclose(a[0, 0], b[0, 0])


@pytest.mark.parametrize("impl", IMPLS)
def test_padding_positions_are_zeroed(impl):
    _, sd = _params("encoder")
    model = _port_module("encoder", impl, sd)
    tokens, mask, _ = _inputs()
    with torch.no_grad():
        h = model(torch.from_numpy(tokens).long(), torch.from_numpy(mask))
    keep = torch.from_numpy(mask).bool()
    assert torch.count_nonzero(h[~keep]) == 0
    assert (h[keep].abs().sum(-1) > 0).all()


def test_causal_config_is_refused_and_bert_config_defaults():
    cfg = dataclasses.replace(pb.bert_config(dtype=torch.float32, **KW),
                              causal=True)
    with pytest.raises(ValueError, match="causal=False"):
        pb.BertEncoder(cfg, device="cpu")
    base = pb.bert_config()
    jbase = jb.bert_config()
    for f in ("vocab_size", "num_layers", "num_heads", "d_model", "d_ff",
              "max_seq_len", "causal", "attn_impl", "norm", "norm_eps",
              "pos_emb", "mlp", "use_bias"):
        assert getattr(base, f) == getattr(jbase, f), f
    assert base.dtype == torch.bfloat16 and base.attn_impl == "local"


def test_bert_modules_run_on_the_gpu_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the CPU-only host")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pb.BertClassifier(pb.bert_config(dtype=torch.float32, **KW))
