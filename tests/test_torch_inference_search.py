"""``beam_search`` and ``speculative_generate`` of the port
(``byteps_tpu_torch/inference.py``) held against the JAX package's on the
same converted weights and numpy prompts, following
``tests/test_beam_search.py`` and ``tests/test_speculative.py``.

* Beam search: tokens and beam tokens equal JAX's, scores within 1e-5,
  on a GPT-2-shaped model (learned positions, MHA) and a Llama-shaped one
  (rope with llama3 scaling, GQA); frozen-slot EOS; the length penalty's
  ranking; ``num_beams=1`` equals greedy ``generate``; ``cache_len``.
* Speculative generation: tokens equal JAX's and the target's own greedy
  ``generate`` with a disagreeing draft, the perfect draft, gamma 1 and
  8, EOS inside an accepted block, and ``truncated_draft``; the
  ``acceptance`` and ``rounds`` values equal JAX's.

fp32, small enough for the per-test time guard, torch on one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu import inference as ji
from byteps_tpu.models import transformer as jt
from byteps_tpu_torch import inference as pi
from byteps_tpu_torch.models import transformer as pt
from byteps_tpu_torch.models.convert import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCALING = (("factor", 32.0), ("high_freq_factor", 4.0),
           ("low_freq_factor", 1.0), ("original_max_position_embeddings", 16),
           ("rope_type", "llama3"))
GPT = dict(vocab_size=23, num_layers=2, num_heads=2, d_model=32, d_ff=64,
           max_seq_len=48)
LLAMA = dict(vocab_size=29, num_layers=2, num_heads=4, num_kv_heads=2,
             d_model=64, d_ff=128, max_seq_len=48, norm_eps=1e-5,
             pos_emb="rope", rope_theta=500000.0, rope_scaling=SCALING,
             mlp="swiglu", tie_embeddings=True)
SPEC = dict(vocab_size=31, num_layers=2, num_heads=2, d_model=32, d_ff=64,
            max_seq_len=96)


def _pair(kw, seed=1):
    jmodel = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **kw))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, 8), jnp.int32))
    cfg = pt.TransformerConfig(dtype=torch.float32, **kw)
    model = pt.Transformer(cfg)
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables), cfg))
    return jmodel, variables, model.eval()


@pytest.fixture(scope="module")
def models():
    return {"gpt": _pair(GPT), "llama": _pair(LLAMA)}


def _prompt(vocab, b=2, t=8, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, t)).astype(
        np.int32)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _beam_equal(got, want):
    np.testing.assert_array_equal(_np(got["tokens"]), _np(want["tokens"]))
    np.testing.assert_array_equal(_np(got["beam_tokens"]),
                                  _np(want["beam_tokens"]))
    for k in ("scores", "beam_scores"):
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), atol=1e-5,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["gpt", "llama"])
@pytest.mark.parametrize("n,k,penalty", [(4, 3, 1.0), (6, 4, 2.0)])
def test_beam_search_matches_jax(models, name, n, k, penalty):
    jmodel, variables, model = models[name]
    prompt = _prompt(model.cfg.vocab_size)
    want = ji.beam_search(jmodel, variables, jnp.asarray(prompt), n, k,
                          length_penalty=penalty)
    got = pi.beam_search(model, prompt, n, k, length_penalty=penalty)
    _beam_equal(got, want)
    assert got["beam_tokens"].shape == (2, k, n)


def test_beam_eos_freezes_as_jax(models):
    """The second token of the best beam made the EOS: a beam that emits
    it pads at no cost afterwards, as in JAX."""
    jmodel, variables, model = models["gpt"]
    prompt = _prompt(23)
    first = pi.beam_search(model, prompt, 5, 2)
    eos = int(first["tokens"][0, 1])
    want = ji.beam_search(jmodel, variables, jnp.asarray(prompt), 5, 2,
                          eos_id=eos, pad_id=0)
    got = pi.beam_search(model, prompt, 5, 2, eos_id=eos, pad_id=0)
    _beam_equal(got, want)
    frozen = 0
    for row in _np(got["beam_tokens"]).reshape(-1, 5):
        if eos in row.tolist():
            i = row.tolist().index(eos)
            assert (row[i + 1:] == 0).all()
            frozen += 1
    assert frozen >= 1


def test_beam1_is_greedy_and_cache_len(models):
    """One beam is greedy decoding (the port's and JAX's ``generate``); a
    larger ``cache_len`` changes nothing, a short one raises."""
    jmodel, variables, model = models["llama"]
    prompt = _prompt(29)
    greedy = pi.generate(model, prompt, 6, temperature=0.0)["tokens"]
    np.testing.assert_array_equal(
        _np(greedy), np.asarray(ji.generate(jmodel, variables,
                                            jnp.asarray(prompt), 6,
                                            temperature=0)["tokens"]))
    beam = pi.beam_search(model, prompt, 6, 1)
    np.testing.assert_array_equal(_np(beam["tokens"]), _np(greedy))
    _beam_equal(pi.beam_search(model, prompt, 4, 3, cache_len=40),
                pi.beam_search(model, prompt, 4, 3))
    with pytest.raises(ValueError, match="cache_len"):
        pi.beam_search(model, prompt, 4, 3, cache_len=11)


@pytest.fixture(scope="module")
def spec_models():
    return {"target": _pair(SPEC, 1), "draft": _pair(dict(SPEC, num_layers=1),
                                                     99),
            "target4": _pair(dict(SPEC, num_layers=4), 1)}


def _spec_equal(got, want):
    np.testing.assert_array_equal(_np(got["tokens"]), _np(want["tokens"]))
    assert int(got["rounds"]) == int(want["rounds"])
    np.testing.assert_allclose(float(got["acceptance"]),
                               float(want["acceptance"]), rtol=1e-6)
    np.testing.assert_allclose(float(got["tokens_per_target_forward"]),
                               float(want["tokens_per_target_forward"]),
                               rtol=1e-6)


def _greedy(pair, prompt, n, **kw):
    return _np(pi.generate(pair[2], prompt, n, temperature=0.0,
                           **kw)["tokens"])


@pytest.mark.parametrize("draft,gamma", [("draft", 3), ("draft", 1),
                                         ("draft", 8), ("target", 4)])
def test_speculative_generate_matches_jax_and_greedy(spec_models, draft,
                                                     gamma):
    """A disagreeing draft at gamma 3, 1 and 8, and the perfect draft
    (the target itself): the tokens equal JAX's and the target-only
    greedy decode, with JAX's acceptance and rounds."""
    tj, tv, tm = spec_models["target"]
    dj, dv, dm = spec_models[draft]
    prompt = _prompt(31, b=3)
    want = ji.speculative_generate(tj, tv, dj, dv, jnp.asarray(prompt), 12,
                                   gamma=gamma)
    got = pi.speculative_generate(tm, dm, prompt, 12, gamma=gamma)
    _spec_equal(got, want)
    np.testing.assert_array_equal(_np(got["tokens"]),
                                  _greedy(spec_models["target"], prompt, 12))
    if draft == "target":
        assert got["acceptance"] > 0.5 and got["rounds"] <= 6


def test_speculative_eos_matches_generate(spec_models):
    """EOS inside an accepted block freezes the row to pad after it, as
    ``generate(eos_id=...)`` does, and as JAX's."""
    tj, tv, tm = spec_models["target"]
    prompt = _prompt(31, b=3)
    eos = int(_greedy(spec_models["target"], prompt, 10)[0, 2])
    want = _greedy(spec_models["target"], prompt, 10, eos_id=eos, pad_id=0)
    got = pi.speculative_generate(tm, tm, prompt, 10, gamma=4, eos_id=eos,
                                  pad_id=0)
    np.testing.assert_array_equal(_np(got["tokens"]), want)
    _spec_equal(got, ji.speculative_generate(
        tj, tv, tj, tv, jnp.asarray(prompt), 10, gamma=4, eos_id=eos,
        pad_id=0))


def test_truncated_draft_speculation_matches_jax(spec_models):
    """The target's own first 2 of 4 layers as the draft (the port's
    ``truncated_draft`` shares the target's modules): tokens equal JAX's
    truncated-draft run and the target's greedy decode; ``cache_len``
    below prompt + N + gamma + 1 raises."""
    tj, tv, tm = spec_models["target4"]
    dj, dv = ji.truncated_draft(tj.cfg, tv, 2)
    draft = pi.truncated_draft(tm, 2)
    assert draft.blocks[1] is tm.blocks[1]
    prompt = _prompt(31, b=3)
    want = ji.speculative_generate(tj, tv, dj, dv, jnp.asarray(prompt), 12,
                                   gamma=3)
    got = pi.speculative_generate(tm, draft, prompt, 12, gamma=3)
    _spec_equal(got, want)
    np.testing.assert_array_equal(_np(got["tokens"]),
                                  _greedy(spec_models["target4"], prompt, 12))
    with pytest.raises(ValueError, match="cache_len"):
        pi.speculative_generate(tm, draft, prompt, 12, gamma=3, cache_len=20)
