"""The port's HF integrations (byteps_tpu_torch/integrations) held against
HF's own torch models and the JAX package's integrations.

Ground truth is ``transformers``' torch ``GPT2LMHeadModel`` /
``LlamaForCausalLM`` / ``BertForSequenceClassification``, randomly
initialized from a seed (no download), as the JAX package's
tests/test_gpt2_compat.py and test_llama_compat.py build them.  Token
inputs come from numpy with a fixed seed.

* GPT-2 and LLaMA (MHA, GQA, llama3 scaling with a ``head_dim`` other
  than hidden/heads, linear scaling): the port's fp32 logits against HF's
  and against the JAX ``load_*`` on the same HF model, within 2e-4 (fp32
  sums in other orders move logits of this size by ~1e-6; a wrong layout
  moves them by O(1)); greedy tokens equal to HF's ``generate``; the
  refusals with the JAX messages.
* ``hf_flash``: eager and SDPA BERT inside the context against the stock
  model outside it, at the valid positions and the CLS logits, within
  2e-5 (the port's flash plain version vs HF's softmax, fp32); every
  uncovered case takes the stock path and is counted; the methods are
  restored after an exception; a train step runs inside the context.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
# the model classes load transformers' backends (seconds): at collection,
# not inside a timed test
from transformers import (BertConfig, BertForSequenceClassification,  # noqa: E402,E501
                          BertModel, GPT2Config, GPT2LMHeadModel,
                          LlamaConfig, LlamaForCausalLM)
from transformers.models.bert import modeling_bert  # noqa: E402

from byteps_tpu.integrations import gpt2 as jgpt2  # noqa: E402
from byteps_tpu.integrations import llama as jllama  # noqa: E402
from byteps_tpu_torch import integrations  # noqa: E402
from byteps_tpu_torch.inference import generate  # noqa: E402
from byteps_tpu_torch.integrations import gpt2, hf_flash, llama  # noqa: E402
from byteps_tpu_torch.ops import flash_attention as fa  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU tests run tiny torch ops beside other test workers: one
    intra-op thread each keeps them from oversubscribing the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOGIT_TOL = 2e-4
FLASH_TOL = 2e-5
VOCAB = 97


def _gpt2(seed=0, **kw):
    torch.manual_seed(seed)
    cfg = GPT2Config(
        n_layer=2, n_head=2, n_embd=32, vocab_size=VOCAB, n_positions=64,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, **kw)
    return GPT2LMHeadModel(cfg).eval()


def _llama(seed=0, heads=4, kv_heads=2, d=64, **kw):
    torch.manual_seed(seed)
    cfg = LlamaConfig(
        hidden_size=d, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=heads, num_key_value_heads=kv_heads,
        vocab_size=VOCAB, max_position_embeddings=64, rms_norm_eps=1e-6,
        rope_theta=10000.0, tie_word_embeddings=False,
        attention_dropout=0.0, **kw)
    return LlamaForCausalLM(cfg).eval()


LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 16}
LLAMAS = {
    "gqa": dict(seed=0),
    "mha": dict(seed=3, kv_heads=4),
    "llama3_head_dim": dict(seed=7, head_dim=24, rope_scaling=LLAMA3),
    "linear": dict(seed=13, rope_scaling={"rope_type": "linear",
                                          "factor": 4.0}),
}


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, VOCAB, size=shape)


def _logits_three_ways(hf, port, jax_load, tokens):
    with torch.no_grad():
        want = hf(torch.tensor(tokens)).logits.numpy()
        got = port(torch.tensor(tokens)).numpy()
    jmodel, jvars = jax_load(hf)
    jgot = np.asarray(jmodel.apply(jvars, jnp.asarray(tokens)))
    return got, want, jgot


def test_gpt2_logits_match_hf_and_jax():
    hf = _gpt2()
    port = gpt2.load_gpt2(hf, device="cpu")
    cfg = port.cfg
    assert cfg.norm == "layernorm" and cfg.use_bias and cfg.tie_embeddings
    assert not hasattr(port, "lm_head")
    got, want, jgot = _logits_three_ways(hf, port, jgpt2.load_gpt2,
                                         _tokens(0, (2, 12)))
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(got, jgot, atol=LOGIT_TOL, rtol=0)


def test_gpt2_greedy_tokens_match_hf():
    hf = _gpt2(seed=3)
    port = gpt2.load_gpt2(hf, device="cpu")
    prompt = _tokens(1, (2, 8))
    with torch.no_grad():
        want = hf.generate(torch.tensor(prompt), max_new_tokens=6,
                           do_sample=False, pad_token_id=0).numpy()[:, 8:]
    got = generate(port, torch.tensor(prompt), 6, temperature=0)["tokens"]
    np.testing.assert_array_equal(got.numpy(), want)


def test_gpt2_state_dict_maps_conv1d_onto_dense():
    """HF Conv1D ``[in, out]`` transposed onto ``nn.Linear``'s ``[out,
    in]``, c_attn cut into q/k/v along out; the untied head copied."""
    hf = _gpt2()
    sd = hf.state_dict()
    cfg = gpt2.gpt2_config(hf.config, tie_embeddings=False)
    out = gpt2.convert_gpt2_state_dict(sd, cfg)
    d = cfg.d_model
    w = sd["transformer.h.1.attn.c_attn.weight"]
    assert torch.equal(out["blocks.1.attn.k.weight"], w[:, d:2 * d].t())
    assert torch.equal(out["blocks.1.attn.v.bias"],
                       sd["transformer.h.1.attn.c_attn.bias"][2 * d:])
    assert torch.equal(out["blocks.0.mlp.up.weight"],
                       sd["transformer.h.0.mlp.c_fc.weight"].t())
    assert torch.equal(out["lm_head.weight"], sd["lm_head.weight"])
    # an owned copy, not a view of the HF parameter
    out["embed.weight"].zero_()
    assert sd["transformer.wte.weight"].abs().sum() > 0


@pytest.mark.parametrize("name", sorted(LLAMAS))
def test_llama_logits_match_hf_and_jax(name):
    hf = _llama(**LLAMAS[name])
    port = llama.load_llama(hf, device="cpu")
    assert port.cfg.pos_emb == "rope" and port.cfg.mlp == "swiglu"
    assert port.cfg.kv_heads == hf.config.num_key_value_heads
    got, want, jgot = _logits_three_ways(hf, port, jllama.load_llama,
                                         _tokens(2, (2, 20)))
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(got, jgot, atol=LOGIT_TOL, rtol=0)
    jcfg = jllama.llama_config(hf.config)
    for f in ("head_dim", "rope_scaling", "rope_theta", "num_kv_heads",
              "tie_embeddings", "norm_eps", "max_seq_len"):
        assert getattr(port.cfg, f) == getattr(jcfg, f), f


def test_llama_greedy_tokens_match_hf():
    hf = _llama(seed=1)
    port = llama.load_llama(hf, device="cpu")
    prompt = _tokens(2, (2, 8))
    with torch.no_grad():
        want = hf.generate(torch.tensor(prompt), max_new_tokens=8,
                           do_sample=False, num_beams=1,
                           pad_token_id=0).numpy()[:, 8:]
    got = generate(port, torch.tensor(prompt), 8, temperature=0)["tokens"]
    np.testing.assert_array_equal(got.numpy(), want)


def test_llama_redundant_head_dim_is_derived_and_shapes_checked():
    hf = _llama(seed=17, head_dim=16)      # == hidden / heads
    assert llama.llama_config(hf.config).head_dim is None
    sd = dict(hf.state_dict())
    sd["model.layers.1.mlp.up_proj.weight"] = sd[
        "model.layers.1.mlp.up_proj.weight"].t()
    with pytest.raises(ValueError, match="up_proj"):
        llama.convert_llama_state_dict(sd, llama.llama_config(hf.config))


def _messages(fn_port, fn_jax, cfg):
    msgs = []
    for fn in (fn_port, fn_jax):
        with pytest.raises(ValueError) as e:
            fn(cfg)
        msgs.append(str(e.value))
    return msgs


@pytest.mark.parametrize("case", [
    ("gpt2", dict(activation_function="relu"), "activation_function"),
    ("gpt2", dict(scale_attn_by_inverse_layer_idx=True),
     "scale_attn_by_inverse_layer_idx"),
    ("gpt2", dict(reorder_and_upcast_attn=True), "reorder_and_upcast_attn"),
    ("llama", dict(hidden_act="gelu"), "hidden_act"),
    ("llama", dict(rope_scaling={"rope_type": "yarn", "factor": 2.0}),
     "rope_scaling"),
    ("llama", dict(attention_bias=True), "attention_bias"),
    ("llama", dict(mlp_bias=True), "mlp_bias"),
])
def test_refusals_carry_the_jax_messages(case):
    kind, bad, word = case
    base = (_gpt2() if kind == "gpt2" else _llama()).config
    cfg = type("C", (), {**vars(base), **bad})()
    port, jax_fn = ((gpt2.gpt2_config, jgpt2.gpt2_config) if kind == "gpt2"
                    else (llama.llama_config, jllama.llama_config))
    got, want = _messages(port, jax_fn, cfg)
    assert got == want and word in got


def test_loaders_run_on_the_gpu_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the CPU-only host")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt2.load_gpt2(_gpt2())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.load_llama(_llama())
    assert integrations.load_gpt2 is gpt2.load_gpt2
    assert integrations.__all__ == ["flash_attention_for_hf_bert"]


# ------------------------------------------------------------------ hf_flash


def _bert(impl, seed=0, **kw):
    torch.manual_seed(seed)
    cfg = BertConfig(**{
        **dict(vocab_size=64, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=128,
               max_position_embeddings=32, num_labels=2,
               attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0,
               attn_implementation=impl), **kw})
    return BertForSequenceClassification(cfg).eval()


def _bert_batch():
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, 64, size=(4, 32)))
    lengths = torch.tensor([32, 1, 20, 7])
    mask = (torch.arange(32)[None] < lengths[:, None]).long()
    return tokens, mask


@pytest.mark.parametrize("impl", ["eager", "sdpa"])
def test_hf_bert_inside_the_context_matches_stock(impl):
    model = _bert(impl)
    tokens, mask = _bert_batch()
    m = modeling_bert
    stock = m.BertSelfAttention.forward
    with torch.no_grad():
        want = model(tokens, attention_mask=mask, output_hidden_states=True)
        fa.plain_calls = 0
        with integrations.flash_attention_for_hf_bert() as counts:
            got = model(tokens, attention_mask=mask,
                        output_hidden_states=True)
            unmasked = model(tokens)
        stock_unmasked = model(tokens)
    assert counts.covered == 4 and counts.uncovered_total == 0
    assert fa.plain_calls == 4
    np.testing.assert_allclose(got.logits.numpy(), want.logits.numpy(),
                               atol=FLASH_TOL, rtol=0)
    keep = mask.bool()
    for h, w in zip(got.hidden_states, want.hidden_states):
        np.testing.assert_allclose(h[keep].numpy(), w[keep].numpy(),
                                   atol=FLASH_TOL, rtol=0)
    # the pads see only pads, so their rows are not HF's
    assert not torch.allclose(got.hidden_states[-1][~keep],
                              want.hidden_states[-1][~keep], atol=1e-3)
    np.testing.assert_allclose(unmasked.logits.numpy(),
                               stock_unmasked.logits.numpy(),
                               atol=FLASH_TOL, rtol=0)
    assert m.BertSelfAttention.forward is stock


@pytest.mark.parametrize("impl", ["eager", "sdpa"])
@pytest.mark.parametrize("unpadded", ["all_ones", "no_mask"])
def test_hf_bert_first_call_unpadded_matches_stock(impl, unpadded):
    # a fresh context whose first call has nothing padded: SDPA BERT hands
    # the attention None then, so the per-forward mask read starts from None
    model = _bert(impl)
    tokens, _ = _bert_batch()
    kw = ({"attention_mask": torch.ones_like(tokens)}
          if unpadded == "all_ones" else {})
    with torch.no_grad():
        want = model(tokens, **kw)
        with integrations.flash_attention_for_hf_bert() as counts:
            got = model(tokens, **kw)
    assert counts.covered == 2 and counts.uncovered_total == 0
    np.testing.assert_allclose(got.logits.numpy(), want.logits.numpy(),
                               atol=FLASH_TOL, rtol=0)


def _relative():
    return _bert("eager", position_embedding_type="relative_key")


def _decoder():
    return _bert("eager", is_decoder=True)


@pytest.mark.parametrize("case", [
    ("output_attentions", lambda: _bert("eager"),
     dict(output_attentions=True)),
    ("head_mask", lambda: _bert("eager"),
     dict(head_mask=torch.ones(2, 4))),
    ("dropout", lambda: _bert("eager", attention_probs_dropout_prob=0.1)
     .train(), {}),
    ("decoder_or_cache", _decoder, {}),
    ("position_embedding", _relative, {}),
    ("mask", lambda: _bert("eager"), "per_query_mask"),
])
def test_uncovered_calls_take_stock_and_are_counted(case):
    why, make, extra = case
    model = make()
    tokens, mask = _bert_batch()
    if extra == "per_query_mask":
        # a [B, T, T] mask whose query rows differ is no padding mask
        extra = {}
        mask = torch.tril(torch.ones(4, 32, 32, dtype=torch.long))
    torch.manual_seed(5)
    with torch.no_grad():
        want = model(tokens, attention_mask=mask, **extra).logits
    torch.manual_seed(5)
    with torch.no_grad(), hf_flash.flash_attention_for_hf_bert() as counts:
        got = model(tokens, attention_mask=mask, **extra).logits
    assert counts.covered == 0
    assert dict(counts.uncovered) == {why: 2}
    assert torch.equal(got, want)


def test_cross_attention_takes_stock():
    """A decoder with cross-attention: every self- and cross-attention call
    is uncovered (the JAX context's ``key_value_states`` case)."""
    torch.manual_seed(0)
    cfg = BertConfig(
        vocab_size=64, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=32, is_decoder=True, add_cross_attention=True,
        attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0,
        attn_implementation="eager")
    model = BertModel(cfg).eval()
    tokens, _ = _bert_batch()
    enc = torch.randn(4, 32, 64)
    with torch.no_grad():
        want = model(tokens, encoder_hidden_states=enc).last_hidden_state
        with hf_flash.flash_attention_for_hf_bert() as counts:
            got = model(tokens, encoder_hidden_states=enc).last_hidden_state
    assert counts.covered == 0
    assert dict(counts.uncovered) == {"decoder_or_cache": 2,
                                      "cross_attention": 2}
    assert torch.equal(got, want)


def test_methods_are_restored_after_an_exception():
    m = modeling_bert
    before = {c: vars(c)["forward"] for c in (m.BertSelfAttention,
                                              m.BertSdpaSelfAttention)}
    with pytest.raises(KeyError, match="boom"):
        with hf_flash.flash_attention_for_hf_bert():
            assert all(vars(c)["forward"] is not f for c, f in before.items())
            raise KeyError("boom")
    assert all(vars(c)["forward"] is f for c, f in before.items())


def test_a_train_step_runs_inside_the_context():
    model = _bert("sdpa").train()
    ref = _bert("sdpa").train()
    tokens, mask = _bert_batch()
    labels = torch.tensor([0, 1, 1, 0])
    grads = {}
    for name, m, ctx in (("flash", model,
                          hf_flash.flash_attention_for_hf_bert()),
                         ("stock", ref, None)):
        opt = torch.optim.AdamW(m.parameters(), lr=1e-3, weight_decay=1e-4)
        plain = fa.plain_calls
        if ctx is not None:
            counts = ctx.__enter__()
        try:
            loss = m(tokens, attention_mask=mask, labels=labels).loss
            loss.backward()
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)
        grads[name] = {n: p.grad.clone() for n, p in m.named_parameters()
                       if p.grad is not None}
        opt.step()
        if ctx is not None:
            # 2 forwards, then dq and dk/dv of each layer, on the CPU
            assert fa.plain_calls - plain == 6
    assert counts.covered == 2 and counts.uncovered_total == 0
    assert set(grads["flash"]) == set(grads["stock"])
    for n, g in grads["flash"].items():
        np.testing.assert_allclose(g.numpy(), grads["stock"][n].numpy(),
                                   atol=1e-4, rtol=0, err_msg=n)


def test_an_unknown_forward_signature_is_refused(monkeypatch):
    m = modeling_bert

    def forward(self, hidden_states, attention_mask=None, rotary=None):
        raise AssertionError("never called")

    monkeypatch.setattr(m.BertSelfAttention, "forward", forward)
    with pytest.raises(NotImplementedError, match="rotary"):
        with hf_flash.flash_attention_for_hf_bert():
            pass
    assert m.BertSelfAttention.forward is forward

