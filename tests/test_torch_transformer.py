"""The port's Transformer (byteps_tpu_torch/models/transformer.py) held
against the JAX ``Transformer`` with the same weights.

Weights are made by the JAX model's own init from a seed and carried
across with ``byteps_tpu_torch.models.convert.from_jax_params``; token
inputs come from numpy with a fixed seed.  Two tiny fp32 configs:

* LLaMA-shaped — rope with llama3 ``rope_scaling``, swiglu, rmsnorm,
  GQA (4 heads over 2 KV heads), tied embeddings;
* GPT-2-shaped — learned positions, layernorm, biases, gelu (tanh),
  untied head.

Tolerance: 1e-4 absolute on fp32 logits — the two frameworks sum the
same products in other orders (XLA vs PyTorch CPU kernels, online vs
dense softmax in the paged kernel), which moves fp32 logits of this
size by ~1e-6; 1e-4 leaves margin without hiding a wrong layout, which
moves them by O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models import transformer as jt
from byteps_tpu.serving.blocks import init_paged_cache as jax_paged_cache
from byteps_tpu_torch.models import transformer as pt
from byteps_tpu_torch.models.convert import from_jax_params
from byteps_tpu_torch.serving.blocks import init_paged_cache

TOL = 1e-4
SCALING = (("factor", 32.0), ("high_freq_factor", 4.0),
           ("low_freq_factor", 1.0), ("original_max_position_embeddings", 16),
           ("rope_type", "llama3"))
CONFIGS = {
    "llama": dict(vocab_size=97, num_layers=2, num_heads=4, num_kv_heads=2,
                  d_model=64, d_ff=128, max_seq_len=64, norm_eps=1e-5,
                  pos_emb="rope", rope_theta=500000.0, rope_scaling=SCALING,
                  mlp="swiglu", tie_embeddings=True),
    "gpt2": dict(vocab_size=97, num_layers=2, num_heads=4, d_model=64,
                 d_ff=128, max_seq_len=64, norm="layernorm", norm_eps=1e-5,
                 use_bias=True, mlp="gelu", pos_emb="learned"),
}
BLOCK = 8


def _pair(name):
    kw = CONFIGS[name]
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **kw)
    jmodel = jt.Transformer(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(1),
                            jnp.zeros((1, 8), jnp.int32))
    pcfg = pt.TransformerConfig(dtype=torch.float32, **kw)
    pmodel = pt.Transformer(pcfg)
    params = jax.tree_util.tree_map(np.asarray, variables)
    pmodel.load_state_dict(from_jax_params(params, pcfg), strict=True)
    return jcfg, jmodel, variables, pcfg, pmodel.eval()


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    return _pair(request.param)


def test_apply_rope_matches_jax_with_llama3_scaling():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    positions = np.array([[0, 1, 2, 3, 4], [40, 41, 42, 43, 60]], np.int32)
    want = np.asarray(jt.apply_rope(jnp.asarray(x), jnp.asarray(positions),
                                    500000.0, SCALING))
    got = pt.apply_rope(torch.from_numpy(x), torch.from_numpy(positions),
                        500000.0, SCALING).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_converter_consumes_every_jax_leaf(models):
    jcfg, _, variables, pcfg, pmodel = models
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, variables), pcfg)
    assert set(sd) == set(pmodel.state_dict())
    assert ("lm_head.weight" in sd) == (not pcfg.tie_embeddings)


def test_prefill_chunks_match_jax_prefill_chunk_paged(models):
    """Two position-offset chunks over a paged pool (the second
    right-padded, read at ``last_idx``): the JAX method gathers rows
    that the test scatters back, the port scatters in place."""
    jcfg, jmodel, variables, pcfg, pmodel = models
    mb, n_blocks = 64 // BLOCK, 64 // BLOCK + 1
    toks = np.random.RandomState(2).randint(0, 97, size=(16,))
    table = np.arange(1, mb + 1, dtype=np.int32)
    jpool = jax_paged_cache(jcfg, n_blocks, BLOCK)
    ppool = init_paged_cache(pcfg, n_blocks, BLOCK)
    for start, n, last in ((0, 8, 7), (8, 5, 4)):
        chunk = np.zeros((1, 8), np.int32)
        chunk[0, :n] = toks[start:start + n]
        jl, rows = jmodel.apply(variables, jnp.asarray(chunk), jpool,
                                jnp.asarray(table), start, last,
                                method=jt.Transformer.prefill_chunk_paged)
        jpool = tuple(
            {k: p[k].at[jnp.asarray(table)].set(
                r[k].reshape(p[k][jnp.asarray(table)].shape))
             for k in p} for p, r in zip(jpool, rows))
        pl = pmodel.prefill_chunk_paged(
            torch.from_numpy(chunk).long(), ppool, torch.from_numpy(table),
            start, last)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=0)


def test_fused_decode_matches_jax_decode_paged_fused(models):
    """Two slots on ragged tables: a 6-token pass through the fused
    path (tq = 6, the verify-width kernel call) then two one-token
    decode steps — port kernel wrapper (plain version on CPU) vs the
    JAX Pallas kernel in interpret mode."""
    jcfg, jmodel, variables, pcfg, pmodel = models
    rng = np.random.RandomState(3)
    n_blocks, mb = 12, 64 // BLOCK
    tables = np.zeros((2, mb), np.int32)
    tables[0, :2] = [5, 2]
    tables[1, :2] = [7, 9]
    jpool = jax_paged_cache(jcfg, n_blocks, BLOCK, layout="flat")
    ppool = init_paged_cache(pcfg, n_blocks, BLOCK)
    toks = rng.randint(0, 97, size=(2, 6)).astype(np.int32)
    pos = np.zeros((2,), np.int32)
    for step in range(3):
        T = toks.shape[1]
        p = pos[:, None] + np.arange(T)[None]
        wblk = np.take_along_axis(tables, p // BLOCK, axis=1)
        woff = (p % BLOCK).astype(np.int32)
        jl, jpool = jmodel.apply(
            variables, jnp.asarray(toks), jpool, jnp.asarray(tables),
            jnp.asarray(pos), jnp.asarray(wblk), jnp.asarray(woff),
            method=jt.Transformer.decode_paged_fused)
        pl = pmodel.decode_paged_fused(
            torch.from_numpy(toks).long(), ppool, torch.from_numpy(tables),
            torch.from_numpy(pos), torch.from_numpy(wblk),
            torch.from_numpy(woff))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=0, err_msg=f"step {step}")
        pos = pos + T
        toks = np.argmax(np.asarray(jl)[:, -1:], axis=-1).astype(np.int32)


def test_dense_decode_matches_jax_decode(models):
    """``decode`` against dense cache rows: prompt prefill at pos 0,
    then one token at pos T (the reference path chip_smoke.py checks
    the serving engine against)."""
    jcfg, jmodel, variables, pcfg, pmodel = models
    toks = np.random.RandomState(4).randint(0, 97, size=(2, 7))
    jc = jt.init_cache(jcfg, 2, 16, layout="grouped")
    pc = pt.init_cache(pcfg, 2, 16)
    jl, jc = jmodel.apply(variables, jnp.asarray(toks), jc, 0, True,
                          method=jt.Transformer.decode)
    pl, pc = pmodel.decode(torch.from_numpy(toks).long(), pc, 0,
                           last_only=True)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    nxt = np.argmax(np.asarray(jl)[:, -1:], axis=-1)
    jl, _ = jmodel.apply(variables, jnp.asarray(nxt), jc, 7,
                         method=jt.Transformer.decode)
    pl, _ = pmodel.decode(torch.from_numpy(nxt).long(), pc, 7)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL, rtol=0)


@pytest.mark.parametrize("layout,quant", [("grouped", False), ("flat", False),
                                          ("grouped", True), ("flat", True)])
@pytest.mark.parametrize("T", [1, 2])
def test_decode_at_a_position_vector_writes_and_masks_per_row(models, layout,
                                                              quant, T):
    """``decode`` with a ``[B]`` position vector: each row writes its fresh
    K/V at ``[pos[b], pos[b] + T)`` and nowhere else, attends only keys up
    to its own positions (rows past them hold garbage that must not
    reach the output), and gives the logits of a one-row call at its own
    int offset as at a traced position (``fresh_prefill=False``: the JAX
    engine's per-slot ``decode``, whose position is traced, takes no
    ``pos = 0`` shortcut, so an int8 row at 0 attends its stored values),
    within 1e-4."""
    _, _, _, pcfg, pmodel = models
    B, S = 3, 32
    pos = [4, 0, 20]
    rng = np.random.RandomState(6)
    toks = torch.from_numpy(rng.randint(0, 97, size=(B, T))).long()
    caches = pt.init_cache(pcfg, B, S, quantized=quant, layout=layout)
    for layer in caches:
        for n, c in layer.items():
            if c.dtype == torch.int8:
                c.copy_(torch.from_numpy(rng.randint(-127, 128, size=c.shape)))
            else:
                c.copy_(torch.from_numpy(rng.uniform(
                    0.005, 0.02, size=c.shape) if "scale" in n
                    else rng.randn(*c.shape)))
    before = [{n: c.clone() for n, c in layer.items()} for layer in caches]
    # garbage past every row's last query position: masked, never attended
    dirty = [{n: c.clone() for n, c in layer.items()} for layer in caches]
    for layer in dirty:
        for n, c in layer.items():
            for b, p in enumerate(pos):
                c[b, p + T:] = 100 if c.dtype == torch.int8 else 1e4
    vec = torch.tensor(pos, dtype=torch.int32)
    got, _ = pmodel.decode(toks, caches, vec)
    got_dirty, _ = pmodel.decode(toks, dirty, vec)
    np.testing.assert_array_equal(got.numpy(), got_dirty.numpy())
    for b, p in enumerate(pos):
        row = [{n: c[b:b + 1].clone() for n, c in layer.items()}
               for layer in before]
        want, row = pmodel.decode(toks[b:b + 1], row, p, fresh_prefill=False)
        np.testing.assert_allclose(got[b:b + 1].numpy(), want.numpy(),
                                   atol=TOL, rtol=0)
        for new, old, one in zip(caches, before, row):
            for n in new:
                written = new[n][b, p:p + T]
                np.testing.assert_allclose(written.float().numpy(),
                                           one[n][0, p:p + T].float().numpy(),
                                           atol=1e-5, rtol=0)
                # nothing else of the row moved
                keep = torch.ones(S, dtype=torch.bool)
                keep[p:p + T] = False
                assert torch.equal(new[n][b, keep], old[n][b, keep]), n
