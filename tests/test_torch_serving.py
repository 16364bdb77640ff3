"""The port's paged serving slice as a whole, held against the JAX
package.

* Greedy streams of 4 concurrent prompts from the port's
  ``ServingEngine(paged=True, device="cpu")`` are token-identical to the
  JAX ``ServingEngine(paged=True, paged_kernel="off")`` and to JAX
  ``inference.generate`` — also under a block pool tight enough to force
  preemption and resume.
* Seeded streams repeat within the port (its noise chain is a pure
  function of (seed, token index), so they also survive preemption).
  They do not reproduce ``jax.random``'s draws, by design.
* A JAX ``RemoteServeClient`` against the port's ``ServeFrontend`` gets
  the tokens the port's in-process ``ServeClient`` gets: the frames are
  byte-compatible.
* The port imports neither ``jax`` nor ``byteps_tpu``.

Weights come from the JAX model's init with a fixed seed, carried
across with ``from_jax_params``; prompts from numpy with a fixed seed.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.engine.wire import _encode as jax_encode
from byteps_tpu.inference import generate
from byteps_tpu.models.transformer import Transformer as JaxTransformer
from byteps_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from byteps_tpu.serving import RemoteServeClient as JaxRemoteServeClient
from byteps_tpu.serving import ServeMetrics as JaxServeMetrics
from byteps_tpu.serving import ServingEngine as JaxServingEngine
from byteps_tpu_torch.engine.wire import _encode
from byteps_tpu_torch.models.convert import from_jax_params
from byteps_tpu_torch.models.transformer import Transformer, TransformerConfig
from byteps_tpu_torch.serving import (BlocksExhaustedError, RemoteServeClient,
                                      ServeClient, ServeMetrics, ServingEngine,
                                      serve)
from byteps_tpu_torch.serving import metrics as sm

M = 8  # new tokens per request
KW = dict(vocab_size=61, num_layers=2, num_heads=2, d_model=32, d_ff=64,
          max_seq_len=64)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxTransformerConfig(dtype=jnp.float32, **KW)
    jmodel = JaxTransformer(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(1),
                            jnp.zeros((1, 8), jnp.int32))
    pcfg = TransformerConfig(dtype=torch.float32, **KW)
    state = from_jax_params(jax.tree_util.tree_map(np.asarray, variables),
                            pcfg)
    return jmodel, variables, pcfg, state


def _port_model(tiny):
    _, _, pcfg, state = tiny
    model = Transformer(pcfg)
    model.load_state_dict(state)
    return model


def _prompts(lengths, seed=10):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 61, size=(n,)).astype(np.int32) for n in lengths]


def _port_engine(tiny, **kw):
    kw.setdefault("n_slots", 4)
    return ServingEngine(_port_model(tiny), max_seq=64, block=8,
                         device="cpu", metrics=ServeMetrics(), **kw)


def _run(eng, prompts, m, seeds=None):
    reqs = [eng.submit(p, m, seed=(seeds[i] if seeds else 0))
            for i, p in enumerate(prompts)]
    eng.drain(timeout=60)
    return [r.result() for r in reqs]


@pytest.fixture(scope="module")
def generate_base(tiny):
    jmodel, variables, _, _ = tiny
    out = {}
    for lengths, m in (((5, 6, 7, 8), M), ((9, 10, 11, 12), 12)):
        out[lengths] = [np.asarray(generate(jmodel, variables, p[None], m,
                                            temperature=0.0)["tokens"])[0]
                        for p in _prompts(lengths)]
    return out


def test_greedy_streams_match_jax_engine_and_generate(tiny, generate_base):
    """4 concurrent prompts: port engine == JAX paged engine (gather
    path) == JAX generate(), token for token; blocks granted lazily and
    all returned at the end."""
    jmodel, variables, _, _ = tiny
    prompts = _prompts((5, 6, 7, 8))
    jeng = JaxServingEngine(jmodel, variables, n_slots=4, max_seq=64,
                            temperature=0.0, paged=True, block=8,
                            paged_kernel="off", metrics=JaxServeMetrics())
    jreqs = [jeng.submit(p, M) for p in prompts]
    jeng.drain(timeout=120)
    eng = _port_engine(tiny)
    got = _run(eng, prompts, M)
    for g, j, b in zip(got, jreqs, generate_base[(5, 6, 7, 8)]):
        np.testing.assert_array_equal(g, j.result())
        np.testing.assert_array_equal(g, b)
    assert eng.pool.alloc.used_count == 1  # only the null block
    counts = eng.step_counts()
    assert counts["decode_ticks"] == eng.metrics.get(sm.DECODE_TICKS) > 0
    assert counts["prefill_chunks"] == 4


def test_greedy_parity_under_preemption(tiny, generate_base):
    """A 9-block pool (one max_seq request + the null block) cannot hold
    4 requests of 3 blocks each: the engine preempts and resumes, and
    every stream still equals generate()."""
    eng = _port_engine(tiny, kv_blocks=9)
    got = _run(eng, _prompts((9, 10, 11, 12)), 12)
    for g, b in zip(got, generate_base[(9, 10, 11, 12)]):
        np.testing.assert_array_equal(g, b)
    assert eng.metrics.get(sm.PREEMPTIONS) >= 1
    assert eng.pool.alloc.used_count == 1


def test_chunked_prefill_matches_whole_prompt(tiny, generate_base):
    """chunk=8 splits the 9-12 token prompts into two chunks each (the
    second at a traced position over the paged pool)."""
    eng = _port_engine(tiny, chunk=8)
    got = _run(eng, _prompts((9, 10, 11, 12)), 12)
    for g, b in zip(got, generate_base[(9, 10, 11, 12)]):
        np.testing.assert_array_equal(g, b)
    assert eng.step_counts()["prefill_chunks"] == 8


def test_seeded_streams_repeat_and_survive_preemption(tiny):
    prompts = _prompts((9, 10, 11, 12))
    seeds = [3, 4, 5, 3]
    kw = dict(temperature=0.8, top_k=20, top_p=0.9)
    first = _run(_port_engine(tiny, **kw), prompts, 12, seeds)
    again = _run(_port_engine(tiny, **kw), prompts, 12, seeds)
    tight = _run(_port_engine(tiny, kv_blocks=9, **kw), prompts, 12, seeds)
    for a, b, c in zip(first, again, tight):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    other = _run(_port_engine(tiny, **kw), prompts, 12, [9, 9, 9, 9])
    assert any(not np.array_equal(a, b) for a, b in zip(first, other))


def test_request_that_cannot_fit_fails_typed(tiny):
    eng = _port_engine(tiny, n_slots=1, kv_blocks=9)
    eng.pool.alloc.alloc(7)  # leave one free block beside the null block
    req = eng.submit(_prompts((12,))[0], 4)
    eng.drain(timeout=30)
    with pytest.raises(RuntimeError, match="exhausted"):
        req.result()
    assert isinstance(req.error, BlocksExhaustedError)


def test_jax_client_gets_the_port_frontend_tokens(tiny):
    """A JAX RemoteServeClient (TCP) against the port's ServeFrontend:
    SUBMIT and STREAM replies equal the port's in-process ServeClient,
    and STATS parses; the port's own RemoteServeClient agrees."""
    prompts = _prompts((5, 6, 7, 8))
    local = ServeClient(_port_engine(tiny))
    try:
        want = [local.generate(p, M, timeout=60) for p in prompts]
    finally:
        local.close()
    srv, thread = serve(_port_engine(tiny), 0, host="127.0.0.1",
                        in_thread=True)
    addr = f"127.0.0.1:{srv.server_address[1]}"
    try:
        jc = JaxRemoteServeClient(addr, timeout=60, transport="tcp")
        pc = RemoteServeClient(addr, timeout=60)
        for p, w in zip(prompts, want):
            np.testing.assert_array_equal(jc.generate(p, M), w)
            np.testing.assert_array_equal(list(jc.stream(p, M)), w)
            np.testing.assert_array_equal(pc.generate(p, M), w)
        st = jc.stats()
        assert st["kv_blocks"]["used"] == 1
        assert st["serve.requests_completed"] == 12
        assert pc.ping()
        with pytest.raises(RuntimeError, match="exceeds engine max_seq"):
            pc.generate(prompts[0], 64)
        jc.close()
        pc.close()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.mark.parametrize("frame", [
    (0, '{"max_new_tokens": 8, "seed": 0, "priority": 0, "resume": 0}',
     np.arange(5, dtype=np.int32), b""),
    (0, "end", np.zeros((0,), np.int32), b""),
    (1, "", None, b"QueueFullError: full"),
    (2, "", None, b""),
])
def test_frame_codec_is_byte_compatible(frame):
    assert _encode(*frame) == jax_encode(*frame)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import byteps_tpu_torch, byteps_tpu_torch.serving\n"
        "import byteps_tpu_torch.models.convert, byteps_tpu_torch.launcher\n"
        "import byteps_tpu_torch.inference, byteps_tpu_torch.engine.wire\n"
        "import byteps_tpu_torch.training, byteps_tpu_torch.api\n"
        "import byteps_tpu_torch.ops.flash_attention\n"
        "import byteps_tpu_torch.ops.fused_cross_entropy\n"
        "import byteps_tpu_torch.ops.decode_attention\n"
        "import byteps_tpu_torch.ops.quant_dot\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'byteps_tpu' or m.startswith('byteps_tpu.')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


def test_serve_from_env_on_cpu_answers_a_jax_client(monkeypatch):
    """The serve role's engine built from ``BYTEPS_SERVE_*`` (random
    weights from a seed) serves a JAX client; greedy repeats."""
    from byteps_tpu_torch.common.config import reset_config
    from byteps_tpu_torch.serving.frontend import serve_from_env

    monkeypatch.setenv("BYTEPS_SERVE_PAGED", "1")
    monkeypatch.setenv("BYTEPS_SERVE_BLOCK", "8")
    monkeypatch.setenv("BYTEPS_SERVE_SLOTS", "2")
    monkeypatch.setenv("BYTEPS_SERVE_MODEL",
                       ",".join(f"{k}={v}" for k, v in KW.items()))
    srv, thread = serve_from_env(device="cpu", port=0, in_thread=True)
    try:
        c = JaxRemoteServeClient(f"127.0.0.1:{srv.server_address[1]}",
                                 timeout=60, transport="tcp")
        p = _prompts((6,))[0]
        a, b = c.generate(p, M), c.generate(p, M)
        np.testing.assert_array_equal(a, b)
        assert a.shape == (M,)
        st = c.stats()
        assert st["device"] == "cpu" and st["kv_blocks"]["block"] == 8
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        reset_config()
    assert not thread.is_alive()


def test_serve_role_runs_on_the_gpu_unless_told_otherwise(monkeypatch):
    """``DMLC_ROLE=serve`` without a GPU raises instead of serving on the
    CPU, and unported knobs are refused rather than ignored."""
    from byteps_tpu_torch import launcher
    from byteps_tpu_torch.serving.frontend import serve_from_env

    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the CPU-only host")
    monkeypatch.setenv("DMLC_ROLE", "serve")
    monkeypatch.setenv("BYTEPS_SERVE_PAGED", "1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main()
    monkeypatch.setenv("BYTEPS_SERVE_PAGED_KERNEL", "off")
    with pytest.raises(NotImplementedError, match="PAGED_KERNEL=off"):
        serve_from_env(device="cpu")
    monkeypatch.setenv("DMLC_ROLE", "worker")
    assert launcher.main() == 2
