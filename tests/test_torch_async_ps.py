"""The port's async parameter-server mode (byteps_tpu_torch/engine/
async_ps.py and ``Trainer(async_mode=True)``) against the JAX package's.

* ``ShardedParameterStore`` places every name on the shard JAX's does;
* four threads pushing at once lose no update (integer-valued deltas, so
  any order sums exactly): the state is the initial one plus the sum of
  the pushed deltas, in-process and over a port shard;
* the pipelined exchange's catch-up rule (``params += pulled -
  submitted``) gives JAX's ``AsyncWorker`` values on the same inputs;
* ``Trainer(async_mode=True, device="cpu")`` at one worker, 4 SGD-momentum
  steps at ``async_interval`` 1 and 2 on a 2-layer Llama-shaped
  Transformer whose weights are converted from the JAX model, matches the
  JAX ``Trainer(async_mode=True)`` on the same batches within 1e-5;
* two port workers in threads on one port shard keep the sum-of-deltas
  contract bit for bit: the shard's state is the initial value plus every
  pushed delta replayed in the order of the versions the shard gave them,
  and leaving one worker's deltas out misses.

Inputs come from numpy with fixed seeds; one torch thread.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from byteps_tpu.engine import async_ps as jasync
from byteps_tpu.models import transformer as jt
from byteps_tpu.training.step import lm_loss_fn as jax_lm_loss_fn
from byteps_tpu.training.trainer import Trainer as JaxTrainer
from byteps_tpu_torch import api
from byteps_tpu_torch.common.config import reset_config
from byteps_tpu_torch.engine import async_ps as pasync
from byteps_tpu_torch.engine import ps_server as pps
from byteps_tpu_torch.models import transformer as pt
from byteps_tpu_torch.models.convert import from_jax_params
from byteps_tpu_torch.training import Trainer, lm_loss_fn

TOL = 1e-5
V, T = 97, 32
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
def _fresh():
    reset_config()
    yield
    api.shutdown()
    pasync.reset_async_store()


def test_sharded_store_placement_equals_jax():
    names = [f"param_{i}" for i in range(200)] + [
        f"layer{i}.w#p{j}" for i in range(20) for j in range(4)]
    for n in (1, 2, 3, 5):
        for use_hash in (False, True):
            p = pasync.ShardedParameterStore(n, use_hash=use_hash,
                                             use_native=False)
            j = jasync.ShardedParameterStore(n, use_hash=use_hash,
                                             use_native=False)
            assert [p.shard_of(x) for x in names] == \
                [j.shard_of(x) for x in names]


def _concurrent(store, nthreads=4, pushes=25):
    rng = np.random.RandomState(1)
    init = {f"t{i}": rng.randint(-50, 50, size=33).astype(np.float32)
            for i in range(3)}
    for k, v in init.items():
        store.init_tensor(k, v)
    deltas = [[(f"t{rng.randint(3)}",
                rng.randint(-9, 10, size=33).astype(np.float32))
               for _ in range(pushes)] for _ in range(nthreads)]

    def run(mine):
        for k, d in mine:
            store.push_pull(k, d)

    threads = [threading.Thread(target=run, args=(d,)) for d in deltas]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for k, v in init.items():
        want = v + sum((d for ds in deltas for kk, d in ds if kk == k),
                       np.zeros(33, np.float32))
        assert store.pull(k).tobytes() == want.tobytes()
        assert store.version(k) == sum(kk == k for ds in deltas
                                       for kk, _ in ds)


def test_four_threads_lose_no_update_in_process():
    _concurrent(pasync.ShardedParameterStore(2, use_native=True))


def test_four_threads_lose_no_update_over_a_port_shard():
    srv, _ = pps.serve(0, host="127.0.0.1", in_thread=True)
    store = pps.RemoteStore([f"127.0.0.1:{srv.server_address[1]}"])
    try:
        _concurrent(store)
    finally:
        store.close()
        srv.shutdown()
        srv.server_close()


def test_catch_up_rule_equals_jax_async_worker():
    """Two pipelined exchanges on one store (the second after a push by
    another worker), then the synchronous one: pulled, submitted and the
    catch-up sum equal JAX's ``AsyncWorker`` bit for bit."""
    rng = np.random.RandomState(2)
    p0 = [rng.randn(6, 5).astype(np.float32), rng.randn(7).astype(
        np.float32)]
    steps = [[x + rng.randn(*x.shape).astype(np.float32) * 0.1 for x in p0]
             for _ in range(3)]
    other = [rng.randn(*x.shape).astype(np.float32) * 0.01 for x in p0]
    runs = {}
    for pkg, mod in (("jax", jasync), ("port", pasync)):
        store = mod.AsyncParameterServer(use_native=True)
        w = mod.AsyncWorker(store, [x.copy() for x in p0])
        out = []
        for i in range(2):
            w.begin_push_pull([x.copy() for x in steps[i]])
            if i == 1:
                for k, d in enumerate(other):
                    store.push_delta(f"param_{k}", d)
            pulled, submitted = w.take_result()
            pulled = jax.tree_util.tree_leaves(pulled)
            submitted = jax.tree_util.tree_leaves(submitted)
            now = [x * 1.01 for x in steps[i]]   # trained on meanwhile
            out += [np.asarray(x) + (np.asarray(p) - np.asarray(s))
                    for x, p, s in zip(now, pulled, submitted)]
            out += [np.asarray(p) for p in pulled]
        out += [np.asarray(p) for p in
                jax.tree_util.tree_leaves(w.push_pull(steps[2]))]
        w.close()
        runs[pkg] = out
    for a, b in zip(runs["jax"], runs["port"]):
        assert a.tobytes() == b.tobytes()


# ------------------------------------------------------------ Trainer


def _tokens(seed, B=2):
    return np.random.RandomState(seed).randint(0, V, size=(B, T)).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_pair():
    params = jt.Transformer(jt.TransformerConfig(
        dtype=jnp.float32, **CFG)).init(
            jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    model = jt.Transformer(jt.TransformerConfig(dtype=jnp.float32, **CFG))
    return model, params


@pytest.fixture(scope="module")
def jax_async(jax_pair):
    """The JAX trainer's final params at intervals 1 and 2 (set-up: its
    jit compile is the slow part), and one port Trainer step beforehand,
    so the process's first torch step (its lazy imports) is paid here
    too."""
    model = pt.Transformer(pt.TransformerConfig(dtype=torch.float32, **CFG))
    Trainer(lm_loss_fn(model), torch.optim.SGD(model.parameters(), lr=0.1,
                                               momentum=0.9),
            device="cpu", log_every=0).fit(
        model, {}, [{"tokens": _tokens(0)}])
    api.shutdown()
    return {k: _jax_async(jax_pair, k) for k in (1, 2)}


def _jax_async(jax_pair, interval):
    jmodel, params = jax_pair
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    trainer = JaxTrainer(jax_lm_loss_fn(jmodel),
                         optax.sgd(0.1, momentum=0.9), mesh=mesh,
                         async_mode=True,
                         async_store=jasync.AsyncParameterServer(),
                         async_interval=interval, log_every=0)
    state = trainer.fit(params, {}, [{"tokens": jnp.asarray(_tokens(s))}
                                     for s in range(10, 14)], steps=4)
    trainer.close()
    return jax.tree_util.tree_map(np.asarray, state.params)


@pytest.mark.parametrize("interval", [1, 2])
def test_trainer_async_matches_jax(jax_pair, jax_async, interval):
    want = jax_async[interval]
    pcfg = pt.TransformerConfig(dtype=torch.float32, **CFG)
    model = pt.Transformer(pcfg)
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jax_pair[1]), pcfg))
    store = pasync.AsyncParameterServer()
    trainer = Trainer(lm_loss_fn(model),
                      torch.optim.SGD(model.parameters(), lr=0.1,
                                      momentum=0.9),
                      device="cpu", async_mode=True, async_store=store,
                      async_interval=interval, log_every=0)
    state = trainer.fit(model, {}, [{"tokens": _tokens(s)}
                                    for s in range(10, 14)], steps=4)
    assert state.step == 4
    assert store.version("param_0") == 4 // interval
    assert not trainer._async_worker.exchange_in_flight()   # drained
    trainer.close()
    want_sd = from_jax_params(want, pcfg)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_sd[n].numpy(),
                                   atol=TOL, rtol=0, err_msg=n)
    assert store.pull("param_0").shape == tuple(
        next(model.parameters()).shape)


def test_train_thread_makes_no_host_copy(monkeypatch):
    """After ``init_state`` (whose registration copies the parameters to
    the host once, as JAX's does), every host copy of an exchange runs on
    the exchange thread: the train thread only clones and adopts (after
    tests/test_async_ps.py::test_trainer_pipelined_async_no_trainloop_
    device_get)."""
    main = threading.current_thread()
    calls = []
    host = pasync._host

    def spy(x):
        if threading.current_thread() is main:
            calls.append(1)
        return host(x)

    model = pt.Transformer(pt.TransformerConfig(dtype=torch.float32, **CFG))
    pt.init_weights(model, 5)
    trainer = Trainer(lm_loss_fn(model), torch.optim.SGD(model.parameters(),
                                                         lr=0.1),
                      device="cpu", async_mode=True, async_interval=2,
                      async_store=pasync.AsyncParameterServer(),
                      log_every=0)
    trainer.state = trainer.init_state(model)
    monkeypatch.setattr(pasync, "_host", spy)
    trainer.fit(model, {}, [{"tokens": _tokens(s)} for s in range(4)])
    monkeypatch.undo()
    trainer.close()
    assert not calls, "the train thread copied parameters to the host"
    assert trainer._async_worker is None


def test_overlap_refuses_async_mode():
    model = pt.Transformer(pt.TransformerConfig(dtype=torch.float32, **CFG))
    with pytest.raises(ValueError, match="async_mode"):
        Trainer(lm_loss_fn(model), torch.optim.SGD(model.parameters(),
                                                   lr=0.1),
                device="cpu", async_mode=True, overlap=True,
                async_store=pasync.AsyncParameterServer(use_native=False))


def test_two_port_workers_keep_the_sum_of_deltas():
    srv, _ = pps.serve(0, host="127.0.0.1", in_thread=True)
    addr = f"127.0.0.1:{srv.server_address[1]}"
    pushed, lock = [], threading.Lock()
    inner = srv.store.push_pull_versioned

    def recording(name, delta):
        out, v = inner(name, delta)
        with lock:
            pushed.append((threading.get_ident(), name, v,
                           np.array(delta, copy=True)))
        return out, v

    srv.store.push_pull_versioned = recording
    pcfg = pt.TransformerConfig(dtype=torch.float32, **CFG)
    init = pt.Transformer(pcfg)
    pt.init_weights(init, 3)
    init_sd = {k: v.clone() for k, v in init.state_dict().items()}
    api.init(device="cpu")
    results, errors = {}, []

    def worker(rank):
        try:
            model = pt.Transformer(pcfg)
            model.load_state_dict(init_sd)
            store = pps.RemoteStore([addr])
            trainer = Trainer(lm_loss_fn(model),
                              torch.optim.SGD(model.parameters(), lr=0.1),
                              device="cpu", async_mode=True,
                              async_store=store, worker_id=rank,
                              log_every=0)
            trainer.fit(model, {}, [{"tokens": _tokens(20 + 4 * rank + s)}
                                    for s in range(4)], steps=4)
            trainer.close()
            store.close()
            results[rank] = model
        except Exception as e:   # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    try:
        assert not errors, errors
        check = pps.RemoteStore([addr])
        names = [f"param_{i}" for i in range(len(list(init.parameters())))]
        init_leaves = [p.detach().numpy() for p in init.parameters()]
        # the shard serves each client's connection on a thread of its
        # own: the recorded thread names the worker that pushed
        conns = sorted({tid for tid, _, _, _ in pushed})
        assert len(conns) == 2
        for name, x0 in zip(names, init_leaves):
            mine = sorted((v, tid, d) for tid, n, v, d in pushed
                          if n == name)
            assert [v for v, _, _ in mine] == list(range(1, 9))
            got = check.pull(name)
            want = x0.copy()
            for _, _, d in mine:
                want = want + d
            assert got.tobytes() == want.tobytes(), name
            control = x0.copy()
            for _, tid, d in mine:
                if tid != conns[1]:
                    control = control + d
            assert got.tobytes() != control.tobytes(), name
        check.close()
    finally:
        srv.shutdown()
        srv.server_close()
