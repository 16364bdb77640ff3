"""The actuator half of the autoscaling loop: spawn and retire serve
replicas, journaled so router takeover mid-scale is safe — the port's
copy of ``byteps_tpu/serving/autoscale/actuator.py``.

``ReplicaLauncher`` is the spawn seam.  The default path shells out
through the port's launcher (``python -m byteps_tpu_torch.launcher``
with ``DMLC_ROLE=serve`` and a fresh ``BYTEPS_SERVE_PORT``, inheriting
every other ``BYTEPS_SERVE_*`` knob from the parent environment) and
waits for the replica's ping — a single-host seam by construction
(docs/serving.md states the caveat honestly).  That replica runs on the
GPU (the serve role raises without one), so a caller on the card passes
a ``startup_timeout_s`` that covers a CUDA context and a model init.  Tests and the chaos
harness inject ``spawn_fn``/``stop_fn`` to run replicas in-thread.

Registration goes through ``ServeRouter.add_replica``, which runs the
weights-fingerprint handshake before the replica is placeable —
a wrong-checkpoint spawn is refused before it takes traffic.
Retirement is the zero-client-error ``drain()``.

Scale events are journaled to HA standbys (``k="scale"`` entries plus
the replica roster itself, which now carries addresses): a takeover
mid-scale-up finds the new replica already in the journaled roster
(not orphaned), and a takeover mid-scale-down finds ``drain()``
idempotent against the journaled draining/retired flags (no
double-drain).  ``reconcile_takeover`` closes whatever intent the dead
active left open.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional, Tuple

from .policy import ScaleDecision, ScalePolicy
from .signals import TierSignals

__all__ = ["AUTOSCALE_REPLICAS", "SCALE_EVENTS", "ReplicaHandle",
           "ReplicaLauncher", "AutoscaleController"]

# metric names (docs/observability.md)
AUTOSCALE_REPLICAS = "autoscale.replicas"
SCALE_EVENTS = "autoscale.scale_events"


class ReplicaHandle:
    """One spawned replica: its address plus whatever the spawn seam
    needs to stop it again (a ``subprocess.Popen`` on the default
    path, anything on injected seams)."""

    __slots__ = ("addr", "proc", "idx")

    def __init__(self, addr: str, proc=None):
        self.addr = addr
        self.proc = proc
        self.idx: Optional[int] = None  # router index once registered


class ReplicaLauncher:
    """Spawn/stop seam for serve replicas.

    ``spawn_fn() -> ReplicaHandle`` and ``stop_fn(handle)`` override
    the default single-host subprocess path (the injection point for
    in-thread test replicas and, eventually, a cluster scheduler).
    """

    def __init__(self, spawn_fn: Optional[Callable[[], ReplicaHandle]] = None,
                 stop_fn: Optional[Callable[[ReplicaHandle], None]] = None,
                 base_env: Optional[dict] = None,
                 host: str = "127.0.0.1",
                 startup_timeout_s: float = 30.0):
        self._spawn_fn = spawn_fn
        self._stop_fn = stop_fn
        self._base_env = base_env
        self._host = host
        self.startup_timeout_s = float(startup_timeout_s)

    def spawn(self) -> ReplicaHandle:
        if self._spawn_fn is not None:
            return self._spawn_fn()
        return self._spawn_subprocess()

    def stop(self, handle: ReplicaHandle) -> None:
        if self._stop_fn is not None:
            self._stop_fn(handle)
            return
        if handle.proc is not None:
            handle.proc.terminate()
            try:
                handle.proc.wait(timeout=10.0)
            except Exception:
                handle.proc.kill()

    # ------------------------------------------------- default subprocess

    def _spawn_subprocess(self) -> ReplicaHandle:
        from ...engine.transport import free_port
        from ..frontend import RemoteServeClient

        port = free_port()
        env = dict(os.environ if self._base_env is None
                   else self._base_env)
        env["DMLC_ROLE"] = "serve"
        env["BYTEPS_SERVE_PORT"] = str(port)
        proc = subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.launcher"], env=env)
        addr = f"{self._host}:{port}"
        deadline = time.monotonic() + self.startup_timeout_s
        last_err: Optional[Exception] = None
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"spawned replica exited rc={proc.returncode} "
                    f"before serving on {addr}")
            try:
                cli = RemoteServeClient(addr, timeout=2.0)
                try:
                    cli.ping()
                finally:
                    cli.close()
                return ReplicaHandle(addr, proc)
            except Exception as e:
                last_err = e
                time.sleep(0.2)
        proc.kill()
        raise TimeoutError(
            f"spawned replica on {addr} never answered ping "
            f"within {self.startup_timeout_s:.0f}s: {last_err}")


class AutoscaleController:
    """The control loop: sample -> decide -> act, journaled.

    ``step(now)`` runs one iteration synchronously (what the tests and
    the chaos harness call); ``start()`` runs it on a daemon thread
    every ``interval_s``.  Scale-down retires the youngest
    launcher-spawned replica first (LIFO — static seed replicas are
    never drained by the controller), via the zero-client-error
    ``drain()``.
    """

    def __init__(self, router, policy: ScalePolicy,
                 signals: TierSignals, launcher: ReplicaLauncher,
                 interval_s: float = 1.0, drain_timeout_s: float = 30.0,
                 registry=None):
        self.router = router
        self.policy = policy
        self.signals = signals
        self.launcher = launcher
        self.interval_s = float(interval_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._registry = (registry if registry is not None
                          else getattr(router, "_registry", None))
        self._dynamic: List[ReplicaHandle] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.decisions: List[ScaleDecision] = []
        self.scale_ups = 0
        self.scale_downs = 0
        self.spawn_failures = 0

    # -------------------------------------------------------------- loop

    def start(self) -> "AutoscaleController":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscale")
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.interval_s + 5.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception:
                # the loop must survive a failed actuation (a spawn
                # timeout, a drain timeout) — next interval retries
                self.spawn_failures += 1

    # -------------------------------------------------------------- step

    def step(self, now: Optional[float] = None) -> ScaleDecision:
        if now is None:
            now = time.monotonic()
        agg = self.signals.sample(now)
        current = self.router.placeable_count()
        decision = self.policy.decide(agg, current, now)
        self.decisions.append(decision)
        if decision.acts:
            if decision.action == "up":
                self._scale_up(decision.target - current)
            else:
                self._scale_down(current - decision.target)
        self._gauge_replicas()
        return decision

    def _counter(self, name: str):
        return (self._registry.counter(name)
                if self._registry is not None else None)

    def _gauge_replicas(self) -> None:
        if self._registry is not None:
            self._registry.gauge(AUTOSCALE_REPLICAS).set(
                self.router.placeable_count())

    def _bump_event(self, op: str) -> None:
        c = self._counter(SCALE_EVENTS)
        if c is not None:
            c.inc(op=op)

    # --------------------------------------------------------------- act

    def _scale_up(self, n: int) -> None:
        for _ in range(max(1, n)):
            self.router.journal_scale("up", phase="intent")
            try:
                handle = self.launcher.spawn()
            except Exception:
                self.spawn_failures += 1
                self.router.journal_scale("up", phase="abort")
                raise
            try:
                handle.idx = self.router.add_replica(handle.addr)
            except Exception:
                # refused registration (wrong fingerprint, dead on
                # arrival): the replica never takes traffic
                self.spawn_failures += 1
                self.launcher.stop(handle)
                self.router.journal_scale("up", addr=handle.addr,
                                          phase="abort")
                raise
            with self._lock:
                self._dynamic.append(handle)
            self.scale_ups += 1
            self._bump_event("up")
            self.router.journal_scale("up", addr=handle.addr,
                                      idx=handle.idx, phase="done")

    def _scale_down(self, n: int) -> None:
        for _ in range(max(1, n)):
            with self._lock:
                handle = self._dynamic.pop() if self._dynamic else None
            if handle is None or handle.idx is None:
                return  # only launcher-spawned replicas are retired
            self.router.journal_scale("down", addr=handle.addr,
                                      idx=handle.idx, phase="intent")
            try:
                # idempotent drain: a replica the dead active already
                # retired (journaled flag) returns immediately
                self.router.drain(handle.idx,
                                  timeout=self.drain_timeout_s)
            finally:
                self.launcher.stop(handle)
            self.scale_downs += 1
            self._bump_event("down")
            self.router.journal_scale("down", addr=handle.addr,
                                      idx=handle.idx, phase="done")

    # ---------------------------------------------------------- takeover

    def adopt(self, handle: ReplicaHandle) -> None:
        """Track an externally spawned replica (chaos harness seeds,
        a standby's reconcile) as retire-able by this controller."""
        with self._lock:
            self._dynamic.append(handle)

    def reconcile_takeover(self) -> Optional[str]:
        """Close the scale intent a dead active left open (call on the
        NEW active's controller right after takeover).  Returns what
        was done: ``"adopted"`` (mid-scale-up replica already in the
        journaled roster — keep it), ``"dropped"`` (spawn intent with
        no registered replica — the spawner died with the old active;
        nothing to orphan), ``"drained"`` (finished a mid-scale-down
        drain), or None (no pending intent)."""
        ent = self.router.pending_scale()
        if not ent:
            return None
        op, addr = ent.get("op"), ent.get("addr")
        idx = self.router.replica_index(addr) if addr else None
        if op == "up":
            if idx is None:
                self.router.journal_scale("up", addr=addr,
                                          phase="abort")
                return "dropped"
            self.adopt(ReplicaHandle(addr))
            with self._lock:
                self._dynamic[-1].idx = idx
            self.router.journal_scale("up", addr=addr, idx=idx,
                                      phase="done")
            return "adopted"
        if op == "down" and idx is not None:
            self.router.drain(idx, timeout=self.drain_timeout_s)
            self.router.journal_scale("down", addr=addr, idx=idx,
                                      phase="done")
            return "drained"
        self.router.journal_scale(op or "down", addr=addr, phase="done")
        return None
