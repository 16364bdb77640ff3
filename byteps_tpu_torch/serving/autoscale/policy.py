"""Hysteresis-banded, target-tracking scale policy — the port's copy of
``byteps_tpu/serving/autoscale/policy.py`` (docs/serving.md
"Elastic capacity & SLO classes").

``ScalePolicy`` is the pure half of the autoscaling control loop: it
never reads the wall clock, never touches the router, and keeps only
the cooldown stamps of its own past decisions.  ``decide(signals,
current, now)`` is therefore a deterministic state machine over an
injected clock — the tier-1 tests drive it on scripted signal traces
(hysteresis band, per-direction cooldowns, min/max clamps, dry-run)
with zero sleeps, while ``AutoscaleController`` (actuator.py) drives
the same object on real samples.

The policy is target-tracking in the classic sense: the scale-up
target is ``ceil(current * load / up_threshold)`` — "how many replicas
would bring the observed load back under the threshold" — so a 4x
spike jumps capacity in one decision instead of one replica per
interval.  Scale-down is deliberately conservative: one replica at a
time, only below ``down_threshold``, and only outside BOTH cooldowns
(a fresh scale-up must not be immediately unwound by a transient dip).
The band between the two thresholds is the hysteresis region where
the tier holds steady.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["ScaleDecision", "ScalePolicy"]


@dataclass(frozen=True)
class ScaleDecision:
    """One typed output of ``ScalePolicy.decide``.

    ``action`` is ``"up"`` / ``"down"`` / ``"hold"``; ``target`` is the
    desired replica count after the decision (equal to ``current`` for
    holds); ``reason`` is a short human-readable explanation;
    ``dry_run`` marks decisions the actuator must log but not act on.
    """

    action: str
    target: int
    reason: str
    dry_run: bool = False

    @property
    def acts(self) -> bool:
        return self.action != "hold" and not self.dry_run


class ScalePolicy:
    """Hysteresis-banded target tracker over a scalar load signal.

    ``decide`` accepts either a plain float load or any object with a
    ``load`` attribute (``SignalAggregate``).  Load is normalized
    utilization: 1.0 means the placeable tier is exactly saturated,
    above 1.0 work is queueing (signals.py folds queue depth in).
    """

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4,
                 up_threshold: float = 0.8, down_threshold: float = 0.3,
                 up_cooldown_s: float = 5.0,
                 down_cooldown_s: float = 15.0,
                 dry_run: bool = False):
        if not (1 <= min_replicas <= max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}")
        if not (0.0 < down_threshold < up_threshold):
            raise ValueError(
                f"need 0 < down_threshold < up_threshold, got "
                f"{down_threshold}/{up_threshold}")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_threshold = float(up_threshold)
        self.down_threshold = float(down_threshold)
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.dry_run = bool(dry_run)
        self._last_up = float("-inf")
        self._last_down = float("-inf")

    # ------------------------------------------------------------ decide

    def decide(self, signals, current: int, now: float) -> ScaleDecision:
        load = float(getattr(signals, "load", signals))
        current = int(current)

        # clamps outrank thresholds AND cooldowns: an out-of-bounds tier
        # is a config violation, not a load response
        if current < self.min_replicas:
            return self._emit("up", self.min_replicas, now,
                              f"below min_replicas={self.min_replicas}")
        if current > self.max_replicas:
            return self._emit("down", self.max_replicas, now,
                              f"above max_replicas={self.max_replicas}")

        if load > self.up_threshold and current < self.max_replicas:
            if now - self._last_up < self.up_cooldown_s:
                return ScaleDecision(
                    "hold", current,
                    f"load {load:.2f} > {self.up_threshold:.2f} but "
                    f"inside up cooldown", self.dry_run)
            target = min(self.max_replicas,
                         max(current + 1,
                             math.ceil(current * load / self.up_threshold)))
            return self._emit(
                "up", target, now,
                f"load {load:.2f} > {self.up_threshold:.2f}")

        if load < self.down_threshold and current > self.min_replicas:
            # a recent move in EITHER direction pins the tier: scaling
            # down right after an up would thrash on the spike's tail
            since = now - max(self._last_up, self._last_down)
            if since < self.down_cooldown_s:
                return ScaleDecision(
                    "hold", current,
                    f"load {load:.2f} < {self.down_threshold:.2f} but "
                    f"inside down cooldown", self.dry_run)
            return self._emit(
                "down", current - 1, now,
                f"load {load:.2f} < {self.down_threshold:.2f}")

        return ScaleDecision("hold", current,
                             f"load {load:.2f} in band", self.dry_run)

    def _emit(self, action: str, target: int, now: float,
              reason: str) -> ScaleDecision:
        # dry-run stamps cooldowns too — the simulated tier must pace
        # exactly like the live one or the rehearsal lies
        if action == "up":
            self._last_up = now
        else:
            self._last_down = now
        return ScaleDecision(action, target, reason, self.dry_run)
