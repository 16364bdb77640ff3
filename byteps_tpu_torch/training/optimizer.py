"""DistributedOptimizer — the port of ``byteps_tpu/training/optimizer.py``
as the torch front-end the reference has (``byteps.torch.
DistributedOptimizer``, torch/__init__.py:98-231; the JAX package's
``byteps_tpu/torch/__init__.py:231-386`` sketches it over its engine).

The JAX package reduces the gradient pytree inside its jitted step
(``push_pull_gradients``, an optax transformation) and lets XLA overlap
the collectives with the backward.  The port does what the reference
does: a hook on every parameter hands its gradient to the bucket plan
(common/partition.py) as backward produces it; when a bucket's last
gradient lands, the bucket is packed into its flat buffer and enqueued
on the eager engine (engine/dispatcher.py) at the plan's priority, so
its all-reduce overlaps the rest of the backward.  ``step()``
synchronizes, unpacks the averaged buckets into ``p.grad`` and runs the
wrapped optimizer.

``backward_passes_per_step = k`` accumulates locally as the JAX
package's ``optax.MultiSteps`` does: ``step()`` is called after every
backward pass; the first ``k - 1`` calls fold the pass's gradients into
their running mean (``acc + (g - acc) / (n + 1)``) and leave the
parameters untouched; the ``k``-th reduces the mean across workers and
steps.  Zero the gradients before each backward pass, as the train step
does.

A biased compression scheme (``compression="onebit"``, ``"topk"``,
``"randomk"``, ``"int8"``) runs error feedback on each parameter's
gradient — the whole leaf, its ``k``-pass mean — before any bucket is
packed from it (compression/error_feedback.py), as the JAX package
chains ``error_feedback_compress`` in front of the collective.

:func:`push_pull_gradients` is the synchronous form, a bucketed
reduce-scatter / sum / all-gather of a gradient list over the mesh's
data axes (parallel/collectives.py ``push_pull_tree``).
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .. import api
from ..common.config import get_config
from ..common.partition import (BucketPlan, gather_bucket, plan_buckets,
                                scatter_bucket)
from ..ops.compression import Compression
from ..parallel import collectives
from ..parallel import mesh as mesh_mod

__all__ = ["resolve_local_axis", "resolve_compression", "push_pull_gradients",
           "BucketReducer", "with_error_feedback", "DistributedOptimizer"]


def resolve_local_axis(axes: Sequence[str],
                       local_axis: Optional[str]) -> tuple:
    """Split the reduce axes into ``(scatter_axis, sum_axes)``: the
    *local* axis is reduce-scattered over (the reference's NCCL group),
    the rest summed on the scattered shard.  Default: the innermost
    (last) axis; ``local_axis`` must be one of ``axes``."""
    axes = tuple(axes)
    if local_axis is None:
        return axes[-1], axes[:-1]
    if local_axis not in axes:
        raise ValueError(
            f"local_axis={local_axis!r} is not one of the reduce axes "
            f"{axes} — the local reduce-scatter must run over a mesh "
            "axis the gradients are reduced across")
    return local_axis, tuple(a for a in axes if a != local_axis)


def push_pull_gradients(grads, axes: Optional[Sequence[str]] = None,
                        average: bool = True, compression: Any = None,
                        partition_bytes: Optional[int] = None,
                        plan: Optional[BucketPlan] = None,
                        local_axis: Optional[str] = None,
                        mesh: Optional[mesh_mod.ProcessMesh] = None
                        ) -> List[torch.Tensor]:
    """Allreduce a gradient list (tensors or ``(name, tensor)`` pairs)
    across the workers, bucketed and in priority order; returns the
    reduced tensors in list order.  ``axes`` defaults to the mesh's data
    axes; one worker is a pass-through (the reference's ``size()==1``
    short-circuit)."""
    mesh = api.mesh() if mesh is None else mesh
    axes = tuple(mesh_mod.reduce_axes(mesh) if axes is None else axes)
    tensors = [g[1] if isinstance(g, tuple) else g for g in grads]
    world = 1
    for ax in axes:
        world *= mesh_mod.axis_size(mesh, ax)
    if world == 1:
        return tensors
    comp, ef = resolve_compression(compression)
    if ef is not None:
        raise ValueError(
            f"compression={compression!r} is a biased scheme and needs "
            f"error-feedback state; use the DistributedOptimizer or apply "
            f"compression.error_feedback_compress before "
            f"push_pull_gradients")
    scatter, sums = resolve_local_axis(axes, local_axis)
    cfg = get_config()
    return collectives.push_pull_tree(
        grads, plan=plan, scatter_group=mesh.group(scatter),
        sum_groups=mesh.groups(sums), average=average,
        wire_dtype=comp.wire_dtype or cfg.wire_torch_dtype,
        partition_bytes=partition_bytes or cfg.effective_partition_bytes)


def resolve_compression(compression) -> tuple:
    """Split a compression spec into ``(cast_compressor, error_feedback)``
    (JAX ``optimizer.py:35-63``).

    Cast specs (Compressor classes, ``"none"``/``"bf16"``/``"fp16"``)
    ride the collective's wire dtype unchanged.  Biased registry schemes
    (``"onebit"``/``"topk"``/``"randomk"``/``"int8"``, or their
    ``Compression.resolve`` classes) become an error-feedback transform
    applied to each gradient before its bucket is packed — compress after
    local aggregation, before the wire — whose residuals live in the
    optimizer's state (compression/error_feedback.py)."""
    if compression is None:
        return Compression.none, None
    if isinstance(compression, str):
        from ..compression import error_feedback_compress, get_scheme

        scheme = get_scheme(compression)
        if scheme.name in ("none", "bf16", "fp16"):
            return getattr(Compression, scheme.name), None
        return Compression.none, error_feedback_compress(scheme)
    scheme = getattr(compression, "scheme", None)
    if scheme is not None and scheme.biased:
        from ..compression import error_feedback_compress

        return Compression.none, error_feedback_compress(scheme)
    return Compression.resolve(compression), None


_instances = [0]


class BucketReducer:
    """The buckets of a named tensor list, all-reduced on the eager engine
    (engine/dispatcher.py) at the plan's priorities.  ``enqueue(b, src)``
    packs bucket ``b`` from ``src(i)`` (leaf ``i``'s tensor) and enqueues
    its all-reduce: a bucket that is one run of one contiguous tensor
    reduces in place in it (no copy); one that fuses several packs into
    a flat buffer of its own.  ``synchronize(outs)`` waits for every
    enqueued bucket and writes the results into ``outs``, the leaves'
    tensors (a no-op for buckets reduced in place there)."""

    def __init__(self, names: List[str], tensors: List[torch.Tensor],
                 partition_bytes: int, average: bool, wire_dtype,
                 prefix: str):
        self.plan = plan_buckets(list(zip(names, tensors)), partition_bytes)
        self.device = tensors[0].device
        self.average, self.wire_dtype = average, wire_dtype
        self.leaf_buckets: Dict[int, List[int]] = {}
        self.bucket_leaves: List[set] = []
        for b in self.plan.buckets:
            leaves = {s.leaf_index for s in b.slices}
            self.bucket_leaves.append(leaves)
            for i in leaves:
                self.leaf_buckets.setdefault(i, []).append(b.bucket_id)
        self.buffers: Dict[int, torch.Tensor] = {}
        self.handles: Dict[int, int] = {}
        # declared in schedule order, so the engine's (priority, key)
        # order is the plan's and the top bucket's priority 0 is its own
        # (the engine reads priority 0 as -declared_key)
        self.names = {}
        for b in self.plan.schedule_order():
            self.names[b] = f"{prefix}.bucket{b}"
            api.declare(self.names[b])

    def enqueue(self, b: int, src) -> None:
        bucket = self.plan.buckets[b]
        leaves = {i: src(i) for i in self.bucket_leaves[b]}
        s = bucket.slices[0]
        if len(bucket.slices) == 1 and leaves[s.leaf_index].is_contiguous():
            buf = leaves[s.leaf_index].view(-1)[s.leaf_start:
                                                s.leaf_start + s.length]
        else:
            buf = self.buffers.get(b)
            if buf is None:
                buf = torch.empty(bucket.size, dtype=bucket.dtype,
                                  device=self.device)
                self.buffers[b] = buf
            gather_bucket(leaves, bucket, out=buf)
        from ..engine.dispatcher import get_engine

        self.handles[b] = get_engine().push_pull_async(
            buf, self.names[b], average=self.average,
            priority=bucket.priority, wire_dtype=self.wire_dtype,
            inplace=True)

    def enqueue_all(self, src) -> None:
        for b in self.plan.schedule_order():
            if b not in self.handles:
                self.enqueue(b, src)

    def synchronize(self, outs: List[torch.Tensor]) -> None:
        from ..engine.dispatcher import get_engine

        engine = get_engine()
        for b, h in self.handles.items():
            buf = engine.synchronize(h)
            bucket = self.plan.buckets[b]
            s = bucket.slices[0]
            if len(bucket.slices) > 1 or buf.data_ptr() != outs[
                    s.leaf_index].view(-1)[s.leaf_start:].data_ptr():
                scatter_bucket(buf, bucket, outs)
        self.handles = {}


class _ErrorFeedbackMixin:
    """Error feedback on the optimizer: one fp32 residual a parameter
    (``ef_state``, an ``EFCompressState``), which ``state_dict()`` and
    ``load_state_dict()`` carry beside the wrapped optimizer's state
    under ``"bps_compression"``."""

    def _bps_ef_setup(self, params: List[torch.Tensor], ef) -> None:
        self.error_feedback = ef
        self.ef_state = ef.init(params) if ef is not None else None

    def _bps_ef_leaf(self, i: int, g: torch.Tensor) -> None:
        """Round leaf ``i``'s gradient ``g`` in place; keep the residual."""
        st = self.ef_state
        deq, st.error[i] = self.error_feedback.leaf(i, g, st.error[i],
                                                    st.count)
        g.copy_(deq)

    def state_dict(self):
        sd = super().state_dict()
        if self.ef_state is not None:
            sd["bps_compression"] = self.ef_state.state_dict()
        return sd

    def load_state_dict(self, state_dict) -> None:
        sd = dict(state_dict)
        comp = sd.pop("bps_compression", None)
        if (comp is None) != (self.ef_state is None):
            raise ValueError(
                "the state and this optimizer disagree on error-feedback "
                "compression: " + ("the state has residuals" if comp
                                   is not None else "the state has none"))
        if comp is not None:
            self.ef_state.load_state_dict(comp)
        super().load_state_dict(sd)


class _LocalErrorFeedbackMixin(_ErrorFeedbackMixin):
    """One worker's error feedback (the JAX world-1 step's
    ``optax.chain(error_feedback_compress(scheme), optimizer)``):
    ``step()`` rounds every gradient (zeros where none was computed),
    then runs the wrapped optimizer."""

    def step(self, closure=None):
        for i, p in enumerate(self._bps_params):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            self._bps_ef_leaf(i, p.grad)
        self.ef_state.count += 1
        return super().step(closure)


def with_error_feedback(optimizer: torch.optim.Optimizer,
                        ef) -> torch.optim.Optimizer:
    """Wrap ``optimizer`` in place so each ``step()`` first runs the
    error-feedback transform ``ef`` on every gradient (one worker; beyond
    one, the DistributedOptimizer does it per gradient as backward
    produces it)."""
    base = type(optimizer)
    optimizer.__class__ = type(f"ErrorFeedback{base.__name__}",
                               (_LocalErrorFeedbackMixin, base), {})
    optimizer._bps_params = [p for g in optimizer.param_groups
                             for p in g["params"] if p.requires_grad]
    optimizer._bps_ef_setup(optimizer._bps_params, ef)
    return optimizer


def _remove_hooks(handles) -> None:
    for h in handles:
        h.remove()


class _DistributedMixin(_ErrorFeedbackMixin):
    """The methods :func:`DistributedOptimizer` adds to the wrapped
    optimizer's class (the reference's dynamic subclass)."""

    def _bps_setup(self, names: List[str], compression, ef, passes: int,
                   average: bool, partition_bytes: int) -> None:
        self._bps_params = [p for g in self.param_groups
                            for p in g["params"] if p.requires_grad]
        _instances[0] += 1
        self._bps_buckets = BucketReducer(
            names, self._bps_params, partition_bytes, average,
            compression.wire_dtype, f"DistributedOptimizer{_instances[0]}")
        self._bps_plan = self._bps_buckets.plan
        self._bps_ef_setup(self._bps_params, ef)
        self._bps_passes = passes
        self._bps_reset_cycle()
        self._bps_hooks = [
            p.register_post_accumulate_grad_hook(self._bps_make_hook(i))
            for i, p in enumerate(self._bps_params)]
        # the hooks live on the parameters, which the optimizer holds: a
        # strong reference from a hook back to the optimizer is a cycle
        # through autograd's C++ side that the collector cannot see, so
        # the hooks hold it weakly and leave with it
        weakref.finalize(self, _remove_hooks, self._bps_hooks)

    def _bps_reset_cycle(self) -> None:
        self._bps_pass = 0
        self._bps_acc: Dict[int, torch.Tensor] = {}
        self._bps_start_pass()

    def _bps_start_pass(self) -> None:
        self._bps_fired: set = set()
        self._bps_missing = [len(s) for s in self._bps_buckets.bucket_leaves]
        self._bps_buckets.handles = {}
        self._bps_errors: List[BaseException] = []
        self._bps_synchronized = False

    def _bps_make_hook(self, i: int):
        ref = weakref.ref(self)

        def hook(p):
            opt = ref()
            if opt is None:
                return
            # raising inside autograd may not reach the caller: record it
            # and raise at synchronize()
            try:
                opt._bps_ready(i, p.grad)
            except Exception as e:
                opt._bps_errors.append(e)
        return hook

    def _bps_ready(self, i: int, g: Optional[torch.Tensor]) -> None:
        if i in self._bps_fired:
            raise AssertionError(
                "a gradient was computed more than once in one pass: call "
                "step() after every backward (backward_passes_per_step "
                "accumulates across step() calls)")
        self._bps_fired.add(i)
        k, n = self._bps_passes, self._bps_pass
        p = self._bps_params[i]
        if k > 1:
            if g is None:
                g = torch.zeros_like(p)
            if n == 0:
                self._bps_acc[i] = g.detach().clone()
            else:
                acc = self._bps_acc[i]
                acc.add_((g - acc).div_(n + 1))
        elif g is None:
            p.grad = torch.zeros_like(p)
        if n == k - 1:
            if self.ef_state is not None:
                # each leaf rounds whole, before any bucket packs from it
                self._bps_ef_leaf(i, self._bps_source(i))
            for b in self._bps_buckets.leaf_buckets.get(i, ()):
                self._bps_missing[b] -= 1
                if self._bps_missing[b] == 0:
                    self._bps_buckets.enqueue(b, self._bps_source)

    def _bps_source(self, i: int) -> torch.Tensor:
        if self._bps_passes > 1:
            return self._bps_acc[i]
        return self._bps_params[i].grad

    def _bps_raise(self) -> None:
        if self._bps_errors:
            err = self._bps_errors[0]
            self._bps_errors = []
            raise err

    def state_dict(self):
        """The wrapped optimizer's state, the residuals, and with ``k``
        passes a step the cycle's progress: the pass and the running
        mean (``optax.MultiSteps`` keeps both in its state too)."""
        sd = super().state_dict()
        if self._bps_passes > 1:
            sd["bps_accumulation"] = {
                "pass": self._bps_pass,
                "acc": [self._bps_acc.get(i)
                        for i in range(len(self._bps_params))]}
        return sd

    def load_state_dict(self, state_dict) -> None:
        sd = dict(state_dict)
        acc = sd.pop("bps_accumulation", None)
        super().load_state_dict(sd)
        self._bps_reset_cycle()
        if acc is not None:
            self._bps_pass = acc["pass"]
            self._bps_acc = {i: t.to(p.device).clone()
                             for i, (t, p) in enumerate(
                                 zip(acc["acc"], self._bps_params))
                             if t is not None}

    def set_backward_passes_per_step(self, passes: int) -> None:
        """Reference torch/__init__.py:106-110; restarts the cycle."""
        if passes < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self._bps_passes = passes
        self._bps_reset_cycle()

    def synchronize(self) -> None:
        """Wait for every bucket's all-reduce and write the averaged
        gradients into ``p.grad`` (public, for clipping between backward
        and ``step()``).  Parameters whose hooks did not fire (unused
        ones) count as zero gradients here."""
        self._bps_raise()
        for i in range(len(self._bps_params)):
            if i not in self._bps_fired:
                self._bps_ready(i, None)
        self._bps_buckets.enqueue_all(self._bps_source)
        grads = []
        for p in self._bps_params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        self._bps_buckets.synchronize(grads)
        self._bps_synchronized = True

    def step(self, closure=None):
        """One mini step: before the ``k``-th backward pass of a cycle,
        fold the pass into the running mean and return None (the
        parameters stay as they are); at the ``k``-th, synchronize and run
        the wrapped optimizer's step."""
        self._bps_raise()
        if self._bps_pass < self._bps_passes - 1:
            for i in range(len(self._bps_params)):
                if i not in self._bps_fired:
                    self._bps_ready(i, None)
            self._bps_pass += 1
            self._bps_start_pass()
            return None
        if not self._bps_synchronized:
            self.synchronize()
        if self.ef_state is not None:
            self.ef_state.count += 1
        self._bps_reset_cycle()
        return super().step(closure)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None, compression: Any = None,
                         backward_passes_per_step: int = 1,
                         average: bool = True,
                         partition_bytes: Optional[int] = None
                         ) -> torch.optim.Optimizer:
    """Wrap ``optimizer`` (in place: its class becomes a subclass, its
    state stays) so each step averages the gradients across workers
    first (reference torch/__init__.py:383-402).

    ``named_parameters`` names the parameters (``model.named_parameters()``);
    without it they are ``param_{i}`` in the optimizer's order, which must
    be the same on every worker.  ``compression`` is a Compressor class or
    a registry scheme name: a cast (``"fp16"``, ``"bf16"``; default
    ``BYTEPS_WIRE_DTYPE``) rides the wire dtype; a biased scheme
    (``"onebit"``, ``"topk"``, ``"randomk"``, ``"int8"``) runs error
    feedback on each parameter's gradient (the ``k``-pass mean) before its
    buckets pack, its residuals in ``ef_state`` and in ``state_dict()``.
    ``partition_bytes`` (default ``BYTEPS_PARTITION_BYTES``) sizes the
    buckets.  Needs ``api.init()``."""
    api._require_init()
    if isinstance(optimizer, _DistributedMixin):
        raise ValueError("the optimizer is already distributed")
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    comp, ef = resolve_compression(compression)
    params = [p for g in optimizer.param_groups for p in g["params"]
              if p.requires_grad]
    if named_parameters is not None:
        named: List[Tuple[str, torch.Tensor]] = list(named_parameters)
        names = [n for n, _ in named]
        if len(names) != len(set(names)):
            dups = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"named_parameters has duplicate names: {dups}")
        by_id = {id(p): n for n, p in named}
        missing = [i for i, p in enumerate(params) if id(p) not in by_id]
        if missing:
            raise ValueError(f"named_parameters does not name optimizer "
                             f"parameters {missing}")
        names = [by_id[id(p)] for p in params]
    else:
        names = [f"param_{i}" for i in range(len(params))]
    base = type(optimizer)
    optimizer.__class__ = type(f"Distributed{base.__name__}",
                               (_DistributedMixin, base), {})
    optimizer._bps_setup(
        names, comp, ef, backward_passes_per_step, average,
        partition_bytes or get_config().effective_partition_bytes)
    return optimizer
