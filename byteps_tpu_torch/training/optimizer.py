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

:func:`push_pull_gradients` is the synchronous form, a bucketed
reduce-scatter / sum / all-gather of a gradient list over the mesh's
data axes (parallel/collectives.py ``push_pull_tree``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .. import api
from ..common.config import get_config
from ..common.partition import (BucketPlan, gather_bucket, plan_buckets,
                                scatter_bucket)
from ..ops.compression import Compression
from ..parallel import collectives
from ..parallel import mesh as mesh_mod

__all__ = ["resolve_local_axis", "push_pull_gradients",
           "DistributedOptimizer"]


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
    comp = Compression.resolve(compression)
    scatter, sums = resolve_local_axis(axes, local_axis)
    cfg = get_config()
    return collectives.push_pull_tree(
        grads, plan=plan, scatter_group=mesh.group(scatter),
        sum_groups=mesh.groups(sums), average=average,
        wire_dtype=comp.wire_dtype or cfg.wire_torch_dtype,
        partition_bytes=partition_bytes or cfg.effective_partition_bytes)


_instances = [0]


class _DistributedMixin:
    """The methods :func:`DistributedOptimizer` adds to the wrapped
    optimizer's class (the reference's dynamic subclass)."""

    def _bps_setup(self, names: List[str], compression, passes: int,
                   average: bool, partition_bytes: int) -> None:
        self._bps_params = [p for g in self.param_groups
                            for p in g["params"] if p.requires_grad]
        self._bps_plan = plan_buckets(list(zip(names, self._bps_params)),
                                      partition_bytes)
        plan = self._bps_plan
        self._bps_leaf_buckets: Dict[int, List[int]] = {}
        self._bps_bucket_leaves: List[set] = []
        for b in plan.buckets:
            leaves = {s.leaf_index for s in b.slices}
            self._bps_bucket_leaves.append(leaves)
            for i in leaves:
                self._bps_leaf_buckets.setdefault(i, []).append(b.bucket_id)
        self._bps_compression = compression
        self._bps_average = average
        self._bps_passes = passes
        self._bps_buffers: Dict[int, torch.Tensor] = {}
        _instances[0] += 1
        prefix = f"DistributedOptimizer{_instances[0]}"
        # declared in schedule order, so the engine's (priority, key)
        # order is the plan's and the top bucket's priority 0 is its own
        # (the engine reads priority 0 as -declared_key)
        self._bps_names = {}
        for b in plan.schedule_order():
            self._bps_names[b] = f"{prefix}.bucket{b}"
            api.declare(self._bps_names[b])
        self._bps_reset_cycle()
        self._bps_hooks = [
            p.register_post_accumulate_grad_hook(self._bps_make_hook(i))
            for i, p in enumerate(self._bps_params)]

    def _bps_reset_cycle(self) -> None:
        self._bps_pass = 0
        self._bps_acc: Dict[int, torch.Tensor] = {}
        self._bps_start_pass()

    def _bps_start_pass(self) -> None:
        self._bps_fired: set = set()
        self._bps_missing = [len(s) for s in self._bps_bucket_leaves]
        self._bps_handles: Dict[int, int] = {}
        self._bps_errors: List[BaseException] = []
        self._bps_synchronized = False

    def _bps_make_hook(self, i: int):
        def hook(p):
            # raising inside autograd may not reach the caller: record it
            # and raise at synchronize()
            try:
                self._bps_ready(i, p.grad)
            except Exception as e:
                self._bps_errors.append(e)
        return hook

    def _bps_ready(self, i: int, g: Optional[torch.Tensor]) -> None:
        if i in self._bps_fired:
            raise AssertionError(
                "a gradient was computed more than once in one pass: call "
                "step() after every backward (backward_passes_per_step "
                "accumulates across step() calls)")
        self._bps_fired.add(i)
        k, n = self._bps_passes, self._bps_pass
        if k > 1:
            if g is None:
                g = torch.zeros_like(self._bps_params[i])
            if n == 0:
                self._bps_acc[i] = g.detach().clone()
            else:
                acc = self._bps_acc[i]
                acc.add_((g - acc).div_(n + 1))
        if n == k - 1:
            for b in self._bps_leaf_buckets.get(i, ()):
                self._bps_missing[b] -= 1
                if self._bps_missing[b] == 0:
                    self._bps_enqueue(b)

    def _bps_source(self, i: int) -> torch.Tensor:
        if self._bps_passes > 1:
            return self._bps_acc[i]
        g = self._bps_params[i].grad
        return torch.zeros_like(self._bps_params[i]) if g is None else g

    def _bps_enqueue(self, b: int) -> None:
        """Pack bucket ``b`` and enqueue its all-reduce.  A bucket that is
        one run of one gradient reduces in place in that gradient (no
        copy); one that fuses several packs into a flat buffer of its
        own."""
        bucket = self._bps_plan.buckets[b]
        src = {i: self._bps_source(i) for i in self._bps_bucket_leaves[b]}
        if len(bucket.slices) == 1 and src[bucket.slices[0].leaf_index] \
                .is_contiguous():
            s = bucket.slices[0]
            buf = src[s.leaf_index].view(-1)[s.leaf_start:
                                             s.leaf_start + s.length]
        else:
            buf = self._bps_buffers.get(b)
            if buf is None:
                buf = torch.empty(bucket.size, dtype=bucket.dtype,
                                  device=self._bps_params[0].device)
                self._bps_buffers[b] = buf
            gather_bucket(src, bucket, out=buf)
        from ..engine.dispatcher import get_engine

        self._bps_handles[b] = get_engine().push_pull_async(
            buf, self._bps_names[b], average=self._bps_average,
            priority=bucket.priority,
            wire_dtype=self._bps_compression.wire_dtype, inplace=True)

    def _bps_raise(self) -> None:
        if self._bps_errors:
            err = self._bps_errors[0]
            self._bps_errors = []
            raise err

    def set_backward_passes_per_step(self, passes: int) -> None:
        """Reference torch/__init__.py:106-110; restarts the cycle."""
        if passes < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self._bps_passes = passes
        self._bps_reset_cycle()

    def synchronize(self) -> None:
        """Wait for every bucket's all-reduce and write the averaged
        gradients into ``p.grad`` (public, for clipping between backward
        and ``step()``).  Buckets whose hooks did not all fire (unused
        parameters) are enqueued here, their missing gradients zero."""
        self._bps_raise()
        if self._bps_passes > 1:
            for i in range(len(self._bps_params)):
                if i not in self._bps_fired:
                    self._bps_ready(i, None)
        from ..engine.dispatcher import get_engine

        engine = get_engine()
        for b in self._bps_plan.schedule_order():
            if b not in self._bps_handles:
                self._bps_enqueue(b)
        grads = []
        for p in self._bps_params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        for b, h in self._bps_handles.items():
            buf = engine.synchronize(h)
            bucket = self._bps_plan.buckets[b]
            s = bucket.slices[0]
            if len(bucket.slices) > 1 or buf.data_ptr() != grads[
                    s.leaf_index].view(-1)[s.leaf_start:].data_ptr():
                scatter_bucket(buf, bucket, grads)
        self._bps_handles = {}
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
    be the same on every worker.  ``compression`` is a cast (``"none"``,
    ``"fp16"``, ``"bf16"`` or a Compressor class; default
    ``BYTEPS_WIRE_DTYPE``).  ``partition_bytes`` (default
    ``BYTEPS_PARTITION_BYTES``) sizes the buckets.  Needs ``api.init()``."""
    api._require_init()
    if isinstance(optimizer, _DistributedMixin):
        raise ValueError("the optimizer is already distributed")
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    comp = Compression.resolve(compression)
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
        names, comp, backward_passes_per_step, average,
        partition_bytes or get_config().effective_partition_bytes)
    return optimizer
