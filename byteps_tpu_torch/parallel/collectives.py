"""push_pull / broadcast collectives on ``torch.distributed`` — the port
of ``byteps_tpu/parallel/collectives.py``.

The JAX functions run inside ``shard_map`` over named mesh axes; here
each is a function of *this rank's* tensor and the process groups of the
axes (``ProcessMesh.group(axis)``, parallel/mesh.py), and every rank of
a group calls it alike.  The reference's three-level reduction
(SURVEY.md §2.4) stays three collectives:

  * reduce-scatter over the scatter axis (the NCCL ReduceScatter stage,
    core_loops.cc:170-191);
  * a sum of the scattered shard over the sum axes (the push / server
    sum / pull stages, core_loops.cc:430-502);
  * all-gather over the scatter axis (core_loops.cc:192-206).

On CUDA tensors the groups run NCCL, or gloo where the caller named it
at init; gloo takes CUDA tensors for every collective used here (torch
2.11 on the H100, PERF.md), so nothing is staged through host buffers.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..common import partition as partition_mod
from ..common.partition import BucketPlan

__all__ = ["push_pull_shard", "sparse_push_pull", "broadcast_shard",
           "push_pull_tree", "local_reduce_scatter", "reduce_scatter_spans",
           "local_all_gather", "group_size"]

# torch >= 2.13 renames the two (and warns on the old names)
_all_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def group_size(group=None) -> int:
    return dist.get_world_size(group)


def _pad_to(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    n = x.shape[0]
    rem = (-n) % multiple
    if rem:
        x = torch.cat([x, x.new_zeros(rem)])
    return x, n


def push_pull_shard(x: torch.Tensor, scatter_group=None,
                    sum_groups: Sequence = (), average: bool = False,
                    wire_dtype: Optional[torch.dtype] = None,
                    scatter: bool = True) -> torch.Tensor:
    """Allreduce this rank's flat buffer: reduce-scatter over
    ``scatter_group`` (``None`` = the world), sum the shard over each of
    ``sum_groups``, all-gather over ``scatter_group``.  ``scatter=False``
    skips the scatter axis (the JAX ``scatter_axis=None``): the buffer is
    summed over ``sum_groups`` only.

    ``wire_dtype`` casts the payload before communication (the fp16/bf16
    compression hook of reference torch/compression.py:21-75); the sum
    and the average run in it and the result returns in ``x``'s dtype.
    Returns a new tensor; ``x`` is not written."""
    orig_dtype = x.dtype
    x = x.reshape(-1)
    if wire_dtype is not None and x.dtype != wire_dtype:
        x = x.to(wire_dtype)
    denom = 1
    if average:
        for g in tuple(sum_groups) + ((scatter_group,) if scatter else ()):
            denom *= group_size(g)
    if scatter:
        nshards = group_size(scatter_group)
        x, n = _pad_to(x, nshards)
        shard = x.new_empty(x.shape[0] // nshards)
        _reduce_scatter(shard, x, group=scatter_group)
        for g in sum_groups:
            dist.all_reduce(shard, group=g)
        y = x.new_empty(x.shape[0])
        _all_gather_into(y, shard, group=scatter_group)
        y = y[:n]
    else:
        y = x.clone()
        for g in sum_groups:
            dist.all_reduce(y, group=g)
    if average:
        y = y / denom
    return y.to(orig_dtype)


def sparse_push_pull(indices: torch.Tensor, values: torch.Tensor,
                     num_rows: int, groups: Sequence = (None,),
                     average: bool = False,
                     wire_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """Row-sparse allreduce (the reference's reserved
    ``kRowSparsePushPull``, common.h:212-216): this rank contributes
    ``values [k, d]`` for rows ``indices [k]`` (duplicates allowed; every
    rank the same ``k``) and every rank receives the dense
    ``[num_rows, d]`` sum (or mean) of all contributions.  Only the
    nonzero rows cross the wire (an all-gather over each of ``groups``,
    innermost first, as the JAX function gathers); the dense sum adds the
    rows in rank order, duplicates in their order, with JAX's drop rule
    for indices outside ``[-num_rows, num_rows)``."""
    if values.ndim != 2:
        raise ValueError(f"values must be [k, d]; got {tuple(values.shape)}")
    if indices.shape[0] != values.shape[0]:
        raise ValueError("indices and values disagree on k")
    orig_dtype = values.dtype
    if wire_dtype is not None and values.dtype != wire_dtype:
        values = values.to(wire_dtype)
    all_idx, all_val = indices.reshape(-1), values
    n = 1
    for g in reversed(tuple(groups)):
        w = group_size(g)
        n *= w
        idx = all_idx.new_empty(w * all_idx.shape[0])
        _all_gather_into(idx, all_idx.contiguous(), group=g)
        val = all_val.new_empty((w * all_val.shape[0], all_val.shape[1]))
        _all_gather_into(val, all_val.contiguous(), group=g)
        all_idx, all_val = idx, val
    all_idx = torch.where(all_idx < 0, all_idx + num_rows, all_idx).long()
    keep = (all_idx >= 0) & (all_idx < num_rows)
    dense = all_val.new_zeros((num_rows, all_val.shape[1]))
    # index_put_ with accumulate adds duplicates in order (sorted, stable,
    # on CUDA): the sum does not depend on atomics' timing
    dense.index_put_((all_idx[keep],), all_val[keep], accumulate=True)
    if average:
        dense = dense / n
    return dense.to(orig_dtype)


def broadcast_shard(x: torch.Tensor, root_rank: int = 0,
                    group=None) -> torch.Tensor:
    """``root_rank``'s value (a rank of ``group``) on every member; a new
    tensor."""
    out = x.clone()
    src = dist.get_global_rank(group, root_rank) if group is not None \
        else root_rank
    dist.broadcast(out, src=src, group=group)
    return out


def push_pull_tree(tensors, plan: Optional[BucketPlan] = None,
                   scatter_group=None, sum_groups: Sequence = (),
                   average: bool = True,
                   wire_dtype: Optional[torch.dtype] = None,
                   partition_bytes: int = 4_096_000) -> List[torch.Tensor]:
    """Bucketed allreduce of a list of tensors (or ``(name, tensor)``
    pairs): packed into <= ``partition_bytes`` buckets
    (common/partition.py), one :func:`push_pull_shard` a bucket in
    priority order (``BucketPlan.schedule_order``); returns the reduced
    tensors in list order."""
    if plan is None:
        plan = partition_mod.plan_buckets(tensors, partition_bytes)
    buckets = partition_mod.gather_buckets(tensors, plan)
    reduced: List[Optional[torch.Tensor]] = [None] * len(buckets)
    for i in plan.schedule_order():
        reduced[i] = push_pull_shard(
            buckets[i], scatter_group=scatter_group, sum_groups=sum_groups,
            average=average, wire_dtype=wire_dtype)
    return partition_mod.scatter_buckets(reduced, plan)


def local_reduce_scatter(flat: torch.Tensor, group=None) -> torch.Tensor:
    """Sum this rank's flat ``[npad]`` contribution over ``group`` and
    return this rank's chunk ``[npad / size]`` of the sum (chunk ``r`` on
    member ``r``).  ``npad`` must be a multiple of the group size."""
    n = group_size(group)
    if flat.ndim != 1 or flat.shape[0] % n:
        raise ValueError(
            f"local_reduce_scatter expects a flat buffer whose length is a "
            f"multiple of the group size {n}; got {tuple(flat.shape)}")
    out = flat.new_empty(flat.shape[0] // n)
    _reduce_scatter(out, flat.contiguous(), group=group)
    return out


def reduce_scatter_spans(flat: torch.Tensor, group=None) -> torch.Tensor:
    """Sum this rank's flat ``[n]`` contribution over ``group`` and return
    the span this rank owns, in the ceil-chunk layout ZeRO and the
    hierarchical PS rely on: span ``r`` is ``sum[r*c:(r+1)*c]`` with
    ``c = ceil(n / size)``, the last span clipped (possibly empty).  Pads
    internally, so any length works."""
    world = group_size(group)
    if flat.ndim != 1:
        raise ValueError(f"reduce_scatter_spans expects a flat buffer; "
                         f"got {tuple(flat.shape)}")
    n = flat.shape[0]
    chunk = -(-n // world) if n else 0
    padded = torch.cat([flat, flat.new_zeros(chunk * world - n)]) \
        if chunk * world != n else flat
    if chunk == 0:
        return flat.new_empty(0)
    mine = local_reduce_scatter(padded, group)
    r = dist.get_rank(group)
    return mine[:max(0, min(chunk, n - r * chunk))]


def local_all_gather(shard: torch.Tensor, group=None) -> torch.Tensor:
    """The full flat buffer from every member's chunk (chunk ``r`` from
    member ``r``)."""
    if shard.ndim != 1:
        raise ValueError(f"local_all_gather expects a flat chunk; got "
                         f"{tuple(shard.shape)}")
    out = shard.new_empty(shard.shape[0] * group_size(group))
    _all_gather_into(out, shard.contiguous(), group=group)
    return out
