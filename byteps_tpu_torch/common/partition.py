"""Tensor partitioning and gradient bucketization — the port of
``byteps_tpu/common/partition.py``.

Counterpart of reference ``PartitionTensor`` (operations.cc:95-132):
every tensor is split into ``ceil(nbytes / BYTEPS_PARTITION_BYTES)``
partitions, each with its own key, so partitions pipeline independently.
Small tensors are also fused into buckets of up to ``partition_bytes``
(Horovod's fusion buffer, DDP's buckets): one collective a bucket rather
than one a tensor.

The JAX package plans over a flax pytree; the port plans over an ordered
list of named tensors (``model.named_parameters()``, or bare tensors that
get positional names).  A bucket's pack is ``torch.cat`` of flat views
and its unpack views into the one flat buffer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Sequence, Tuple

import torch


def partition_offsets(nbytes: int, bound: int) -> List[Tuple[int, int]]:
    """Split ``nbytes`` into (offset, length) parts each <= bound.

    Mirrors reference operations.cc:95-132 (the accumulated-size loop).
    """
    if nbytes <= 0:
        return [(0, 0)] if nbytes == 0 else []
    if bound <= 0:
        raise ValueError("partition bound must be positive")
    parts = []
    offset = 0
    while offset < nbytes:
        length = min(bound, nbytes - offset)
        parts.append((offset, length))
        offset += length
    return parts


@dataclass(frozen=True)
class LeafSpec:
    """Static description of one tensor of the list."""

    index: int  # position in the list
    name: str
    shape: Tuple[int, ...]
    dtype: Any
    size: int  # elements
    nbytes: int


@dataclass(frozen=True)
class BucketSlice:
    """A contiguous run of one leaf's flat elements placed in a bucket."""

    leaf_index: int
    leaf_start: int  # element offset within the (flattened) leaf
    bucket_start: int  # element offset within the bucket
    length: int  # elements


@dataclass
class Bucket:
    """One schedulable unit of communication.  ``priority`` follows the
    reference's ``-declared_key`` (tensorflow/ops.cc:158): a lower leaf
    index (an earlier layer, needed first by the next forward) has the
    higher priority and is scheduled first."""

    bucket_id: int
    dtype: Any
    size: int  # elements (unpadded)
    priority: int
    slices: List[BucketSlice] = field(default_factory=list)

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize


@dataclass
class BucketPlan:
    """Static plan mapping a tensor list to communication buckets."""

    leaves: List[LeafSpec]
    buckets: List[Bucket]

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def schedule_order(self) -> List[int]:
        """Bucket issue order: priority desc, then bucket id asc — the
        ordering rule of reference scheduled_queue.cc:78-98."""
        return sorted(
            range(len(self.buckets)),
            key=lambda i: (-self.buckets[i].priority,
                           self.buckets[i].bucket_id))


def _named(tensors) -> List[Tuple[str, torch.Tensor]]:
    out = []
    for i, t in enumerate(tensors):
        out.append(t if isinstance(t, tuple) else (f"param_{i}", t))
    return out


def leaf_specs(tensors) -> List[LeafSpec]:
    """Leaf descriptions of ``(name, tensor)`` pairs or bare tensors."""
    specs = []
    for i, (name, t) in enumerate(_named(tensors)):
        size = t.numel()
        specs.append(LeafSpec(index=i, name=name, shape=tuple(t.shape),
                              dtype=t.dtype, size=size,
                              nbytes=size * t.dtype.itemsize))
    return specs


def plan_buckets(tensors, partition_bytes: int = 4_096_000,
                 reverse: bool = True) -> BucketPlan:
    """The bucket plan of a parameter/gradient list.

    * leaves are packed in reverse list order by default, because
      gradients materialize in reverse layer order during backprop — the
      bucket of the *last* layer's grads fills first and its collective
      can overlap the rest of the backward pass;
    * a leaf larger than ``partition_bytes`` is split across buckets
      (reference PartitionTensor, operations.cc:95-132);
    * consecutive small leaves of the same dtype share a bucket;
    * ``priority`` is ``-min(leaf index in bucket)``, the reference's
      ``-declared_key`` rule (tensorflow/ops.cc:158).
    """
    leaves = leaf_specs(tensors)
    order = list(range(len(leaves)))
    if reverse:
        order = order[::-1]

    buckets: List[Bucket] = []
    cur = None

    def close():
        nonlocal cur
        if cur is not None and cur.size > 0:
            buckets.append(cur)
        cur = None

    for li in order:
        leaf = leaves[li]
        bound_elems = max(1, partition_bytes // leaf.dtype.itemsize)
        remaining = leaf.size
        leaf_off = 0
        while remaining > 0:
            if cur is not None and (cur.dtype != leaf.dtype
                                    or cur.size >= bound_elems):
                close()
            if cur is None:
                cur = Bucket(bucket_id=len(buckets), dtype=leaf.dtype,
                             size=0, priority=0, slices=[])
            take = min(bound_elems - cur.size, remaining)
            cur.slices.append(BucketSlice(leaf_index=li, leaf_start=leaf_off,
                                          bucket_start=cur.size,
                                          length=take))
            cur.size += take
            leaf_off += take
            remaining -= take
            if cur.size >= bound_elems:
                close()
    close()

    for b in buckets:
        b.priority = -min(s.leaf_index for s in b.slices)
    return BucketPlan(leaves=leaves, buckets=buckets)


def gather_bucket(tensors: Sequence[torch.Tensor], bucket: Bucket,
                  out: torch.Tensor = None) -> torch.Tensor:
    """One bucket's flat payload from its leaves (``out``, when given,
    receives it in place of a new tensor)."""
    parts = [tensors[s.leaf_index].reshape(-1)[s.leaf_start:
                                               s.leaf_start + s.length]
             for s in bucket.slices]
    if out is not None:
        return torch.cat(parts, out=out)
    return parts[0].clone() if len(parts) == 1 else torch.cat(parts)


def gather_buckets(tensors, plan: BucketPlan) -> List[torch.Tensor]:
    """Every bucket's flat payload, in bucket id order."""
    ts = [t for _, t in _named(tensors)]
    return [gather_bucket(ts, b) for b in plan.buckets]


def scatter_bucket(flat: torch.Tensor, bucket: Bucket,
                   outs: Sequence[torch.Tensor]) -> None:
    """Copy one bucket's payload back into its leaves, in place."""
    for s in bucket.slices:
        dst = outs[s.leaf_index].view(-1)[s.leaf_start:
                                          s.leaf_start + s.length]
        dst.copy_(flat[s.bucket_start:s.bucket_start + s.length])


def scatter_buckets(bucket_tensors: Sequence[torch.Tensor],
                    plan: BucketPlan) -> List[torch.Tensor]:
    """Inverse of :func:`gather_buckets`: the leaves, rebuilt in list
    order with their shapes and dtypes."""
    device = bucket_tensors[0].device if bucket_tensors else None
    outs = [torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
            for leaf in plan.leaves]
    for b, flat in zip(plan.buckets, bucket_tensors):
        scatter_bucket(flat.to(b.dtype), b, outs)
    return outs
