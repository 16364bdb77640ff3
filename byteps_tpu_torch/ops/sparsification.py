"""Top-k gradient sparsification with error feedback — the port of
``byteps_tpu/ops/sparsification.py`` (plain torch; the JAX module is
plain ``jnp``, no kernel).

Each worker selects its local top-k gradient coordinates by magnitude,
and only those (index, value) pairs travel the wire via the row-sparse
allreduce (``parallel/collectives.sparse_push_pull``: an all-gather of
the selected coordinates, a scatter-add on the device).  Error feedback
carries the unsent residual to the next step (Stich et al., "Sparsified
SGD with Memory").  Ties in |x| go to the lower index, as
``jax.lax.top_k`` breaks them (a stable descending sort).

Surface mirrors ``ops/quantization.py``:
  * ``topk_select(x, k)`` — pure top-|x| selection, returns
    (indices, values, residual).
  * ``topk_ef_push_pull_gradients(ratio, ...)`` — a gradient transform
    that REPLACES ``push_pull_gradients`` (it owns both the
    sparsification and the communication), over the process mesh's
    ``axis_name`` axes; ``axis_name=None`` is one worker: sparsification
    still applies, only the communication is elided.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Union

import torch

from .quantization import GradientTransform, leaves, map_ef_pairs

__all__ = ["TopKEFState", "topk_select", "topk_ef_push_pull_gradients"]


@dataclasses.dataclass
class TopKEFState:
    error: List[torch.Tensor]  # fp32 residuals, one a gradient


def topk_select(x: torch.Tensor, k: int) -> tuple:
    """Select the k largest-magnitude coordinates of flat ``x``.

    Returns ``(indices [k] int32, values [k] fp32, residual)`` where
    ``residual`` is ``x`` with the selected coordinates zeroed (the
    error-feedback carry).
    """
    flat = x.float().reshape(-1)
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    vals = flat[idx]
    residual = flat.index_fill(0, idx, 0.0).reshape(x.shape)
    return idx.to(torch.int32), vals, residual


def _resolve_k(n: int, ratio: float, k_min: int) -> int:
    return max(min(k_min, n), min(n, int(n * ratio)))


def topk_ef_push_pull_gradients(
    ratio: float = 0.01,
    k_min: int = 1,
    axis_name: Union[str, Sequence[str], None] = "dp",
    average: bool = True,
) -> GradientTransform:
    """Gradient transform: top-k sparsify (with error feedback) and
    row-sparse-allreduce incoming gradients in one step, over the axes
    ``axis_name`` of ``api.mesh()``.

    Per leaf g: corrected = g + e; (idx, vals) = top-k(|corrected|);
    e' = corrected - scatter(idx, vals); the update is the dense sum (or
    mean) over workers of every worker's scattered top-k.  With
    ``ratio=1.0`` this is exactly the dense allreduce (and e'=0).
    """
    axes: Optional[tuple] = None
    if axis_name is not None:
        axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)

    def init_fn(params):
        return TopKEFState([torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                            for p in leaves(params)])

    def update_fn(updates, state):
        from .. import api
        from ..parallel import collectives
        from ..parallel import mesh as mesh_mod

        world, groups = 1, ()
        if axes is not None:
            m = api.mesh()
            for ax in axes:
                world *= mesh_mod.axis_size(m, ax)
            groups = m.groups(axes)

        def one(g, e):
            n = math.prod(g.shape)
            k = _resolve_k(n, ratio, k_min)
            corrected = g.float() + e
            idx, vals, residual = topk_select(corrected, k)
            if k >= n:
                # dense fallback: nothing to sparsify
                dense = corrected.reshape(-1)
                if world > 1:
                    dense = collectives.push_pull_shard(
                        dense, sum_groups=groups, scatter=False)
                new_e = torch.zeros(g.shape, dtype=torch.float32,
                                    device=g.device)
            else:
                if world > 1:
                    dense = collectives.sparse_push_pull(
                        idx, vals[:, None], n, groups=groups)[:, 0]
                else:
                    dense = torch.zeros(n, dtype=torch.float32,
                                        device=g.device).index_add_(
                                            0, idx.long(), vals)
                new_e = residual
            if average and world > 1:
                dense = dense / world
            return dense.reshape(g.shape).to(g.dtype), new_e

        new_updates, new_error = map_ef_pairs(one, updates, state.error)
        return new_updates, TopKEFState(new_error)

    return GradientTransform(init_fn, update_fn)
