"""Checkpoint / resume — the port of ``byteps_tpu/training/checkpoint.py``,
in torch's format.

The reference delegates checkpointing to the frameworks and supplies the
*consistency* half: ``broadcast_parameters`` /
``broadcast_optimizer_state``, so every worker resumes from the root's
state (torch/__init__.py:234-381).  As in the JAX package, this module
owns the whole story:

  * ``save_checkpoint(path, state)`` writes a tree of tensors and plain
    containers — an object's ``state_dict()`` when it has one (a
    ``TrainState``, a module, an optimizer) — with ``torch.save``, so
    ``torch.load(weights_only=True)`` reads it.  Only rank 0 writes.  The
    write is atomic: the file goes into a temporary sibling directory,
    which ``os.replace`` then renames to ``path``, so a crash mid-save
    never leaves a broken checkpoint under ``path``.
  * ``restore_checkpoint(path, template, broadcast=True)`` loads on rank 0
    and, at more than one worker, broadcasts the tree to every rank (its
    structure, then each tensor), so no rank but 0 needs to read the
    file — the reference's root-loads-then-broadcast pattern (the JAX
    package forces the root to process 0 too).  A ``template`` with
    ``load_state_dict`` receives the tree in place.
  * ``CheckpointManager`` keeps ``step_%010d`` directories, saving every
    ``save_every`` steps and keeping the last ``keep``.

The port reads its own checkpoints; the JAX package's orbax ones are not
read.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..common import logging as bps_log

__all__ = ["save_checkpoint", "restore_checkpoint", "CheckpointManager"]

_FILE = "checkpoint.pt"


def _world_rank() -> tuple:
    from .. import api

    if api._state.initialized:
        return api.size(), api.rank()
    return 1, 0


def _tree(state: Any) -> Any:
    return state.state_dict() if hasattr(state, "state_dict") else state


def save_checkpoint(path: str, state: Any, force: bool = True) -> str:
    """Save ``state`` (a ``TrainState``, anything with ``state_dict()``,
    or a tree of tensors and plain containers) under the directory
    ``path``.  Call on every worker: only rank 0 writes.  ``force``
    replaces an existing checkpoint at ``path``; without it one raises."""
    path = os.path.abspath(path)
    if _world_rank()[1] != 0:
        return path
    if os.path.exists(path) and not force:
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    parent, name = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{name}.tmp-", dir=parent)
    try:
        with open(os.path.join(tmp, _FILE), "wb") as f:
            torch.save(_tree(state), f)
            f.flush()
            os.fsync(f.fileno())
        old = None
        if os.path.exists(path):
            old = tempfile.mkdtemp(prefix=f".{name}.old-", dir=parent)
            os.replace(path, os.path.join(old, name))
        os.replace(tmp, path)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    bps_log.info("checkpoint saved to %s", path)
    return path


class _Tensor:
    """A tensor's place in a broadcast skeleton."""

    def __init__(self, t: torch.Tensor):
        self.shape, self.dtype = tuple(t.shape), t.dtype


def _map(tree, fn):
    if isinstance(tree, torch.Tensor) or isinstance(tree, _Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def _broadcast_tree(tree, root: int):
    """Rank ``root``'s tree on every rank of the api's world: the
    skeleton (shapes, dtypes, plain values) by ``broadcast_object_list``,
    then each tensor, on the worker's device."""
    from .. import api

    group = api.mesh().group(None)
    src = dist.get_global_rank(group, root)
    me = api.rank() == src
    holder = [_map(tree, _Tensor) if me else None]
    dist.broadcast_object_list(holder, src=src, group=group,
                               device=api.device())
    dev = api.device()

    def one(x):
        t = (x.to(dev) if me else
             torch.empty(x.shape, dtype=x.dtype, device=dev))
        dist.broadcast(t, src=src, group=group)
        return t

    return _map(tree if me else holder[0], one)


def restore_checkpoint(path: str, template: Any = None,
                       broadcast: bool = True, root_rank: int = 0) -> Any:
    """Load the checkpoint under ``path``.  With ``broadcast`` and more
    than one worker, rank 0 loads and every rank receives its tree
    (``root_rank`` is forced to 0, the rank that wrote it); without it,
    each rank reads the file itself.  A ``template`` with
    ``load_state_dict`` (a ``TrainState``, a module, an optimizer)
    receives the tree in place and is returned; otherwise the tree is."""
    del root_rank  # save_checkpoint writes on rank 0 alone
    path = os.path.abspath(path)
    world, rank = _world_rank()
    file = os.path.join(path, _FILE)

    def load():
        # mapped, not read: tensors page in as they are copied out
        return torch.load(file, map_location="cpu", weights_only=True,
                          mmap=True)

    if broadcast and world > 1:
        tree = _broadcast_tree(load() if rank == 0 else None, 0)
    else:
        tree = load()
    if template is not None and hasattr(template, "load_state_dict"):
        template.load_state_dict(tree)
        return template
    return tree


class CheckpointManager:
    """Rolling checkpoint manager (keep last k, save every n steps)."""

    def __init__(self, directory: str, save_every: int = 1000, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.save_every = max(1, save_every)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def steps(self):
        out = []
        if not os.path.isdir(self.directory):
            return out
        for d in os.listdir(self.directory):
            if d.startswith("step_"):
                try:
                    out.append(int(d[len("step_"):]))
                except ValueError:
                    pass
        return sorted(out)

    def maybe_save(self, state: Any, step: int) -> Optional[str]:
        if step % self.save_every != 0:
            return None
        path = save_checkpoint(self._step_dir(step), state)
        if _world_rank()[1] == 0:
            for old in self.steps()[: -self.keep] if self.keep > 0 else []:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        return path

    def restore_latest(self, template: Any = None, broadcast: bool = True):
        """``(restored, step)`` of the newest checkpoint, or ``(None, -1)``
        when there is none.  At more than one worker with ``broadcast``,
        rank 0's listing decides."""
        steps = self.steps()
        world = _world_rank()[0]
        if broadcast and world > 1:
            from .. import api

            holder = [steps]
            group = api.mesh().group(None)
            dist.broadcast_object_list(
                holder, src=dist.get_global_rank(group, 0), group=group,
                device=api.device())
            steps = holder[0]
        if not steps:
            return None, -1
        step = steps[-1]
        return (
            restore_checkpoint(self._step_dir(step), template, broadcast),
            step,
        )
