"""Expert-parallel sharding of the depformer's weights-per-step sets.

Counterpart of ``moshi_tpu/parallel/ep.py``.  The depformer's per-step
weight sets (its steps-outer stacked leaves [W, ...] / [dep_q, ...], most
of its memory) are cut on their leading step axis over the mesh's
``model`` axis: each rank stores 1/S of the sets.  The JAX package leaves
the step's gather to XLA (a dynamic slice of a step-sharded operand); here
a cut leaf is a ``StepShards``, and indexing it with a step ``cb`` makes
the owner broadcast that step's piece to every rank of the axis.  Memory
is distributed (storage 1/S, one broadcast per cut leaf and step), not
compute: every rank runs every step.

The bf16 / q8_r path without kernels, as in the JAX package: a
depformer of dense or q8_r weights takes the generic form
(``models/lm.py`` ``_depformer_generate_generic``), which indexes the
per-step weights one step at a time; its tokens are the unsharded
depformer's, bit for bit (the broadcast moves exact bytes).  A schedule
that gathers steps out of order (PersonaPlex's) is not supported on cut
leaves.
"""

from __future__ import annotations

import torch

from moshi_tpu_torch.parallel.mesh import Mesh, broadcast
from moshi_tpu_torch.quant.formats import QuantTensor


class StepShards:
    """This rank's contiguous ``local`` [W/S, ...] of a leaf [W, ...] cut
    on its step axis over ``axis``; ``x[cb]`` is step cb's [...] on every
    rank (its owner broadcasts it), ``x[:n]`` the leaf's first n steps."""

    def __init__(self, local: torch.Tensor, steps: int, mesh: Mesh,
                 axis: str):
        self.local = local
        self.steps = int(steps)
        self.mesh = mesh
        self.axis = axis

    @property
    def shape(self):
        return (self.steps,) + tuple(self.local.shape[1:])

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    def __getitem__(self, idx):
        if isinstance(idx, slice) and idx.start in (None, 0) and \
                idx.step in (None, 1):
            if idx.stop is None or idx.stop >= self.steps:
                return self
            return StepShards(self.local, idx.stop, self.mesh, self.axis)
        if isinstance(idx, int) or (torch.is_tensor(idx) and idx.dim() == 0):
            cb = int(idx)
            if not 0 <= cb < self.steps:
                raise IndexError(f"step {cb} of {self.steps}")
            per = self.local.shape[0]
            owner = cb // per
            mine = self.mesh.index(self.axis) == owner
            piece = (self.local[cb - owner * per] if mine else
                     torch.empty(self.local.shape[1:], dtype=self.dtype,
                                 device=self.device))
            return broadcast(self.mesh, self.axis, piece, owner)
        raise NotImplementedError(
            f"a step-sharded leaf takes one step or a leading range, not "
            f"{idx!r}")


def _shard_steps_leaf(arr, mesh: Mesh, s: int, axis_name: str, step_counts):
    """Cut ``arr`` on its step axis when that axis is one of the step
    counts (W, dep_q) and divides over the axis: a [L] norm stack or the
    [dep_q-1] embedding tables stay whole."""
    if arr.dim() >= 2 and arr.shape[0] in step_counts and \
            arr.shape[0] % s == 0:
        per = arr.shape[0] // s
        i = mesh.index(axis_name)
        return StepShards(arr[i * per:(i + 1) * per].clone(), arr.shape[0],
                          mesh, axis_name)
    return arr


def ep_shard_depformer(params, cfg, mesh: Mesh, axis_name: str = "model"):
    """A copy of the LM param tree with every steps-outer depformer leaf
    cut on its step axis over ``axis_name`` (``StepShards``); everything
    else whole.  ``cfg`` gives the step counts (depformer_num_weights,
    dep_q) that name a steps-outer leading axis."""
    s = mesh.shape[axis_name]
    steps = {int(cfg.depformer_num_weights), int(cfg.dep_q)}

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, QuantTensor):
            return node._map(lambda a: _shard_steps_leaf(a, mesh, s,
                                                         axis_name, steps))
        return _shard_steps_leaf(node, mesh, s, axis_name, steps)

    return {k: (walk(v) if k == "depformer" else v)
            for k, v in params.items()}
