"""The (data, model) mesh and the GSPMD-style shardings of the LM's trees.

Counterpart of ``moshi_tpu/parallel/sharding.py``.  ``lm_param_pspecs``
and ``lm_state_pspecs`` return the JAX package's spec trees, each
``PartitionSpec`` written as a tuple of axis names or None per dimension
(a ``QuantTensor``'s spec is a QuantTensor of its fields' specs).
``shard_tree`` gives this rank its local piece of every leaf by its spec
(an axis of size S over a dimension keeps the rank's contiguous 1/S of
it), ``replicate_tree`` the whole leaf; both return a ``ShardedTree``,
which remembers the mesh and the specs.

The ``data`` axis is session parallelism: each rank runs its rows of the
session batch with whole weights, and no collective runs per frame.  A
frame on a tree that the specs shard over ``model`` > 1 is, in the JAX
package, XLA's partitioner's to run; the port does not compute on local
shards as if they were whole weights: ``lm_gen_step``, ``lm_text_step``
and ``lm_audio_step`` gather each model-sharded leaf of a ``ShardedTree``
(params, and the state's rings) before the frame (exact: the frame's bits
are the single-rank frame's), and write the rank's heads of the rings
back after it (``gspmd_frame``).  That gathers the weights every frame;
``parallel/tp.py`` (``tp_shard_lm_params`` under ``tp_scope``) is the
layout whose frame computes on its shards.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from moshi_tpu_torch.parallel.mesh import Mesh, all_gather, build_mesh
from moshi_tpu_torch.quant.formats import QuantTensor

_QT_FIELDS = ("q", "d", "sc", "mn", "dmin", "es", "em")


def make_mesh(data: int = 1, model: int = 1,
              ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The ("data", "model") mesh over the world's first data * model
    ranks (or ``ranks``); every rank of the world calls it."""
    return build_mesh(("data", "model"), (data, model), ranks)


class ShardedTree(dict):
    """A tree of this rank's local leaves, with the ``mesh`` and the
    ``specs`` that cut them (``shard_tree``)."""

    def __init__(self, tree, specs, mesh: Mesh):
        super().__init__(tree)
        self.specs = specs
        self.mesh = mesh


# ---------------------------------------------------------------------------
# leaf-level rules (the JAX package's, spec for spec)
# ---------------------------------------------------------------------------

def _spec_for_weight(path: str, ndim: int) -> tuple:
    """The TP spec of one weight leaf by its tree path and rank: stacked
    leaves carry leading [L] / [W] axes, never sharded; the last two are
    the logical [O, I]."""
    lead = (None,) * (ndim - 2)
    row = (*lead, "model", None)
    col = (*lead, None, "model")
    if ndim < 2:
        return (None,) if ndim else ()
    if "in_proj" in path or "linear_in" in path:
        return row
    if "out_proj" in path or "linear_out" in path:
        return col
    if "text_linear" in path or ".linears" in path or "extra_heads" in path:
        return row
    if "depformer.in" in path:
        return row
    if path.endswith("emb.weight") or "emb.weight" in path:
        return (*lead, None, "model")
    if "out1" in path or "out2" in path:
        return row
    if "low_rank" in path:
        return row
    return (None,) * ndim


def lm_param_pspecs(params) -> dict:
    """Spec tree mirroring an LM param tree (``models/lm.py``)."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, QuantTensor):
            # every packed field on the O axis together: the I axis stays
            # whole for block alignment
            def qspec(arr):
                if arr is None:
                    return None
                nd = arr.dim()
                if "out_proj" in path or "linear_out" in path:
                    return (*((None,) * (nd - 2)), "model", None)
                return _spec_for_weight(path, nd)
            return node._map(qspec)
        nd = node.dim()
        if any(s in path for s in ("alpha", "norm", "bias", "scale")):
            return (None,) * nd
        return _spec_for_weight(path, nd)

    return walk(params, "")


def lm_state_pspecs(state) -> dict:
    """Spec tree of the generation state: KV rings shard (data, heads),
    per-session leaves on data."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in node.items()}
        nd = node.dim()
        if path.endswith(".k") or path.endswith(".v") or path in ("k", "v"):
            return (None, "data", None, "model", None)      # [L, B, cap, H, hd]
        if "cache" in path:
            return ("data", None, None)
        if "offset" in path:
            return ("data",)
        return (None,) * nd

    return walk(state, "")


# ---------------------------------------------------------------------------
# placing a tree: this rank's pieces
# ---------------------------------------------------------------------------

def local_piece(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's piece of ``x`` by ``spec``: along each dimension that
    names an axis, the rank's contiguous 1/S (an owned copy; ``x`` itself
    where the spec names none)."""
    if all(axis is None for axis in spec):
        return x
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        s = mesh.shape[axis]
        if x.shape[dim] % s:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split over {axis}={s}")
        w = x.shape[dim] // s
        x = x.narrow(dim, mesh.index(axis) * w, w)
    return x.clone(memory_format=torch.contiguous_format)


def _qt_shape(qt: QuantTensor, spec: QuantTensor, mesh: Mesh,
              gathered: bool = False):
    """A QuantTensor's logical (O, I) once its fields are cut by ``spec``,
    or, ``gathered``, once a piece's ``model`` cuts are joined again."""
    nd = len(spec.q)

    def size(n, axis):
        if axis is None or (gathered and axis != "model"):
            return n
        s = mesh.shape[axis]
        return n * s if gathered else n // s
    return (size(qt.shape[0], spec.q[nd - 2]),
            size(qt.shape[1], spec.q[nd - 1]))


def _applied(x: torch.Tensor, spec, mesh: Mesh) -> tuple:
    """``spec`` with every axis that does not split its dimension evenly
    left out: that dimension stays whole on every rank (JAX pads an
    uneven shard; the port keeps such a leaf, a scale column or a
    one-block field, whole)."""
    return tuple(a if a is None or x.shape[d] % mesh.shape[a] == 0
                 else None for d, a in enumerate(spec))


def place(tree, specs, mesh: Mesh):
    """(this rank's local tree by ``specs``, the specs as applied)."""
    if isinstance(tree, dict):
        out = {k: place(v, specs[k], mesh) for k, v in tree.items()}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    if isinstance(tree, QuantTensor):
        applied = QuantTensor(tree.fmt, tree.shape, *(
            None if getattr(tree, f) is None else
            _applied(getattr(tree, f), getattr(specs, f), mesh)
            for f in _QT_FIELDS))
        comps = {f: None if getattr(tree, f) is None else
                 local_piece(getattr(tree, f), getattr(applied, f), mesh)
                 for f in _QT_FIELDS}
        return (QuantTensor(tree.fmt, _qt_shape(tree, applied, mesh),
                            **comps), applied)
    applied = _applied(tree, specs, mesh)
    return local_piece(tree, applied, mesh), applied


def shard_tree(tree, pspecs, mesh: Mesh) -> ShardedTree:
    """This rank's local piece of every leaf by the matching spec tree
    (the ``ShardedTree`` keeps the specs as applied)."""
    local, applied = place(tree, pspecs, mesh)
    return ShardedTree(local, applied, mesh)


def repl_specs(tree):
    """A spec tree that cuts nothing."""
    if isinstance(tree, dict):
        return {k: repl_specs(v) for k, v in tree.items()}
    if isinstance(tree, QuantTensor):
        return tree._map(lambda a: (None,) * a.dim())
    return (None,) * tree.dim()


def replicate_tree(tree, mesh: Mesh) -> ShardedTree:
    """Every leaf whole on every rank."""
    return shard_tree(tree, repl_specs(tree), mesh)


# ---------------------------------------------------------------------------
# the GSPMD frame: gather over ``model``, run, write the rank's heads back
# ---------------------------------------------------------------------------

def _model_sharded(spec) -> bool:
    return spec is not None and "model" in spec


def _gather_leaf(x, spec, mesh: Mesh):
    for dim, axis in enumerate(spec):
        if axis == "model" and mesh.shape[axis] > 1:
            x = all_gather(mesh, axis, x, dim=dim)
    return x


def gather_model(tree, specs, mesh: Mesh):
    """The tree with every leaf the specs shard over ``model`` gathered
    whole (the ``data`` cut is kept: a rank's rows stay its own)."""
    if isinstance(tree, dict):
        return {k: gather_model(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, QuantTensor):
        if not any(_model_sharded(getattr(specs, f)) for f in _QT_FIELDS):
            return tree
        comps = {f: None if getattr(tree, f) is None else
                 _gather_leaf(getattr(tree, f), getattr(specs, f), mesh)
                 for f in _QT_FIELDS}
        return QuantTensor(tree.fmt, _qt_shape(tree, specs, mesh, True),
                           **comps)
    return _gather_leaf(tree, specs, mesh) if _model_sharded(specs) else tree


def needs_gather(tree) -> bool:
    """Is ``tree`` a ``ShardedTree`` cut over a ``model`` axis of size > 1?"""
    if not isinstance(tree, ShardedTree) or tree.mesh.shape.get(
            "model", 1) == 1:
        return False

    def any_model(specs):
        if isinstance(specs, dict):
            return any(any_model(v) for v in specs.values())
        if isinstance(specs, QuantTensor):
            return any(_model_sharded(getattr(specs, f)) for f in _QT_FIELDS)
        return _model_sharded(specs)
    return any_model(tree.specs)


def _write_back(local, full, specs, mesh: Mesh):
    """Copy this rank's piece of each model-sharded state leaf of
    ``full`` into ``local`` (in place); returns the local tree with the
    frame's other leaves (new tensors of the rank's rows) taken from
    ``full``."""
    if isinstance(full, dict):
        return {k: _write_back(local.get(k) if isinstance(local, dict)
                               else None, v, specs[k], mesh)
                for k, v in full.items()}
    if _model_sharded(specs) and local is not None:
        local.copy_(local_piece(full, tuple(a if a == "model" else None
                                            for a in specs), mesh))
        return local
    return full


def gspmd_frame(step, cfg, params, state, *args, **kwargs):
    """``step(cfg, params, state, ...)``, whose last result is the new
    state, on trees that ``shard_tree`` cut over ``model``: the cut leaves
    gathered, the step run on whole weights and rings for this rank's
    rows, the rank's heads of the rings written back in place, and the
    state returned as a ``ShardedTree`` of local leaves."""
    pspecs = params.specs if isinstance(params, ShardedTree) else None
    sspecs = state.specs if isinstance(state, ShardedTree) else None
    mesh = (params if pspecs is not None else state).mesh
    full_p = (gather_model(params, pspecs, mesh) if needs_gather(params)
              else params)
    full_s = (gather_model(state, sspecs, mesh) if needs_gather(state)
              else state)
    *outs, new_state = step(cfg, full_p, full_s, *args, **kwargs)
    if sspecs is not None:
        new_state = ShardedTree(_write_back(state, new_state, sspecs, mesh),
                                sspecs, mesh)
    return (*outs, new_state)
