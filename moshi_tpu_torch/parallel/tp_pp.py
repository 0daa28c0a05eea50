"""TP x PP x sessions on one ("data", "model", "pp") mesh.

Counterpart of ``moshi_tpu/parallel/tp_pp.py``: the temporal stack's
layers split into S stages over ``pp`` (``parallel/pp.py``'s GPipe
schedule), and within each stage every layer Megatron-sharded over
``model`` (``parallel/tp.py``'s layout, two psums a layer over
``model``); the KV rings cut [L -> pp, B -> data, cap, H -> model, hd];
the depformer and the text head TP-sharded over ``model`` and run by every
stage alike; sessions over ``data``, each data shard's split into S
microbatches.

Per frame: 2(S-1) ppermutes and one psum over ``pp``, 2L/S psums over
``model`` in the stack, and the depformer's and head's collectives.

Usage (on every rank):
    mesh = make_tp_pp_mesh(data=1, model=2, pp=2)
    params = tp_pp_shard_lm_params(params, cfg, mesh)
    state = tp_pp_shard_lm_state(init_gen_state(cfg, B), mesh)
    with tp_scope(mesh), pp_scope(mesh, cfg.transformer):
        out, state = lm_gen_step(cfg, params, state, ...)

``nn/transformer.transformer_forward`` takes this path when both scopes
are on and the pp scope matches the stack; ``models/lm`` prefers the TP
forms for the depformer and the head when both are on.
"""

from __future__ import annotations

from typing import Optional, Sequence

from moshi_tpu_torch.parallel.mesh import Mesh, build_mesh
from moshi_tpu_torch.parallel.sharding import ShardedTree, place, shard_tree
from moshi_tpu_torch.quant.formats import QuantTensor


def make_tp_pp_mesh(data: int = 1, model: int = 1, pp: int = 1,
                    ranks: Optional[Sequence[int]] = None) -> Mesh:
    """("data", "model", "pp"): pp innermost (the stage hops are the
    frame's latency chain), model next, data outermost (no collective a
    frame).  Every rank of the world calls it."""
    return build_mesh(("data", "model", "pp"), (data, model, pp), ranks)


def _prepend_axis(spec: tuple, axis: str) -> tuple:
    if not spec or spec[0] is not None:
        raise ValueError(f"leading (layer-stack) axis already sharded: "
                         f"{spec}")
    return (axis,) + tuple(spec[1:])


def tp_pp_layer_specs(layers, pp_axis: str = "pp"):
    """Spec tree of the temporal stacked layers: the TP specs
    (``tp.tp_specs``) with the leading L axis over ``pp``."""
    from moshi_tpu_torch.parallel.tp import tp_specs

    def bump(node):
        if isinstance(node, dict):
            return {k: bump(v) for k, v in node.items()}
        if isinstance(node, QuantTensor):
            return node._map(lambda sp: _prepend_axis(sp, pp_axis))
        return _prepend_axis(node, pp_axis)

    return bump(tp_specs(layers))


def tp_pp_shard_lm_params(params, cfg, mesh: Mesh, pp_axis: str = "pp"):
    """This rank's shard: the TP layout everywhere (``pp`` in no spec, so
    every weight outside the temporal stack is the same on every stage),
    and the temporal stack's layers cut on L over ``pp`` as well."""
    from moshi_tpu_torch.parallel.tp import tp_layout, tp_specs
    s = mesh.shape[pp_axis]
    nl = cfg.transformer.num_layers
    if nl % s:
        raise ValueError(f"num_layers {nl} not divisible by pp={s} stages")
    laid = tp_layout(params, cfg, mesh.shape["model"])
    specs = tp_specs(laid)
    specs["transformer"] = dict(
        specs["transformer"],
        layers=tp_pp_layer_specs(laid["transformer"]["layers"], pp_axis))
    return place(laid, specs, mesh)[0]


def tp_pp_state_pspecs(state, pp_axis: str = "pp", model_axis: str = "model",
                       data_axis: str = "data"):
    """The KV rings [L, B, cap, H, hd] cut (pp, data, -, model, -); the
    per-session leaves on ``data``."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in node.items()}
        nd = node.dim()
        if path.endswith(".k") or path.endswith(".v") or path in ("k", "v"):
            if nd != 5:
                raise ValueError(
                    f"tp_pp_state_pspecs: KV leaf '{path}' has ndim={nd}; "
                    "TPxPP requires the stacked layout [L, B, cap, H, hd]")
            return (pp_axis, data_axis, None, model_axis, None)
        if "cache" in path:
            return (data_axis,) + (None,) * (nd - 1)
        if "offset" in path:
            return (data_axis,) + (None,) * max(nd - 1, 0)
        return (None,) * nd
    return walk(state, "")


def tp_pp_shard_lm_state(state, mesh: Mesh, pp_axis: str = "pp",
                         model_axis: str = "model",
                         data_axis: str = "data") -> ShardedTree:
    return shard_tree(state, tp_pp_state_pspecs(state, pp_axis, model_axis,
                                                data_axis), mesh)
