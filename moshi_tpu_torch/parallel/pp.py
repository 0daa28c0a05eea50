"""Pipeline parallelism: the temporal stack's layers in stages.

Counterpart of ``moshi_tpu/parallel/pp.py``.  The temporal transformer's
stacked layers [L, ...] split over a ``pp`` mesh axis (S stages of L/S
contiguous layers), and the session batch into S microbatches that flow
through the stages GPipe-style in one frame:

  phase p (0 .. 2S-2): stage s runs microbatch m = p - s (where
  0 <= m < S) on its layers and hands its activation to stage s+1
  (``ppermute``); stage 0 takes x[m] at phase m, stage S-1 emits y[m] at
  phase m+S-1, and the outputs are summed over ``pp`` (only the last
  stage's are not zero), so every stage holds them.

Each stage holds the KV rings of its own layers for all its sessions
([L/S, B, cap, H, hd]), so ring state never moves between ranks: only the
[B/S, D] activation does (2(S-1) ppermutes and one psum a frame).  A
stage runs only its active phases (the JAX package's SPMD body computes
the idle ones too and discards them).  A microbatch's rings are copied
out of the stage's and back around its layers when the microbatch is not
the whole batch (the kernels take contiguous rings).  The depformer and
the text head run on every rank with whole weights (``models/lm``'s own
paths, no collectives), on its rows of the session batch: on a
("data", "pp") mesh the batch splits over ``data`` first.

Dispatch is gated on the stack's whole ``TransformerConfig``
(``PPContext.matches``), so another stack of the same depth (Mimi's, the
depformer's) called in the scope runs unpipelined.

Usage (on every rank):
    mesh = make_pp_mesh(pp=2)                  # or (pp=2, data=2)
    params = pp_shard_lm_params(params, cfg, mesh)
    state = pp_shard_lm_state(init_gen_state(cfg, B), mesh)
    with pp_scope(mesh, cfg.transformer):
        out, state = lm_gen_step(cfg, params, state, ...)
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Sequence

import torch

from moshi_tpu_torch.parallel.mesh import Mesh, build_mesh, ppermute, psum
from moshi_tpu_torch.parallel.sharding import (ShardedTree, repl_specs,
                                               shard_tree)
from moshi_tpu_torch.quant.formats import QuantTensor


@dataclasses.dataclass(frozen=True)
class PPContext:
    mesh: Mesh
    num_layers: int               # the depth of the stack this scope pipelines
    pp_axis: str = "pp"
    data_axis: str = "data"
    # the stack's whole TransformerConfig: dispatch on the depth alone
    # would pipeline any other stack of that depth called in the scope
    stack_cfg: object = None

    @property
    def nstages(self) -> int:
        return self.mesh.shape[self.pp_axis]

    def matches(self, cfg) -> bool:
        """Is ``cfg`` the stack this scope pipelines?"""
        if self.stack_cfg is not None:
            return cfg == self.stack_cfg
        return cfg.num_layers == self.num_layers


_PP_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "moshi_tpu_torch_pp", default=None)


def current_pp() -> Optional[PPContext]:
    return _PP_CTX.get()


@contextlib.contextmanager
def pp_scope(mesh: Mesh, stack, pp_axis: str = "pp",
             data_axis: str = "data"):
    """Pipeline one transformer stack in the frames called within.
    ``stack`` is its ``TransformerConfig`` (dispatch then needs the whole
    config to match); a bare int depth is taken too, and then no other
    stack of that depth may run in the scope."""
    if isinstance(stack, int):
        ctx = PPContext(mesh, stack, pp_axis, data_axis)
    else:
        ctx = PPContext(mesh, stack.num_layers, pp_axis, data_axis,
                        stack_cfg=stack)
    tok = _PP_CTX.set(ctx)
    try:
        yield
    finally:
        _PP_CTX.reset(tok)


def make_pp_mesh(pp: int, data: int = 1,
                 ranks: Optional[Sequence[int]] = None) -> Mesh:
    """The ("data", "pp") mesh; every rank of the world calls it."""
    return build_mesh(("data", "pp"), (data, pp), ranks)


# ---------------------------------------------------------------------------
# sharding: the stacked layers split on their leading L axis
# ---------------------------------------------------------------------------


def _stack_spec(ndim: int, pp_axis: str) -> tuple:
    return (pp_axis,) + (None,) * (ndim - 1)


def pp_layer_specs(layers, pp_axis: str = "pp"):
    """Spec tree of a stacked ``layers`` subtree: every leaf (tensor or
    QuantTensor field) has the layer stack as its leading axis."""
    if isinstance(layers, dict):
        return {k: pp_layer_specs(v, pp_axis) for k, v in layers.items()}
    if isinstance(layers, QuantTensor):
        return layers._map(lambda a: _stack_spec(a.dim(), pp_axis))
    return _stack_spec(layers.dim(), pp_axis)


def _pp_param_specs(params, pp_axis: str = "pp"):
    """The spec tree ``pp_shard_lm_params`` places by: the temporal
    stack's layers over ``pp``, every other leaf whole."""
    specs = repl_specs(params)
    specs["transformer"] = dict(specs["transformer"], layers=pp_layer_specs(
        params["transformer"]["layers"], pp_axis))
    return specs


def pp_shard_lm_params(params, cfg, mesh: Mesh, pp_axis: str = "pp"):
    """This rank's stage of the temporal stack's layers; everything else
    (embeddings, heads, the depformer, norms) whole."""
    s = mesh.shape[pp_axis]
    if cfg.transformer.num_layers % s:
        raise ValueError(f"num_layers {cfg.transformer.num_layers} not "
                         f"divisible by pp={s} stages")
    return shard_tree(params, _pp_param_specs(params, pp_axis), mesh)


def pp_state_pspecs(state, pp_axis: str = "pp", data_axis: str = "data"):
    """State spec tree: the temporal rings [L, B, cap, H, hd] split L over
    ``pp`` and B over ``data``; the delay cache and offsets their session
    axis over ``data``."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in node.items()}
        nd = node.dim()
        if path.endswith(".k") or path.endswith(".v") or path in ("k", "v"):
            if nd != 5:
                raise ValueError(
                    f"pp_state_pspecs: KV leaf '{path}' has ndim={nd}; PP "
                    "requires the stacked KV layout [L, B, cap, H, hd] "
                    "(flat megakernel state is not pipelinable — build the "
                    "state with MOSHI_TPU_MEGAKERNEL unset)")
            return (pp_axis, data_axis, None, None, None)
        if "cache" in path:
            return (data_axis,) + (None,) * (nd - 1)
        if "offset" in path:
            return (data_axis,) + (None,) * max(nd - 1, 0)
        return (None,) * nd
    return walk(state, "")


def pp_shard_lm_state(state, mesh: Mesh, pp_axis: str = "pp",
                      data_axis: str = "data") -> ShardedTree:
    return shard_tree(state, pp_state_pspecs(state, pp_axis, data_axis),
                      mesh)


# ---------------------------------------------------------------------------
# the pipelined decode
# ---------------------------------------------------------------------------


def pipeline_decode(cfg, params, state, x, offset, pp: PPContext, tp=None):
    """The GPipe schedule over the stacked decode of this rank's L/S
    layers (with ``tp``, each stage's layers are TP shards and take its
    psums).  x [B, 1, D] this rank's rows (B divisible by S); returns
    (y [B, 1, D], state with this stage's rings written in place)."""
    from moshi_tpu_torch.nn.transformer import _forward_stacked_decode
    s_count = pp.nstages
    mesh = pp.mesh
    sidx = mesh.index(pp.pp_axis)
    cfg_local = dataclasses.replace(cfg,
                                    num_layers=cfg.num_layers // s_count)
    b, _, d = x.shape
    if b % s_count:
        raise ValueError(f"local batch {b} not divisible by {s_count} pp "
                         f"stages")
    bm = b // s_count
    k_stack, v_stack = state["k"], state["v"]
    layers = {"layers": params["layers"]}
    recv = torch.zeros((bm, d), dtype=x.dtype, device=x.device)
    outs = torch.zeros((s_count, bm, d), dtype=x.dtype, device=x.device)
    for p in range(2 * s_count - 1):
        mb = p - sidx                              # microbatch at this stage
        h = torch.zeros_like(recv)
        if 0 <= mb < s_count:
            rows = slice(mb * bm, (mb + 1) * bm)
            h_in = x[rows, 0] if sidx == 0 else recv
            whole = bm == b
            ring = ({"k": k_stack, "v": v_stack} if whole else
                    {"k": k_stack[:, rows].contiguous(),
                     "v": v_stack[:, rows].contiguous()})
            y, _ = _forward_stacked_decode(cfg_local, layers, ring,
                                           h_in[:, None], offset[rows],
                                           tp=tp)
            if not whole:
                k_stack[:, rows] = ring["k"]
                v_stack[:, rows] = ring["v"]
            h = y[:, 0]
            if sidx == s_count - 1:
                outs[mb] += h
        if p < 2 * s_count - 2:
            # the pairs that carry a microbatch this phase
            perm = [(s, s + 1) for s in range(s_count - 1)
                    if 0 <= p - s < s_count]
            recv = ppermute(mesh, pp.pp_axis, h, perm)
    y_all = psum(mesh, pp.pp_axis, outs)
    return y_all.reshape(b, 1, d), {"k": k_stack, "v": v_stack}
