"""Explicit tensor parallelism over the mesh's ``model`` axis.

Counterpart of ``moshi_tpu/parallel/tp.py``.  The JAX package runs the
stacked-kernel decode inside ``jax.shard_map`` with ``psum``; here every
rank is a process holding its own shards, and the frame's code runs the
shard-local function with the mesh's collectives (``parallel/mesh.py``)
in place of the shard_map.  The Megatron layout, with the weight shards of
block-quantized tensors self-contained:

* fused QKV / gating linear_in: rows laid out at shard time so that the
  contiguous shard s holds [q_s; k_s; v_s] (resp. [gate_s; value_s]) of its
  own heads (``_interleave_perm``; a row permutation, exact in every
  format, ``formats.qt_take_rows``);
* out_proj / linear_out: column (I-axis) shards repacked planar within
  each shard (``_tp_cols`` over ``formats.qt_slice_cols``), exact when I/S
  is block-aligned, requantized to the same bitwidth otherwise (q4_k to
  q4_0); a gating pair whose hidden width does not split into planar
  shards is zero-padded first (``_pad_gating_pair``, exact in function);
* per-codebook linears and the text head: contiguous row shards, their
  logits all-gathered before sampling;
* KV rings on the head axis, the session state on ``data``.

Per layer: x whole on every model rank -> local qkv -> local ring
attention -> column-shard out_proj partial + psum -> local GLU ->
column-shard linear_out partial + psum (two collectives a layer).  The
fused K5 form is off under TP: the psum lands between out_proj and the
residual.  Every rank of a model group samples the same gathered logits
from its own ``torch.Generator``; ranks given generators in the same state
stay in the same state and sample the same tokens.

Usage (on every rank):
    mesh = make_mesh(data=1, model=2)
    tp_params = tp_shard_lm_params(params, cfg, mesh)
    state = shard_tree(init_gen_state(cfg, B), lm_state_pspecs(...), mesh)
    with tp_scope(mesh):
        out, state = lm_gen_step(cfg, tp_params, state, ...)

The scope is read by ``nn/transformer.transformer_forward`` and
``models/lm`` (``temporal_forward``, ``depformer_generate``) at each call.
The layout transforms give the JAX package's arrays bit for bit; each
rank keeps its own shard of them.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import numpy as np
import torch

from moshi_tpu_torch.parallel.mesh import Mesh, all_gather
from moshi_tpu_torch.parallel.sharding import place
from moshi_tpu_torch.quant.formats import (QK, QK_K, QuantTensor, dequantize,
                                           qmatmul, qt_slice_cols,
                                           qt_take_rows, quantize)

_QT_FIELDS = ("q", "d", "sc", "mn", "dmin", "es", "em")


@dataclasses.dataclass(frozen=True)
class TPContext:
    mesh: Mesh
    model_axis: str = "model"
    data_axis: str = "data"

    @property
    def nshards(self) -> int:
        return self.mesh.shape[self.model_axis]


_TP_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "moshi_tpu_torch_tp", default=None)


def current_tp():
    return _TP_CTX.get()


@contextlib.contextmanager
def tp_scope(mesh: Mesh, model_axis: str = "model", data_axis: str = "data"):
    """Run the frames called within on the TP layout."""
    tok = _TP_CTX.set(TPContext(mesh, model_axis, data_axis))
    try:
        yield
    finally:
        _TP_CTX.reset(tok)


# ---------------------------------------------------------------------------
# shard-time weight layout (the JAX package's, array for array)
# ---------------------------------------------------------------------------


def _interleave_perm(total_rows: int, nsplit: int, s: int) -> np.ndarray:
    """Row permutation so that contiguous shard i of a fused
    [nsplit*D, ...] weight holds [split0_i; split1_i; ...]."""
    d = total_rows // nsplit
    per = d // s
    idx = []
    for i in range(s):
        for j in range(nsplit):
            start = j * d + i * per
            idx.extend(range(start, start + per))
    return np.asarray(idx)


def _stack(qts):
    return QuantTensor(qts[0].fmt, qts[0].shape, *(
        None if getattr(qts[0], f) is None else
        torch.stack([getattr(q, f) for q in qts]) for f in _QT_FIELDS))


def _tp_cols(qt: QuantTensor, s: int) -> QuantTensor:
    """Column-shard layout: each I/s-wide block a self-contained planar
    shard.  Exact when block-aligned; a uniform same-bitwidth
    requantization otherwise."""
    i = qt.shape[1]
    w = i // s
    if qt.fmt != "q8_0" and w < 2 * QK:
        # planar 4-bit kernels pair element e with e + I/2: a shard
        # narrower than 2*QK leaves an empty half
        raise ValueError(
            f"TP column shard width {w} too narrow for 4-bit planar "
            f"kernels (need >= {2 * QK}); use fewer model shards")
    block = QK_K if qt.fmt == "q4_k" else QK
    if w % block == 0:
        slices = [qt_slice_cols(qt, k * w, (k + 1) * w) for k in range(s)]
        qcat = torch.cat([sl.q for sl in slices], dim=-1)
        # the scales are untouched by the repack: no block crosses shards
        return dataclasses.replace(qt, q=qcat)
    if w % QK:
        raise ValueError(f"TP column shard width {w} not a {QK} multiple")
    fmt = "q4_0" if qt.fmt == "q4_k" else qt.fmt
    deq = dequantize(qt, torch.float32).cpu().numpy()
    lead = deq.shape[:-2]
    o = deq.shape[-2]
    flat = deq.reshape((-1, o, i))
    n = flat.shape[0]
    dev = qt.q.device
    shards = []
    for k in range(s):
        qts = [quantize(np.ascontiguousarray(flat[j, :, k * w:(k + 1) * w]),
                        fmt, device=dev) for j in range(n)]
        shards.append(_stack(qts) if n > 1 else qts[0])

    def cat(field):
        arrs = [getattr(p, field) for p in shards]
        if arrs[0] is None:
            return None
        c = torch.cat(arrs, dim=arrs[0].dim() + (-2 if field in ("sc", "mn")
                                                 else -1))
        return c.reshape(lead + tuple(c.shape[1:])) if lead and n > 1 else c
    return QuantTensor(fmt, qt.shape, *(cat(f) for f in _QT_FIELDS))


def _mode_for(path: str) -> str:
    if "in_proj" in path:
        return "fused3"
    if "linear_in" in path:
        return "fused2"
    if "out_proj" in path or "linear_out" in path:
        return "col"
    if "text_linear" in path or "linears" in path:
        return "row"
    return "repl"


def _component_spec(mode: str, field: str, ndim: int) -> tuple:
    parts = [None] * ndim
    if mode == "repl":
        return tuple(parts)
    if mode == "col":
        ax = ndim + (-2 if field in ("sc", "mn") else -1)
    else:  # row / fused*: the O axis
        ax = ndim + (-3 if field in ("sc", "mn") else -2)
    parts[ax] = "model"
    return tuple(parts)


def _qt_spec_tree(qt: QuantTensor, mode: str) -> QuantTensor:
    return QuantTensor(qt.fmt, qt.shape, *(
        None if getattr(qt, f) is None else
        _component_spec(mode, f, getattr(qt, f).dim()) for f in _QT_FIELDS))


def tp_specs(tree) -> dict:
    """The spec tree of a (sub)tree of LM params in the TP layout (paths
    decide row / col / fused / replicated): the JAX package's shard_map
    specs."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}.{k}") for k, v in node.items()}
        if isinstance(node, QuantTensor):
            return _qt_spec_tree(node, _mode_for(path))
        return (None,) * node.dim()
    return walk(tree, "")


def _requant(deq: np.ndarray, fmt: str, dev) -> QuantTensor:
    """``deq`` [..., O, I] quantized per matrix in ``fmt`` (q4_0 where the
    width does not take it)."""
    i = deq.shape[-1]
    f = fmt if i % (QK_K if fmt == "q4_k" else QK) == 0 else "q4_0"
    lead = deq.shape[:-2]
    if not lead:
        return quantize(deq, f, device=dev)
    flat = deq.reshape((-1,) + deq.shape[-2:])
    qts = [quantize(np.ascontiguousarray(flat[j]), f, device=dev)
           for j in range(flat.shape[0])]
    st = _stack(qts)
    return st._map(lambda a: a.reshape(lead + tuple(a.shape[1:])))


def _pad_gating_pair(lin_in: QuantTensor, lin_out: QuantTensor, s: int):
    """Zero-pad a (linear_in [2H, D], linear_out [O, H]) gating pair so
    that H/s is a planar-shardable width (a multiple of QK, >= 2*QK).
    Exact in function: the padded gate and value channels are zero, so
    silu(0) * 0 adds nothing, and linear_out's padded columns are zero
    (the 7B depformer's hidden 4224 at model 8: 528 is not a
    32-multiple).  A stacked pair keeps its leading axes (the JAX package
    returns them merged into one; the arrays are the same)."""
    h = lin_out.shape[1]
    w = h // s
    if w % QK == 0 and w >= 2 * QK and h % s == 0:
        return lin_in, lin_out
    w_pad = max(2 * QK, ((h + s - 1) // s + QK - 1) // QK * QK)
    h_pad = w_pad * s
    dev = lin_in.q.device
    din = dequantize(lin_in, torch.float32).cpu().numpy()
    gate, value = din[..., :h, :], din[..., h:2 * h, :]
    zrow = np.zeros(din.shape[:-2] + (h_pad - h, din.shape[-1]), din.dtype)
    din_p = np.concatenate([gate, zrow, value, zrow], axis=-2)
    dout = dequantize(lin_out, torch.float32).cpu().numpy()
    zcol = np.zeros(dout.shape[:-1] + (h_pad - h,), dout.dtype)
    dout_p = np.concatenate([dout, zcol], axis=-1)
    return (_requant(din_p, lin_in.fmt, dev),
            _requant(dout_p, lin_out.fmt, dev))


def tp_layout(params, cfg, s: int):
    """The whole LM param tree in the TP layout for ``s`` model shards
    (fused rows interleaved, columns repacked, gating pairs padded): the
    arrays the JAX package's ``tp_shard_lm_params`` places, before any
    rank takes its shard."""
    def walk(node, path):
        if isinstance(node, dict):
            if ("linear_in" in node and "linear_out" in node
                    and isinstance(node["linear_in"].get("weight"),
                                   QuantTensor)
                    and isinstance(node["linear_out"].get("weight"),
                                   QuantTensor)):
                li, lo = _pad_gating_pair(node["linear_in"]["weight"],
                                          node["linear_out"]["weight"], s)
                node = dict(node)
                node["linear_in"] = dict(node["linear_in"], weight=li)
                node["linear_out"] = dict(node["linear_out"], weight=lo)
            return {k: walk(v, f"{path}.{k}") for k, v in node.items()}
        if isinstance(node, QuantTensor):
            mode = _mode_for(path)
            if mode == "fused3":
                return qt_take_rows(node,
                                    _interleave_perm(node.q.shape[-2], 3, s))
            if mode == "fused2":
                return qt_take_rows(node,
                                    _interleave_perm(node.q.shape[-2], 2, s))
            if mode == "col":
                return _tp_cols(node, s)
        return node

    return walk(params, "")


def tp_shard_lm_params(params, cfg, mesh: Mesh):
    """This rank's shard of the LM param tree in the TP layout (every
    weight the layout leaves whole, whole), a plain tree: its frame runs
    under ``tp_scope``, never gathered (the laid-out rows and columns are
    not the weight's own order)."""
    laid = tp_layout(params, cfg, mesh.shape["model"])
    return place(laid, tp_specs(laid), mesh)[0]


def tp_row_logits(x, qt: QuantTensor, tp: TPContext):
    """x [B, T, D] @ this rank's row shard of the head -> the logits
    [B, T, O] all-gathered over ``model``."""
    y = qmatmul(x, qt, out_dtype=torch.float32)
    return all_gather(tp.mesh, tp.model_axis, y, dim=-1)
