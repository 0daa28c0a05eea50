"""Replay-style divergence localization (the reference's replay.h /
replay_ops.h, replay.h:332-385).

Counterpart of ``moshi_tpu/utils/replay.py``:

  * ``first_divergence``: walk two traces in recorded execution order
    (``TraceRecorder.order``) and name the first tap beyond tolerance; in
    the stacked layer loop the occurrence index is the layer, so a failure
    reads ("lm/temporal/qkv", 7, err).
  * ``stacked_layer_ops`` + ``replay_ops``: re-execute each quantized
    projection of the stacked decode (and, given the temporal config and
    the ring taps, each layer's attention) from its recorded input and
    compare with the recorded output.  This tells a kernel's numerics
    apart from the state it was given.
  * ``seanet_ops``: each SEANet streaming conv re-run from its recorded
    input and carry state.

The JAX module picks its backend with ``enable_pallas``; here the backend
is the device of the weights.  On the card each op runs on its kernel: K1
for qkv, out_proj, the GLU's product and linear_out, K3 for the attention.
On the CPU each runs its kernel's plain version.  As in the JAX module the
GLU op is one product and then silu(gate) * value, not the fused GLU
kernel.  ``xla_ring_attention`` (the JAX module's name for it) is a plain
f32 oracle of the ring attention, taken with ``oracle=True``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from moshi_tpu_torch.quant.formats import QuantTensor, qmatmul
from moshi_tpu_torch.utils.capture import TOL_CPU


def _rel_err(g: np.ndarray, t: np.ndarray) -> float:
    g64 = np.asarray(g, np.float64)
    t64 = np.asarray(t, np.float64)
    denom = max(np.abs(g64).max(), 1e-8)
    return float(np.abs(g64 - t64).max() / denom)


def first_divergence(golden_rec, test_rec, tol: float = TOL_CPU
                     ) -> Optional[Tuple[str, int, float]]:
    """Walk both recorders in golden's execution order; return (tap name,
    occurrence index, relative error) of the first tap beyond ``tol``, or
    None if every tap matches.  In the layer loop the occurrence index is
    the layer."""
    for name, i in golden_rec.order:
        g = golden_rec.values[name][i]
        tvals = test_rec.values.get(name, [])
        if i >= len(tvals):
            return (name, i, float("inf"))
        t = tvals[i]
        if g.shape != t.shape:
            return (name, i, float("inf"))
        err = _rel_err(g, t)
        if err > tol:
            return (name, i, err)
    return None


# ---------------------------------------------------------------------------
# per-op re-execution of the stacked quantized layer chain
# ---------------------------------------------------------------------------

def qt_layer(qt: QuantTensor, layer: int) -> QuantTensor:
    """Layer ``layer`` of a stacked QuantTensor (a view of every
    component's leading axis)."""
    return qt._map(lambda a: a[layer], tuple(qt.shape[-2:]))


def xla_ring_attention(q, ring_k, ring_v, cur_k, cur_v, offset, *,
                       cap: int, context: int):
    """Plain f32 oracle of one layer's decode ring attention (the JAX
    module's non-Pallas backend): the current token seeds position
    ``offset``; ring slot j holds position last - delta, delta = (last - j)
    mod cap with last = offset - 1, valid iff delta < context - 1 and the
    position is >= 0.  q/cur_k/cur_v [B, H, hd]; ring_k/ring_v [B, cap, H,
    hd] before the write; offset [B].  Returns [B, H, hd] f32."""
    b, h, hd = q.shape
    scale = hd ** -0.5
    qf = q.float()
    s_ring = torch.einsum("bhd,bjhd->bjh", qf, ring_k.float()) * scale
    last = offset.long() - 1
    r = torch.remainder(last, cap)
    j = torch.arange(cap, device=q.device)
    delta = torch.remainder(r[:, None] - j[None, :], cap)
    valid = (delta < context - 1) & (last[:, None] - delta >= 0)
    s_ring = torch.where(valid[:, :, None], s_ring,
                         torch.full_like(s_ring, -1e9))
    s_cur = (qf * cur_k.float()).sum(-1) * scale                  # [B, H]
    s = torch.cat([s_cur[:, None, :], s_ring], dim=1)
    p = torch.softmax(s, dim=1)
    vv = torch.cat([cur_v.float()[:, None], ring_v.float()], dim=1)
    return torch.einsum("bjh,bjhd->bhd", p, vv)


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _from_trace(a, device) -> torch.Tensor:
    """A recorded value as a tensor on ``device``; a JAX package trace's
    bf16 or fp8 arrays are widened to f32 (exact), as the port's are."""
    a = np.asarray(a)
    if a.dtype.name in ("bfloat16", "float8_e4m3fn"):
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def stacked_layer_ops(params, trace: Dict[str, List[np.ndarray]],
                      tap: str = "lm/temporal", cfg=None, oracle=False
                      ) -> List[Tuple[str, Callable[[], np.ndarray],
                                      np.ndarray]]:
    """The stacked temporal decode's re-executable ops from a recorded
    trace: [(op label, recompute fn, golden output)], for the last
    recorded frame.  Each fn re-runs one quantized projection from its
    recorded input through ``quant/formats.py`` ``qmatmul`` on the weights'
    device (K1 on the card, its plain version on the CPU).  With ``cfg``
    (the temporal TransformerConfig) and the ring taps, each layer also
    gets an ``attn`` op from the recorded rings: K3 (or its plain version
    on the CPU), or with ``oracle`` the f32 ``xla_ring_attention``."""
    if "layers" not in params and "transformer" in params:
        params = params["transformer"]     # a whole LM tree
    lay = params["layers"]
    in_w = lay["self_attn"]["in_proj"]["weight"]
    out_w = lay["self_attn"]["out_proj"]["weight"]
    glu_w = lay["gating"]["linear_in"]["weight"]
    lout_w = lay["gating"]["linear_out"]["weight"]
    n1 = lay["norm1"]["alpha"]
    n2 = lay["norm2"]["alpha"]
    num_layers = in_w.q.shape[0]
    dev = in_w.q.device

    def need(name):
        key = f"{tap}/{name}"
        if key not in trace or len(trace[key]) < num_layers:
            raise KeyError(
                f"trace lacks per-layer tap {key!r} (record with a "
                f"TraceRecorder active so the deep taps are emitted)")
        return [_from_trace(a, dev) for a in trace[key][-num_layers:]]

    # the last recorded frame: the trailing num_layers occurrences
    x_in = need("x_in")
    qkv_g = need("qkv")
    attn_ctx = need("attn_ctx")
    attn_out = need("attn_out")
    ffn_in = need("ffn_in")
    glu_g = need("glu_out")
    layer_out = need("layer_out")

    ring_key = f"{tap}/ring_k"
    with_attn = cfg is not None and ring_key in trace
    if with_attn:
        def last(name):
            return _from_trace(trace[f"{tap}/{name}"][-1], dev)
        ring_k = last("ring_k").to(torch.bfloat16)     # exact: bf16 or fp8
        ring_v = last("ring_v").to(torch.bfloat16)
        offset = last("offset").to(torch.int32)
        b, h, hd = ring_k.shape[1], ring_k.shape[3], cfg.mha.head_dim

    def mk_attn(l):
        def f():
            from moshi_tpu_torch.nn.decode_attention import \
                decode_attention_stacked
            from moshi_tpu_torch.nn.rope import apply_rope, rope_angles
            qkv = qkv_g[l]                                    # [B, 3dl]
            dl = qkv.shape[-1] // 3
            if cfg.mha.rope_max_period:
                cos_sin = rope_angles(offset[:, None], hd,
                                      cfg.mha.rope_max_period)
                qk = apply_rope(qkv[:, :2 * dl].reshape(b, 1, 2 * h, hd),
                                cos_sin=cos_sin)
                q, k_new = qk[:, 0, :h], qk[:, 0, h:]
            else:
                q = qkv[:, :dl].reshape(b, h, hd)
                k_new = qkv[:, dl:2 * dl].reshape(b, h, hd)
            v_new = qkv[:, 2 * dl:].reshape(b, h, hd)
            q, k_new, v_new = (t.to(torch.bfloat16).contiguous()
                               for t in (q, k_new, v_new))
            if oracle:
                out = xla_ring_attention(q, ring_k[l], ring_v[l], k_new,
                                         v_new, offset, cap=cfg.mha.cap,
                                         context=cfg.context)
            else:
                out = decode_attention_stacked(
                    q, ring_k, ring_v, k_new, v_new, offset, l,
                    cap=cfg.mha.cap, context=cfg.context)
            return _as_numpy(out.reshape(b, dl).to(torch.bfloat16))
        return f

    def mk_qkv(l):
        return lambda: _as_numpy(qmatmul(x_in[l], qt_layer(in_w, l),
                                         pre_norm_alpha=n1[l]))

    def mk_o(l):
        return lambda: _as_numpy(qmatmul(attn_ctx[l].to(torch.bfloat16),
                                         qt_layer(out_w, l)))

    def mk_glu(l):
        def f():
            gh = qmatmul(ffn_in[l], qt_layer(glu_w, l), pre_norm_alpha=n2[l])
            gate, value = torch.chunk(gh, 2, dim=-1)
            return _as_numpy(torch.nn.functional.silu(gate) * value)
        return f

    def mk_ffn(l):
        def f():
            y = qmatmul(glu_g[l].to(torch.bfloat16), qt_layer(lout_w, l))
            return _as_numpy(ffn_in[l].float() + y)
        return f

    ops = []
    for l in range(num_layers):
        ops.append((f"layer{l}/qkv", mk_qkv(l), _as_numpy(qkv_g[l])))
        if with_attn:
            ops.append((f"layer{l}/attn", mk_attn(l),
                        _as_numpy(attn_ctx[l])))
        ops.append((f"layer{l}/attn_out(o_proj)", mk_o(l),
                    _as_numpy(attn_out[l])))
        ops.append((f"layer{l}/glu", mk_glu(l), _as_numpy(glu_g[l])))
        ops.append((f"layer{l}/ffn+res", mk_ffn(l), _as_numpy(layer_out[l])))
    return ops


# ---------------------------------------------------------------------------
# per-op re-execution of SEANet streaming convs (encoder or decoder)
# ---------------------------------------------------------------------------

def seanet_ops(net, params, trace: Dict[str, List[np.ndarray]], tap: str
               ) -> List[Tuple[str, Callable[[], np.ndarray], np.ndarray]]:
    """A SEANetEncoder/Decoder trace recorded with ``tap``: each streaming
    conv re-run from its recorded input and carry state (``{tap}/<mod>:in``,
    ``{tap}/<mod>:prev|partial``) on the weights' device and in their dtype
    (Mimi's activations take its weights' dtype), with cuDNN's TF32 off as
    Mimi runs them, and compared with its recorded output (replay.h:332-385's
    per-op replay of convs)."""
    from moshi_tpu_torch.nn.conv import full_f32_convs

    ops = []
    for name, m in net.modules.items():
        key_in = f"{tap}/{name}:in"
        if key_in not in trace:
            continue
        w = params[name]["weight"]
        dt = w.dtype
        state_keys = list(m.init_state(1, dt, "cpu"))

        def tensor(key, occ, dt=dt, dev=w.device):
            return _from_trace(trace[key][occ], dev).to(dt)

        for occ in range(len(trace[key_in])):
            def mk(name=name, m=m, occ=occ, state_keys=state_keys,
                   tensor=tensor):
                def f():
                    h = tensor(f"{tap}/{name}:in", occ)
                    st = {sk: tensor(f"{tap}/{name}:{sk}", occ)
                          for sk in state_keys}
                    with full_f32_convs():
                        y, _ = m(params[name], st, h)
                    return _as_numpy(y)
                return f
            ops.append((f"{name}@{occ}", mk(),
                        np.asarray(trace[f"{tap}/{name}"][occ], np.float32)))
    return ops


def replay_ops(ops: Sequence[Tuple[str, Callable[[], np.ndarray],
                                   np.ndarray]],
               tol: float = TOL_CPU):
    """Re-execute each recorded op alone and compare with its golden
    output (replay.h:360-385).  Returns (first_fail | None, report lines);
    first_fail = (op label, relative error)."""
    lines = []
    first = None
    for label, fn, golden in ops:
        out = fn()
        if out.shape != golden.shape:
            err = float("inf")
        else:
            err = _rel_err(golden, out)
        status = "OK" if err <= tol else "FAIL"
        lines.append(f"{status} {label}: rel {err:.3e}")
        if status == "FAIL" and first is None:
            first = (label, err)
    return first, lines
