"""K5: attention out_proj + residual + rms-norm2 + GLU linear_in in one
launch (one activation row).

Counterpart of ``moshi_tpu/quant/pallas_fused.py`` (``attn_ffn_fused_i8``,
``can_fuse_mid``, ``fuse_mid_enabled``):

    o     = Wout[layer] . q8(attn)           (K1's int8 matvec, no norm)
    h_mid = f32(hcur) + o                    (kept in f32)
    n2    = rms_norm(h_mid) * alpha2[layer]
    g     = silu(Wg . q8(n2)) * (Wv . q8(n2))

where q8 is K1's per-32-block int8 activation quantization and the GLU
rows are gate [0, H) and value [H, 2H) of the layer's fused linear_in.
``h_mid`` never passes through bf16: the unfused stack rounds ``hh + o`` to
the carry's dtype before norm2, which for the depformer's bf16 carry is a
different function (the fused form is the JAX package's default).

Either weight may hold its 4-bit values in unpacked int8 storage
(``QuantTensor.with_i8_storage``), each on its own, as the JAX kernel
takes a packed flag per group; each half is then K1's arithmetic on that
storage.

On a CUDA tensor the wrapper launches ``csrc/attn_ffn_fused.cu`` (one
cooperative launch; raises if it cannot; count ``attn_ffn_fused``, or
``attn_ffn_fused_i8`` where a group is unpacked); on a CPU tensor it runs
``attn_ffn_fused_plain``, which is K1's plain arithmetic in the same
order.
"""

from __future__ import annotations

import os

import torch

from moshi_tpu_torch.kernels import build
from moshi_tpu_torch.quant.formats import (QuantTensor, i8_storage,
                                           int8_dispatch, int8_shape_ok)
from moshi_tpu_torch.quant.matmul_int8 import (_ACT, _check_operand,
                                               _num_layers, _weight_operands,
                                               int8_matvec_plain)

_TILE_O = 1024


def fuse_mid_enabled() -> bool:
    """On unless MOSHI_TPU_FUSE_MID is set to something other than "1"
    (the same switch and default as the JAX package)."""
    return os.environ.get("MOSHI_TPU_FUSE_MID", "1") == "1"


def _pick_tile(o: int) -> int:
    """The JAX package's output tile (pallas_matmul._pick_tile), kept for
    the eligibility rule below."""
    for t in (_TILE_O, 896, 768, 640, 512, 384, 256, 128):
        if t <= o and o % t == 0:
            return t
    return o


def can_fuse_mid(out_qt: QuantTensor, glu_qt: QuantTensor, m: int) -> bool:
    """Eligibility, rule for rule as the JAX package's: one activation
    row, both weights int8-matvec eligible, a square out_proj (its output
    feeds the same-width residual), a fused 2H-row GLU of the same K."""
    if m != 1:
        return False
    if not (int8_shape_ok(out_qt, m) and int8_shape_ok(glu_qt, m)):
        return False
    o, k = out_qt.shape[-2:]
    if o != k:
        return False
    if glu_qt.shape[-1] != k or glu_qt.shape[-2] % 2:
        return False
    h = glu_qt.shape[-2] // 2
    if h % _pick_tile(h) or k % _pick_tile(o):
        return False
    return True


def fuse_mid_ok(out_w, glu_w, m: int) -> bool:
    """Take the fused form for this layer stack?  The JAX package's rule:
    the switch on, both weights quantized, both products routed to the
    int8 kernels (``int8_dispatch``: MOSHI_TPU_INT8=0 turns the fusion off
    too) and ``can_fuse_mid``."""
    return (fuse_mid_enabled() and isinstance(out_w, QuantTensor)
            and isinstance(glu_w, QuantTensor)
            and int8_dispatch(out_w, m) and int8_dispatch(glu_w, m)
            and can_fuse_mid(out_w, glu_w, m))


def attn_ffn_fused_i8(attn: torch.Tensor, hcur: torch.Tensor,
                      out_qt: QuantTensor, glu_qt: QuantTensor, alpha2,
                      layer) -> tuple:
    """attn [..., K] (bf16) and hcur [..., K] (f32 or bf16), one row ->
    (g [..., H] f32, h_mid [..., K] f32).  ``layer`` indexes the flattened
    leading axes of both stacked weights; ``alpha2`` is [layers, K]."""
    k = out_qt.shape[-1]
    if not can_fuse_mid(out_qt, glu_qt, attn.numel() // attn.shape[-1]):
        raise ValueError(f"attn_ffn_fused_i8 cannot take {out_qt.fmt} "
                         f"{tuple(out_qt.shape)} / {glu_qt.fmt} "
                         f"{tuple(glu_qt.shape)} at this row count")
    if attn.shape[-1] != k or hcur.numel() != k:
        raise ValueError(f"attn {tuple(attn.shape)} / hcur "
                         f"{tuple(hcur.shape)} do not match K={k}")
    lyr = 0 if layer is None else int(layer)
    nl = _num_layers(out_qt)
    if not 0 <= lyr < nl or _num_layers(glu_qt) != nl:
        raise IndexError(f"layer {lyr} of {nl} (GLU stack "
                         f"{_num_layers(glu_qt)})")
    a = alpha2.reshape(-1, k)[lyr]
    out_qt, glu_qt = out_qt.with_eff_scales(), glu_qt.with_eff_scales()
    x = attn.reshape(k).contiguous()
    h = hcur.reshape(k).contiguous()
    if x.is_cuda:
        g, h_mid = _launch(x, h, out_qt, glu_qt, a.contiguous(), lyr)
    else:
        g, h_mid = attn_ffn_fused_plain(x, h, out_qt, glu_qt, a, lyr)
    lead = tuple(attn.shape[:-1])
    return g.reshape(lead + (g.shape[-1],)), h_mid.reshape(lead + (k,))


def attn_ffn_fused_plain(attn, hcur, out_qt: QuantTensor,
                         glu_qt: QuantTensor, alpha, layer: int):
    """The kernel's arithmetic in PyTorch: attn/hcur [K], ``alpha`` the
    layer's norm2 row [K] -> (g [H] f32, h_mid [K] f32)."""
    o = int8_matvec_plain(attn, out_qt, layer)
    h_mid = hcur.float() + o
    g = int8_matvec_plain(h_mid, glu_qt, layer, alpha, glu=True)
    return g, h_mid


def _launch(attn, hcur, out_qt, glu_qt, alpha, layer,
            lib_name="attn_ffn_fused"):
    """One launch of K5; ``lib_name``: the library (another checkout's,
    built beside this one, may be named)."""
    dev = attn.device
    k = out_qt.shape[-1]
    h = glu_qt.q.shape[-2] // 2
    _check_operand(attn, "attn", _ACT, dev)
    _check_operand(hcur, "hcur", _ACT, dev)
    _check_operand(alpha, "alpha", _ACT, dev)
    comps = [_weight_operands(qt, k, dev, f"{name} ")
             for name, qt in (("out_proj", out_qt), ("linear_in", glu_qt))]
    g = torch.empty(h, dtype=torch.float32, device=dev)
    h_mid = torch.empty(k, dtype=torch.float32, device=dev)
    fn = build.entry(lib_name, "mt_attn_ffn_fused", [
        build.VP, build.I32, build.VP, build.I32, build.VP, build.I32,
        build.I32, build.I32,
        build.VP, build.VP, build.VP, build.I32, build.I64,
        build.VP, build.VP, build.VP, build.I32, build.I64,
        build.VP, build.VP, build.VP])
    (oq, os1, os2, ofmt), (gq, gs1, gs2, gfmt) = comps
    err = fn(build.ptr(attn), int(attn.dtype == torch.bfloat16),
             build.ptr(hcur), int(hcur.dtype == torch.bfloat16),
             build.ptr(alpha),
             int(alpha.dtype == torch.bfloat16), k, h,
             build.ptr(oq), build.ptr(os1),
             None if os2 is None else build.ptr(os2), ofmt, layer * k,
             build.ptr(gq), build.ptr(gs1),
             None if gs2 is None else build.ptr(gs2), gfmt, layer * 2 * h,
             build.ptr(g), build.ptr(h_mid), build.stream_of(attn))
    name = ("attn_ffn_fused_i8" if i8_storage(out_qt) or i8_storage(glu_qt)
            else "attn_ffn_fused")
    build.check(err, lib_name,
                f"{name} {out_qt.fmt}/{glu_qt.fmt} K={k} H={h}")
    build.COUNTS[name] += 1
    return g, h_mid
