"""K2: dequant-in-matvec for stacked block-quantized weights, and the
stacked matmul dispatch.

Counterpart of ``moshi_tpu/quant/pallas_matmul.py``
(``qmatmul_pallas_stacked``, f32-dequant branch): the activation rows
(optionally rms-normed with ``alpha[layer]``) are cast to bf16, each
weight element is dequantized and rounded to bf16 (q4_0: (q - 8) * d;
q4_k: q * es, with the mins folded in as - sum_b xs[b] * em[b] over the
f32 block sums xs; q8_0: q * d), and the products are summed in f32.

``qmatmul_stacked`` / ``glu_matmul_stacked`` route as the JAX package's
``_int8_dispatch`` does: one activation row with an int8-eligible weight
goes to the int8 matvec (K1), everything else to the dequant matvec.

On a CUDA tensor ``dequant_matvec`` launches ``csrc/dequant_matvec.cu``
(and raises if it cannot); on a CPU tensor it runs
``dequant_matvec_plain``.
"""

from __future__ import annotations

import torch

from moshi_tpu_torch.kernels import build
from moshi_tpu_torch.quant.formats import (QK, QuantTensor, _unpack_nibbles,
                                           int8_shape_ok, layout_ok,
                                           rms_pre_norm)
from moshi_tpu_torch.quant.matmul_int8 import (_ACT, _FMT_CODE,
                                               _check_operand, _num_layers,
                                               glu_matmul_i8, layer_rows,
                                               qmatmul_i8)

MAX_ROWS = 8   # activation rows one dequant-matvec launch takes


def qmatmul_stacked(x: torch.Tensor, qt: QuantTensor, layer=None,
                    alpha=None) -> torch.Tensor:
    """y = x @ W[layer].T (rms pre-norm with ``alpha`` fused): x [..., K]
    -> [..., O] f32."""
    m = x.numel() // x.shape[-1]
    if int8_shape_ok(qt, m):
        return qmatmul_i8(x, qt, layer=layer, alpha=alpha)
    return dequant_matvec(x, qt, layer=layer, alpha=alpha)


def glu_matmul_stacked(x: torch.Tensor, qt: QuantTensor, layer=None,
                       alpha=None) -> torch.Tensor:
    """silu(x @ Wg[layer].T) * (x @ Wv[layer].T) for a fused linear_in
    [.., 2H, K] -> [..., H] f32."""
    m = x.numel() // x.shape[-1]
    if qt.q.shape[-2] % 2 == 0 and int8_shape_ok(qt, m):
        return glu_matmul_i8(x, qt, layer=layer, alpha=alpha)
    gh = dequant_matvec(x, qt, layer=layer, alpha=alpha)
    gate, value = torch.chunk(gh, 2, dim=-1)
    return torch.nn.functional.silu(gate) * value


def dequant_matvec(x: torch.Tensor, qt: QuantTensor, layer=None,
                   alpha=None) -> torch.Tensor:
    """(rms_norm(x) * alpha[layer] if alpha is given else x) @ W[layer].T
    with W dequantized to bf16 on the fly.  x [..., K] -> [..., O] f32."""
    k = qt.shape[-1]
    if x.shape[-1] != k:
        raise ValueError(f"activation width {x.shape[-1]} != weight K {k}")
    if not layout_ok(qt):
        raise ValueError(f"dequant matvec cannot take {qt.fmt} with "
                         f"q columns {qt.q.shape[-1]}")
    x2 = x.reshape(-1, k).contiguous()
    lyr = 0 if layer is None else int(layer)
    if not 0 <= lyr < _num_layers(qt):
        raise IndexError(f"layer {lyr} of {_num_layers(qt)}")
    a = None if alpha is None else alpha.reshape(-1, k)[lyr]
    qt = qt.with_eff_scales()
    if x2.is_cuda:
        y = _launch(x2, qt, lyr, a)
    else:
        y = dequant_matvec_plain(x2, qt, lyr, a)
    return y.reshape(tuple(x.shape[:-1]) + (qt.q.shape[-2],))


def dequantize_layer_bf16(qt: QuantTensor, layer: int) -> torch.Tensor:
    """One layer's weight [O, K] as the kernel forms it: each element
    dequantized in f32 and rounded to bf16 (the q4_k mins excluded)."""
    rows = qt.q.shape[-2]
    q = layer_rows(qt.q, rows, layer)
    if qt.fmt == "q8_0":
        w = q.float() * torch.repeat_interleave(
            layer_rows(qt.d, rows, layer).float(), QK, dim=-1)
    elif qt.fmt == "q4_0":
        w = (_unpack_nibbles(q).float() - 8.0) * torch.repeat_interleave(
            layer_rows(qt.d, rows, layer).float(), QK, dim=-1)
    elif qt.fmt == "q4_k":
        w = _unpack_nibbles(q).float() * torch.repeat_interleave(
            layer_rows(qt.es, rows, layer).float(), QK, dim=-1)
    else:
        raise ValueError(f"unsupported quant format {qt.fmt!r}")
    return w.to(torch.bfloat16)


def dequant_matvec_plain(x: torch.Tensor, qt: QuantTensor, layer: int,
                         alpha=None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: x [m, K] -> [m, O] f32."""
    xn = x.float() if alpha is None else rms_pre_norm(x, alpha)
    w = dequantize_layer_bf16(qt, layer).float()
    y = torch.matmul(xn.to(torch.bfloat16).float(), w.T)
    if qt.fmt == "q4_k":
        xs = xn.reshape(xn.shape[0], -1, QK).sum(dim=-1)
        em = layer_rows(qt.em, qt.q.shape[-2], layer).float()
        y = y - torch.matmul(xs, em.T)
    return y


def _launch(x, qt, layer, alpha):
    dev = x.device
    m, k = x.shape
    if m > MAX_ROWS:
        raise ValueError(f"dequant matvec takes at most {MAX_ROWS} rows, "
                         f"got {m}")
    _check_operand(x, "x", _ACT, dev)
    if alpha is not None:
        _check_operand(alpha, "alpha", _ACT, dev)
    qdt = (torch.int8,) if qt.fmt == "q8_0" else (torch.uint8,)
    _check_operand(qt.q, "q", qdt, dev)
    s1 = qt.es if qt.fmt == "q4_k" else qt.d
    s2 = qt.em if qt.fmt == "q4_k" else None
    for name, s in (("scale", s1), ("min", s2)):
        if s is not None:
            _check_operand(s, name, (torch.bfloat16,), dev)
    o = qt.q.shape[-2]
    y = torch.empty((m, o), dtype=torch.float32, device=dev)
    fn = build.entry("dequant_matvec", "mt_dequant_matvec", [
        build.VP, build.I32, build.VP, build.I32, build.I32, build.I32,
        build.VP, build.VP, build.VP, build.VP, build.I32, build.I64,
        build.I32, build.VP])
    err = fn(build.ptr(x), int(x.dtype == torch.bfloat16),
             None if alpha is None else build.ptr(alpha),
             int(alpha is not None and alpha.dtype == torch.bfloat16), m, k,
             build.ptr(qt.q), build.ptr(s1),
             None if s2 is None else build.ptr(s2), build.ptr(y), o,
             layer * o, _FMT_CODE[qt.fmt], build.stream_of(x))
    build.check(err, "dequant_matvec", f"dequant matvec {qt.fmt} K={k} O={o}")
    build.COUNTS["dequant_matvec"] += 1
    return y
