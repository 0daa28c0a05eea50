"""K2, K6, K7 and K8: the dequant matvecs for block-quantized weights, and
the matmul dispatch.

Counterpart of ``moshi_tpu/quant/pallas_matmul.py``'s f32-dequant kernels:
``qmatmul_pallas_stacked`` (K2, a layer of a stacked weight),
``qmatmul_pallas`` (K6, a flat weight), ``glu_matmul_pallas`` (K7, the
fused GLU of a flat linear_in) and ``glu_matmul_pallas_stacked`` (K8, the
fused GLU of a stacked linear_in).  The activation rows
(optionally rms-normed with ``alpha[layer]``) are cast to bf16, each
weight element is dequantized and rounded to bf16 (q4_0: (q - 8) * d;
q4_k: q * es, with the mins folded in as - sum_b xs[b] * em[b] over the
f32 block sums xs; q8_0: q * d), and the products are summed in f32.  K7
and K8 form the gate rows [0, H) and value rows [H, 2H) that way
and returns g * (1 / (1 + exp(-g))) * v in f32 (the Pallas kernel's
``_silu``).  Any number of activation rows.

``qmatmul_stacked`` and ``glu_matmul_stacked`` route as the JAX package
does (``_int8_dispatch``, ``glu_matmul_pallas_stacked``): rows that
``formats.int8_dispatch`` admits go to the int8 matvec (K1); otherwise
a projection takes K2, and a GLU takes K8 for q4_k and q8_0, and for q4_0
the two-call form, K2 over the 2H rows then ``silu(gate) * value`` (where
the JAX kernel returns None and its caller falls back).

On a CUDA tensor each wrapper launches its kernel (K2 and K6 from
``csrc/dequant_matvec.cu``, K7 and K8 from ``csrc/glu_matvec.cu``) and
raises if it cannot; on a CPU tensor it runs its plain version
(``dequant_matvec_plain``, ``qmatmul_plain``, ``glu_matmul_plain``,
``glu_matvec_plain``).  All four read packed nibbles and raise on a
weight in unpacked int8 storage (``formats.check_packed``), as the JAX
package's do.
"""

from __future__ import annotations

import torch

from moshi_tpu_torch.kernels import build
from moshi_tpu_torch.quant.formats import (QK, QuantTensor, _unpack_nibbles,
                                           check_packed, int8_dispatch,
                                           layout_ok, rms_pre_norm)
from moshi_tpu_torch.quant.matmul_int8 import (_ACT, _FMT_CODE,
                                               _check_operand, _num_layers,
                                               glu_matmul_i8, layer_rows,
                                               qmatmul_i8)

GLU_FORMATS = ("q4_k", "q8_0")     # K7's and K8's; q4_0 takes two calls

# (library, C entry, launch count) of each kernel
_K2 = ("dequant_matvec", "mt_dequant_matvec", "dequant_matvec")
_K6 = ("dequant_matvec", "mt_qmatmul", "qmatmul")
_K7 = ("glu_matvec", "mt_glu_matmul", "glu_matmul")
_K8 = ("glu_matvec", "mt_glu_matvec", "glu_matvec")


def qmatmul_stacked(x: torch.Tensor, qt: QuantTensor, layer=None,
                    alpha=None) -> torch.Tensor:
    """y = x @ W[layer].T (rms pre-norm with ``alpha`` fused): x [..., K]
    -> [..., O] f32."""
    m = x.numel() // x.shape[-1]
    if int8_dispatch(qt, m):
        return qmatmul_i8(x, qt, layer=layer, alpha=alpha)
    return dequant_matvec(x, qt, layer=layer, alpha=alpha)


def glu_matmul_stacked(x: torch.Tensor, qt: QuantTensor, layer=None,
                       alpha=None) -> torch.Tensor:
    """silu(x @ Wg[layer].T) * (x @ Wv[layer].T) for a fused linear_in
    [.., 2H, K] -> [..., H] f32."""
    m = x.numel() // x.shape[-1]
    if qt.q.shape[-2] % 2 == 0 and int8_dispatch(qt, m):
        return glu_matmul_i8(x, qt, layer=layer, alpha=alpha)
    if qt.fmt in GLU_FORMATS:
        return glu_matvec(x, qt, layer=layer, alpha=alpha)
    gh = dequant_matvec(x, qt, layer=layer, alpha=alpha)
    gate, value = torch.chunk(gh, 2, dim=-1)
    return torch.nn.functional.silu(gate) * value


def _operands(x, qt, layer, alpha):
    """The checked 2-D activation, layer index and norm row of a call."""
    k = qt.shape[-1]
    if x.shape[-1] != k:
        raise ValueError(f"activation width {x.shape[-1]} != weight K {k}")
    check_packed(qt)
    if not layout_ok(qt):
        raise ValueError(f"dequant matvec cannot take {qt.fmt} with "
                         f"q columns {qt.q.shape[-1]}")
    lyr = 0 if layer is None else int(layer)
    if not 0 <= lyr < _num_layers(qt):
        raise IndexError(f"layer {lyr} of {_num_layers(qt)}")
    a = None if alpha is None else alpha.reshape(-1, k)[lyr]
    return x.reshape(-1, k).contiguous(), lyr, a


def dequant_matvec(x: torch.Tensor, qt: QuantTensor, layer=None,
                   alpha=None) -> torch.Tensor:
    """K2: (rms_norm(x) * alpha[layer] if alpha is given else x) @
    W[layer].T with W dequantized to bf16 on the fly.  x [..., K] ->
    [..., O] f32."""
    x2, lyr, a = _operands(x, qt, layer, alpha)
    qt = qt.with_eff_scales()
    o = qt.q.shape[-2]
    if x2.is_cuda:
        y = _launch(_K2, x2, qt, a, o, lyr * o)
    else:
        y = dequant_matvec_plain(x2, qt, lyr, a)
    return y.reshape(tuple(x.shape[:-1]) + (o,))


def qmatmul_dequant(x: torch.Tensor, qt: QuantTensor,
                    alpha=None) -> torch.Tensor:
    """K6: (rms_norm(x) * alpha if alpha is given else x) @ W.T for a flat
    weight W [O, K].  x [..., K] -> [..., O] f32."""
    if qt.q.dim() != 2:
        raise ValueError(f"K6 takes a flat [O, K] weight, got q "
                         f"{tuple(qt.q.shape)}")
    x2, _, a = _operands(x, qt, None, alpha)
    qt = qt.with_eff_scales()
    o = qt.q.shape[0]
    if x2.is_cuda:
        y = _launch(_K6, x2, qt, a, o, None)
    else:
        y = qmatmul_plain(x2, qt, a)
    return y.reshape(tuple(x.shape[:-1]) + (o,))


def glu_matvec(x: torch.Tensor, qt: QuantTensor, layer=None,
               alpha=None) -> torch.Tensor:
    """K8: silu(g) * v with g, v = (rms_norm(x) * alpha[layer]) @
    Wg[layer].T, Wv[layer].T for a fused linear_in [.., 2H, K] in q4_k or
    q8_0.  x [..., K] -> [..., H] f32."""
    if qt.fmt not in GLU_FORMATS or qt.q.shape[-2] % 2:
        raise ValueError(f"K8 takes a {GLU_FORMATS} weight of 2H rows, got "
                         f"{qt.fmt} with {qt.q.shape[-2]} rows")
    x2, lyr, a = _operands(x, qt, layer, alpha)
    qt = qt.with_eff_scales()
    h = qt.q.shape[-2] // 2
    if x2.is_cuda:
        y = _launch(_K8, x2, qt, a, h, lyr * 2 * h)
    else:
        y = glu_matvec_plain(x2, qt, lyr, a)
    return y.reshape(tuple(x.shape[:-1]) + (h,))


def glu_matmul(x: torch.Tensor, qt: QuantTensor,
               alpha=None) -> torch.Tensor:
    """K7: silu(g) * v with g, v = (rms_norm(x) * alpha) @ Wg.T, Wv.T for
    a flat fused linear_in [2H, K] in q4_k or q8_0.  x [..., K] -> [..., H]
    f32."""
    if qt.q.dim() != 2:
        raise ValueError(f"K7 takes a flat [2H, K] weight, got q "
                         f"{tuple(qt.q.shape)}")
    if qt.fmt not in GLU_FORMATS or qt.q.shape[0] % 2:
        raise ValueError(f"K7 takes a {GLU_FORMATS} weight of 2H rows, got "
                         f"{qt.fmt} with {qt.q.shape[0]} rows")
    x2, _, a = _operands(x, qt, None, alpha)
    qt = qt.with_eff_scales()
    h = qt.q.shape[0] // 2
    if x2.is_cuda:
        y = _launch(_K7, x2, qt, a, h, None)
    else:
        y = glu_matmul_plain(x2, qt, a)
    return y.reshape(tuple(x.shape[:-1]) + (h,))


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


def dequantized_f32(qt: QuantTensor, layer: int) -> torch.Tensor:
    """``dequantize_layer_bf16``'s weight [O, K] widened to f32: the
    operand of the plain dequant products."""
    return dequantize_layer_bf16(qt, layer).float()


def _dequant_product(x: torch.Tensor, qt: QuantTensor, layer: int,
                     alpha=None) -> torch.Tensor:
    """The dequant matvecs' product in PyTorch: x [m, K] -> [m, O] f32."""
    xn = x.float() if alpha is None else rms_pre_norm(x, alpha)
    w = dequantized_f32(qt, layer)
    y = torch.matmul(xn.to(torch.bfloat16).float(), w.T)
    if qt.fmt == "q4_k":
        xs = xn.reshape(xn.shape[0], -1, QK).sum(dim=-1)
        em = layer_rows(qt.em, qt.q.shape[-2], layer).float()
        y = y - torch.matmul(xs, em.T)
    return y


def dequant_matvec_plain(x: torch.Tensor, qt: QuantTensor, layer: int,
                         alpha=None) -> torch.Tensor:
    """K2's arithmetic in PyTorch: x [m, K] -> [m, O] f32."""
    return _dequant_product(x, qt, layer, alpha)


def qmatmul_plain(x: torch.Tensor, qt: QuantTensor,
                  alpha=None) -> torch.Tensor:
    """K6's arithmetic: K2's on the flat weight (its only layer)."""
    return _dequant_product(x, qt, 0, alpha)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """The Pallas kernels' ``_silu``: x * (1 / (1 + exp(-x))), in f32."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def glu_matvec_plain(x: torch.Tensor, qt: QuantTensor, layer: int,
                     alpha=None) -> torch.Tensor:
    """K8's arithmetic in PyTorch: x [m, K] -> [m, H] f32."""
    gv = _dequant_product(x, qt, layer, alpha)
    h = gv.shape[-1] // 2
    return _silu(gv[:, :h]) * gv[:, h:]


def glu_matmul_plain(x: torch.Tensor, qt: QuantTensor,
                     alpha=None) -> torch.Tensor:
    """K7's arithmetic: K8's on the flat weight (its only layer)."""
    return glu_matvec_plain(x, qt, 0, alpha)


def _launch(kernel, x, qt, alpha, o, row0):
    """One launch of a dequant kernel (``_K2``, ``_K6``, ``_K7`` or
    ``_K8``): K2 and K8 take the first row of the layer (``row0``), K6 and
    K7 (``row0`` None) a flat weight; ``o`` is the output width."""
    lib, fn_name, count = kernel
    dev = x.device
    m, k = x.shape
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
    y = torch.empty((m, o), dtype=torch.float32, device=dev)
    args = [build.VP, build.I32, build.VP, build.I32, build.I32, build.I32,
            build.VP, build.VP, build.VP, build.VP, build.I32]
    vals = [build.ptr(x), int(x.dtype == torch.bfloat16),
            None if alpha is None else build.ptr(alpha),
            int(alpha is not None and alpha.dtype == torch.bfloat16), m, k,
            build.ptr(qt.q), build.ptr(s1),
            None if s2 is None else build.ptr(s2), build.ptr(y), o]
    if row0 is not None:
        args.append(build.I64)
        vals.append(row0)
    fn = build.entry(lib, fn_name, args + [build.I32, build.VP])
    err = fn(*vals, _FMT_CODE[qt.fmt], build.stream_of(x))
    build.check(err, lib, f"{count} {qt.fmt} M={m} K={k} O={o}")
    build.COUNTS[count] += 1
    return y
