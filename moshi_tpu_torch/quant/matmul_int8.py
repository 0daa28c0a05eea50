"""K1: int8-activation matvec for q4_k / q4_0 / q8_0 weights (1 to 8 rows).

Counterpart of ``moshi_tpu/quant/pallas_matmul_int8.py`` (``qmatmul_i8``,
``glu_matmul_i8``).  Each activation row, optionally rms-normed with
``alpha[layer]``, is quantized on its own per 32-block to int8 (dx = amax *
f32(1/127), 1 when amax is 0; xq = round-half-even(x/dx); xs = dx *
sum(xq) of the quantized values); each weight row is contracted with xq in
integers per block and the block scales are applied in f32.  The GLU form reads gate row o and
value row o + H of the fused [2H, K] weight and returns silu(g) * v.

A 4-bit weight may hold its values as natural-order int8
(``QuantTensor.with_i8_storage``, one activation row only, as the JAX
package's ``_mk_kernel(..., packed=False)``): the integer dots are the
same, so q4_k's epilogue is unchanged, and q4_0's loses its -8 * xs term
(the zero point is in the values): y[o] = sum_b d * dx * P.

On a CUDA tensor the wrapper launches ``csrc/int8_matvec.cu``, one launch
a call (and raises if it cannot; count ``int8_matvec``, or
``int8_matvec_i8`` on unpacked storage); on a CPU tensor it runs
``int8_matvec_plain``, the same
arithmetic in PyTorch, which the CPU tests hold against the Pallas
kernel and ``chip_smoke.py`` holds the CUDA kernel against.

K12: the JAX package's two opt-in forms of the one-row q4_k matvec over a
wide K (``kseg_ok`` / ``split_ok``: packed q4_k, m = 1, no GLU, more than
128 blocks, K/2 a multiple of 512; the 7B temporal linear_out).  Under
``MOSHI_TPU_KSEG=1`` (checked first, as in the JAX package) such a call
takes the k-segment form, under ``MOSHI_TPU_SPLIT_SPREAD=1`` the
split-spread form; both knobs are read at each call.  Both compute K1's
function: the TPU kernels lay the blocks' terms out on lanes in one
order (``kseg_index``: segment s, packed columns
[s*2048, (s+1)*2048), holds lo blocks s*64 + j on lanes s*128 + j and the
hi blocks K/64 + s*64 + j on lanes s*128 + 64 + j; pad lanes add 0) and
sum them in their own order: per segment, then the segments in order
into 0 (k-segment), or all lanes at once (split-spread).  On a CUDA
tensor they launch ``csrc/split_matvec.cu``, one launch a call (counts
``int8_kseg`` and ``int8_split``); on a CPU tensor they run
``int8_matvec_kseg_plain`` and ``int8_matvec_split_plain``.
"""

from __future__ import annotations

import os

import torch

from moshi_tpu_torch.kernels import build
from moshi_tpu_torch.quant.formats import (QK, QuantTensor, _unpack_nibbles,
                                           i8_storage)

_FMT_CODE = {"q4_k": 0, "q4_0": 1, "q8_0": 2}

# The block scale is amax times the f32 reciprocal of 127, not amax / 127:
# XLA rewrites the JAX kernel's division by the constant into that product.
# The two differ in the last bit for about 5% of amax values, and for bf16
# activations x/dx then often lands on the other side of a .5 tie, which
# moves the output by about 1e-3 of its largest value.
INV127 = 1.0 / 127.0

MAX_ROWS = 8    # the JAX kernel's m <= 8 (int8_shape_ok)


def qmatmul_i8(x: torch.Tensor, qt: QuantTensor, layer=None,
               alpha=None) -> torch.Tensor:
    """y = (rms_norm(x) * alpha[layer] if alpha is given else x) @
    W[layer].T.  x [..., K] holding 1 to 8 rows -> [..., O] f32.
    ``layer`` indexes the flattened leading axes of a stacked weight
    (None for a flat one); ``alpha`` is [K] or [layers, K]."""
    return _qmatmul_i8(x, qt, layer, alpha, glu=False)


def glu_matmul_i8(x: torch.Tensor, qt: QuantTensor, layer=None,
                  alpha=None) -> torch.Tensor:
    """silu(x @ Wg[layer].T) * (x @ Wv[layer].T) for a fused linear_in
    [.., 2H, K] (gate rows [0, H), value rows [H, 2H)) -> [..., H] f32."""
    return _qmatmul_i8(x, qt, layer, alpha, glu=True)


def layer_rows(a: torch.Tensor, rows: int, layer: int) -> torch.Tensor:
    """Rows of one layer of a stacked component [..., rows, cols]."""
    return a.reshape(-1, rows, a.shape[-1])[layer]


def _num_layers(qt: QuantTensor) -> int:
    return qt.q.numel() // (qt.q.shape[-2] * qt.q.shape[-1])


def _qmatmul_i8(x, qt, layer, alpha, *, glu):
    k = qt.shape[-1]
    if x.shape[-1] != k:
        raise ValueError(f"activation width {x.shape[-1]} != weight K {k}")
    x2 = x.reshape(-1, k).contiguous()
    if not 1 <= x2.shape[0] <= MAX_ROWS:
        raise ValueError(f"the int8 matvec takes 1 to {MAX_ROWS} activation "
                         f"rows, got {x2.shape[0]}")
    if qt.fmt not in _FMT_CODE or k % QK or (k // QK) % 8:
        raise ValueError(f"int8 matvec cannot take {qt.fmt} with K={k}")
    if x2.shape[0] > 1 and i8_storage(qt):
        raise ValueError(f"the int8 matvec takes unpacked {qt.fmt} storage "
                         f"at one activation row, got {x2.shape[0]}")
    o_full = qt.q.shape[-2]
    if glu and o_full % 2:
        raise ValueError(f"GLU weight needs an even row count, got {o_full}")
    o = o_full // 2 if glu else o_full
    lyr = 0 if layer is None else int(layer)
    if not 0 <= lyr < _num_layers(qt):
        raise IndexError(f"layer {lyr} of {_num_layers(qt)}")
    a = None if alpha is None else alpha.reshape(-1, k)[lyr]
    qt = qt.with_eff_scales()
    m = x2.shape[0]
    form = ("kseg" if kseg_enabled() and kseg_ok(qt, m, glu) else
            "split" if split_spread_enabled() and split_ok(qt, m, glu) else
            None)
    if form is not None and x2.is_cuda:
        y = _launch_split(x2, qt, lyr, a, o, form)
    elif form is not None:
        plain = (int8_matvec_kseg_plain if form == "kseg" else
                 int8_matvec_split_plain)
        y = plain(x2, qt, lyr, a)
    elif x2.is_cuda:
        y = _launch(x2, qt, lyr, a, glu, o)
    else:
        y = int8_matvec_plain(x2, qt, lyr, a, glu)
    return y.reshape(tuple(x.shape[:-1]) + (o,))


SEG_COLS = 2048     # packed columns per segment: 64 lo + 64 hi blocks
_UNPACK_CHUNK = 512


def kseg_enabled() -> bool:
    return os.environ.get("MOSHI_TPU_KSEG", "0") == "1"


def split_spread_enabled() -> bool:
    return os.environ.get("MOSHI_TPU_SPLIT_SPREAD", "0") == "1"


def kseg_ok(qt: QuantTensor, m: int, glu: bool) -> bool:
    """The JAX package's ``_kseg_ok``: packed q4_k, one row, no GLU, more
    than 128 blocks and K/2 a multiple of 512."""
    if glu or m != 1 or qt.fmt != "q4_k" or qt.q.dtype != torch.uint8:
        return False
    k = qt.shape[-1]
    if k % QK:
        return False
    return k // QK > 128 and (k // 2) % _UNPACK_CHUNK == 0


def split_ok(qt: QuantTensor, m: int, glu: bool) -> bool:
    """The JAX package's ``_split_ok``: the same shapes as ``kseg_ok``."""
    return kseg_ok(qt, m, glu)


def kseg_nsegs(k: int) -> int:
    return -(-(k // 2) // SEG_COLS)


def kseg_index(k: int) -> torch.Tensor:
    """Lane -> block (-1 for a pad lane) of both forms' layout (the JAX
    package's ``_kseg_index`` and ``_pair_index``, one map): segment s's
    lanes [s*128, +64) are its lo blocks s*64 + j, lanes [+64, +128) the
    matching hi blocks half_nb + s*64 + j."""
    half_nb = (k // 2) // QK
    nsegs = kseg_nsegs(k)
    idx = torch.full((nsegs * 128,), -1, dtype=torch.long)
    for s in range(nsegs):
        for j in range(64):
            b = s * 64 + j
            if b < half_nb:
                idx[s * 128 + j] = b
                idx[s * 128 + 64 + j] = half_nb + b
    return idx


def _lane_terms(x, qt, layer, alpha):
    """K12's per-block terms es*(dx*P) - em*xs on the lanes of
    ``kseg_index`` [..., O, lanes], pad lanes 0."""
    k = qt.shape[-1]
    xq, dx, xs = quantize_activation(x, alpha)
    rows = qt.q.shape[-2]
    p = torch.einsum("obk,...bk->...ob", block_values(qt, layer), xq)
    es = layer_rows(qt.es, rows, layer).float()
    em = layer_rows(qt.em, rows, layer).float()
    terms = es * (p * dx[..., None, :]) - em * xs[..., None, :]
    idx = kseg_index(k).to(terms.device)
    lanes = terms[..., idx.clamp(min=0)]
    return torch.where(idx >= 0, lanes, torch.zeros_like(lanes))


def int8_matvec_kseg_plain(x: torch.Tensor, qt: QuantTensor, layer: int,
                           alpha=None) -> torch.Tensor:
    """The k-segment form in PyTorch: x [..., K] -> [..., O] f32, each
    segment's 128 lanes summed, then the segments added in order into
    0."""
    lanes = _lane_terms(x, qt, layer, alpha)
    y = torch.zeros(lanes.shape[:-1], dtype=torch.float32,
                    device=lanes.device)
    for s in range(lanes.shape[-1] // 128):
        y = y + lanes[..., s * 128:(s + 1) * 128].sum(dim=-1)
    return y


def int8_matvec_split_plain(x: torch.Tensor, qt: QuantTensor, layer: int,
                            alpha=None) -> torch.Tensor:
    """The split-spread form in PyTorch: one sum over every lane."""
    return _lane_terms(x, qt, layer, alpha).sum(dim=-1)


def block_values(qt: QuantTensor, layer: int) -> torch.Tensor:
    """One layer's integer weight values per 32-block, [O, K/32, 32] f32
    (4-bit values unsigned, from either storage): the operand of the
    plain versions' block dots, which are exact in any order."""
    rows, k = qt.q.shape[-2], qt.shape[-1]
    q = layer_rows(qt.q, rows, layer)
    w = q.to(torch.int8) if qt.unpacked else _unpack_nibbles(q)
    return w.reshape(rows, k // QK, QK).float()


def quantize_activation(x: torch.Tensor, alpha=None):
    """x [..., K] -> (xq [..., K/32, 32] integer-valued f32, dx [..., K/32],
    xs [..., K/32]), each row normed and quantized on its own."""
    xf = x.float()
    if alpha is not None:
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(ms + 1e-8) * alpha.float()
    blocks = xf.reshape(tuple(xf.shape[:-1]) + (-1, QK))
    amax = blocks.abs().amax(dim=-1)
    dx = torch.where(amax > 0, amax * INV127, torch.ones_like(amax))
    xq = torch.round(blocks / dx[..., None])
    xs = xq.sum(dim=-1) * dx
    return xq, dx, xs


def int8_matvec_plain(x: torch.Tensor, qt: QuantTensor, layer: int,
                      alpha=None, glu: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: x [..., K] -> [..., O] f32 (O =
    H for the GLU form), each row on its own.  Integer block dots are exact
    in f32 (|P| < 2^24), so a q4_k weight gives the same bits in either
    storage."""
    xq, dx, xs = quantize_activation(x, alpha)
    rows = qt.q.shape[-2]
    p = torch.einsum("obk,...bk->...ob", block_values(qt, layer), xq)
    dx, xs = dx[..., None, :], xs[..., None, :]     # broadcast over rows
    pf = p * dx
    if qt.fmt == "q4_k":
        es = layer_rows(qt.es, rows, layer).float()
        em = layer_rows(qt.em, rows, layer).float()
        y = torch.sum(es * pf - em * xs, dim=-1)
    elif qt.fmt == "q4_0" and not qt.unpacked:
        d = layer_rows(qt.d, rows, layer).float()
        y = torch.sum(d * (pf - 8.0 * xs), dim=-1)
    else:
        d = layer_rows(qt.d, rows, layer).float()
        y = torch.sum(d * pf, dim=-1)
    if glu:
        gate, val = y[..., : rows // 2], y[..., rows // 2:]
        y = gate * (1.0 / (1.0 + torch.exp(-gate))) * val
    return y


def _check_operand(t: torch.Tensor, name: str, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_ACT = (torch.float32, torch.bfloat16)


def _launch(x, qt, layer, alpha, glu, o, lib_name="int8_matvec"):
    """x [m, K]: one launch, which stages the activation rows in each
    block and reads each weight row once for all m rows.  ``lib_name``:
    the library (another checkout's, built beside this one, may be
    named)."""
    dev = x.device
    m, k = x.shape
    _check_operand(x, "x", _ACT, dev)
    if alpha is not None:
        _check_operand(alpha, "alpha", _ACT, dev)
    q, s1, s2, code = _weight_operands(qt, k, dev, "")
    y = torch.empty((m, o), dtype=torch.float32, device=dev)
    fn = build.entry(lib_name, "mt_int8_matvec", [
        build.VP, build.I32, build.VP, build.I32, build.I32, build.I32,
        build.VP, build.VP, build.VP, build.VP, build.I32, build.I64,
        build.I32, build.I32, build.VP])
    err = fn(build.ptr(x), int(x.dtype == torch.bfloat16),
             None if alpha is None else build.ptr(alpha),
             int(alpha is not None and alpha.dtype == torch.bfloat16), m, k,
             build.ptr(q), build.ptr(s1),
             None if s2 is None else build.ptr(s2), build.ptr(y), o,
             layer * qt.q.shape[-2], code, int(glu), build.stream_of(x))
    name = "int8_matvec_i8" if i8_storage(qt) else "int8_matvec"
    build.check(err, lib_name,
                f"int8 matvec {qt.fmt} ({name}) M={m} K={k} O={o}")
    build.COUNTS[name] += 1
    return y


def _weight_operands(qt, k: int, dev, what: str):
    """The checked (q, scale, min, C format code) of a weight for K1 and
    K5: q int8 (q8_0, and 4-bit unpacked storage, whose codes are 3 for
    q4_k and 4 for q4_0) or uint8 planar nibbles, es/em (q4_k) or d bf16."""
    unpacked = qt.unpacked
    _check_operand(qt.q, f"{what}q", (torch.int8,) if unpacked
                   else (torch.uint8,), dev)
    s1 = qt.es if qt.fmt == "q4_k" else qt.d
    s2 = qt.em if qt.fmt == "q4_k" else None
    for name, s in (("scale", s1), ("min", s2)):
        if s is not None:
            _check_operand(s, f"{what}{name}", (torch.bfloat16,), dev)
            if s.data_ptr() % 16:
                raise ValueError(f"{what}{name} must be 16-byte aligned "
                                 f"(the kernels copy it 16 bytes at a time)")
    if qt.q.shape[-1] != (k if unpacked else k // 2):
        raise ValueError(f"{what}{qt.fmt} q has {qt.q.shape[-1]} columns "
                         f"for K={k}")
    code = _FMT_CODE[qt.fmt] + (3 if i8_storage(qt) else 0)
    return qt.q, s1, s2, code


def _launch_split(x, qt, layer, alpha, o, form, lib_name="split_matvec"):
    """x [1, K]: one launch of K12 (``form`` "kseg" or "split"), which
    stages the activation in each block as K1 does.  ``lib_name``:
    the library (another checkout's, built beside this one, may be
    named)."""
    dev = x.device
    k = x.shape[1]
    _check_operand(x, "x", _ACT, dev)
    if alpha is not None:
        _check_operand(alpha, "alpha", _ACT, dev)
    q, es, em, code = _weight_operands(qt, k, dev, "")
    if code != _FMT_CODE["q4_k"]:
        raise ValueError(f"K12 takes packed q4_k weights, got {qt.fmt}"
                         + (" in unpacked storage" if qt.unpacked else ""))
    y = torch.empty((1, o), dtype=torch.float32, device=dev)
    name = "int8_kseg" if form == "kseg" else "int8_split"
    fn = build.entry(lib_name, f"mt_{name}", [
        build.VP, build.I32, build.VP, build.I32, build.I32, build.VP,
        build.VP, build.VP, build.VP, build.I32, build.I64, build.VP])
    err = fn(build.ptr(x), int(x.dtype == torch.bfloat16),
             None if alpha is None else build.ptr(alpha),
             int(alpha is not None and alpha.dtype == torch.bfloat16), k,
             build.ptr(q), build.ptr(es), build.ptr(em), build.ptr(y), o,
             layer * qt.q.shape[-2], build.stream_of(x))
    build.check(err, lib_name, f"{name} K={k} O={o}")
    build.COUNTS[name] += 1
    return y
