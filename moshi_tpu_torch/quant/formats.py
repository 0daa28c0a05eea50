"""Block-quantized weights as PyTorch tensors.

Counterpart of ``moshi_tpu/quant/formats.py``: the same formats, field
names and planar layout, so a tree converted from the JAX package holds
the same bytes.

* q8_0: q int8 [O, I]; d bf16 [O, I/32]
* q4_0: q uint8 [O, I/2] planar nibbles (byte j holds w[j] low and
  w[j + I/2] high, unsigned, zero point 8); d bf16 [O, I/32]
* q4_k: q uint8 [O, I/2] planar; sc, mn uint8 [O, I/256, 8]; d, dmin bf16
  [O, I/256]; es = d*sc and em = dmin*mn as bf16 [O, I/32] for the kernels
* q8_r: q int8 [O, I]; d bf16 [O, 1], one scale per row (w8a8: ``qmatmul``
  quantizes the activation per token and takes an exact int8 x int8 ->
  int32 product, ``torch._int_mm``; no kernel of the port reads it)

``quantize`` makes a QuantTensor from a host array [O, I] with the JAX
package's numpy quantizers (their float order gives the reference's
bits), or, by default, with the native C++ quantizer
(``native_quant.py``), whose q4_k differs from numpy's within the format's
error and whose integer values differ at exact ties only.

A 4-bit weight may instead hold its values unpacked, as natural-order
int8 q [O, I] (``with_i8_storage``, ``i8_storage_tree``): q4_k values
0..15, q4_0 values signed with the -8 zero point folded in at rest.  Only
the int8 kernels at one activation row (K1, K5) and ``dequantize`` take
that storage; the dequant kernels raise on it (``storage_ok``).

Stacked weights carry leading axes in front of every component
([L, O, ...] or the depformer's [W, L, O, ...]); ``shape`` stays the
per-matrix (O, I).

``qmatmul`` routes a matmul: activation rows against a weight that
``int8_dispatch`` admits go to the int8 matvec (K1,
``quant/matmul_int8.py``), other quantized weights, which are flat [O, I],
to the flat dequant matvec (K6, ``quant/matmul.py``), as the JAX
package's ``qmatmul`` reaches ``qmatmul_pallas``, and plain tensors to
PyTorch's product, as the JAX
package leaves them to XLA: bf16 operands (the activation rounded to the
weight's bf16), exact products summed in f32.  On the card a bf16 matrix
takes ``dense_mm``, one cuBLAS call with bf16 operands and an f32 output,
which reads the weight once as it is stored; elsewhere (the CPU, other
dtypes, stacked weights) both operands are widened to f32 first, which
forms the same products but moves the weight three times more.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from moshi_tpu_torch.device import resolve_device

QK = 32        # sub-block size (q8_0 / q4_0 scale granularity)
QK_K = 256     # q4_k superblock size

QUANT_FORMATS = ("q8_0", "q4_0", "q4_k", "q8_r")

_FIELDS = ("q", "d", "sc", "mn", "dmin", "es", "em")


@dataclasses.dataclass
class QuantTensor:
    """A block-quantized weight [..., O, I] (see the module docstring)."""

    fmt: str
    shape: Tuple[int, int]
    q: torch.Tensor
    d: torch.Tensor
    sc: Optional[torch.Tensor] = None
    mn: Optional[torch.Tensor] = None
    dmin: Optional[torch.Tensor] = None
    es: Optional[torch.Tensor] = None
    em: Optional[torch.Tensor] = None

    def _map(self, fn, shape=None) -> "QuantTensor":
        comps = {f: None if getattr(self, f) is None else fn(getattr(self, f))
                 for f in _FIELDS}
        return QuantTensor(self.fmt, shape or self.shape, **comps)

    def to(self, device) -> "QuantTensor":
        return self._map(lambda a: a.to(device))

    def with_eff_scales(self) -> "QuantTensor":
        """A copy with es/em populated (q4_k only; no-op otherwise)."""
        if self.fmt != "q4_k" or self.es is not None:
            return self
        lead = self.q.shape[:-1]
        i = self.d.shape[-1] * QK_K
        es = (self.d.float()[..., None] * self.sc.float()).reshape(
            lead + (i // QK,))
        em = (self.dmin.float()[..., None] * self.mn.float()).reshape(
            lead + (i // QK,))
        return dataclasses.replace(self, es=es.to(torch.bfloat16),
                                   em=em.to(torch.bfloat16))

    @property
    def unpacked(self) -> bool:
        """Are the values natural-order int8 [..., O, I] (q8_0 always; a
        4-bit format after ``with_i8_storage``) rather than planar
        nibbles?"""
        return self.fmt == "q8_0" or self.q.dtype == torch.int8

    def with_i8_storage(self) -> "QuantTensor":
        """A copy with 4-bit values unpacked to natural-order int8, q4_0's
        zero point folded in (q - 8); a no-op for q8_0 and for storage
        already unpacked.  Twice the bytes of the packed values."""
        if self.unpacked:
            return self
        full = _unpack_nibbles(self.q).to(torch.int8)
        if self.fmt == "q4_0":
            full = full - 8
        return dataclasses.replace(self, q=full)

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.q, self.d, self.sc, self.mn, self.dmin)
                   if a is not None)


def i8_storage(qt: QuantTensor) -> bool:
    """A 4-bit weight whose values are unpacked int8 (``with_i8_storage``)."""
    return qt.fmt in ("q4_0", "q4_k") and qt.q.dtype != torch.uint8


def i8_storage_tree(tree, path=()):
    """The parameter tree with every 4-bit leaf that the int8 kernels take
    at one row (``int8_shape_ok(leaf, 1)``) unpacked to int8
    (``with_i8_storage``), except under a key holding "emb": embedding
    tables are gathered by row, never multiplied.  The JAX package's
    ``i8_storage_tree``."""
    if isinstance(tree, dict):
        return {k: i8_storage_tree(v, path + (k,)) for k, v in tree.items()}
    if not (isinstance(tree, QuantTensor) and int8_shape_ok(tree, 1)):
        return tree
    if any("emb" in str(k) for k in path):
        return tree
    return tree.with_i8_storage()


def _unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    return torch.cat([packed & 15, packed >> 4], dim=-1)


def _values(qt: QuantTensor) -> torch.Tensor:
    """The weight's integer values [..., O, I] as f32 (q4_0 with its zero
    point applied), from either storage."""
    if qt.unpacked:
        return qt.q.float()
    q = _unpack_nibbles(qt.q).float()
    return q - 8.0 if qt.fmt == "q4_0" else q


def dequantize(qt: QuantTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """[..., O, I] weight in ``dtype``; works on stacked leaves and on
    either storage.  q4_k recomputes d*sc and dmin*mn in f32 (not the bf16
    es/em), as the JAX package does."""
    if qt.fmt in ("q8_0", "q4_0"):
        w = _values(qt) * torch.repeat_interleave(qt.d.float(), QK, dim=-1)
    elif qt.fmt == "q8_r":
        w = qt.q.float() * qt.d.float()
    elif qt.fmt == "q4_k":
        q = _values(qt)
        i = q.shape[-1]
        lead = q.shape[:-1]
        eff_s = (qt.d.float()[..., None] * qt.sc.float()).reshape(
            lead + (i // QK,))
        eff_m = (qt.dmin.float()[..., None] * qt.mn.float()).reshape(
            lead + (i // QK,))
        w = (q * torch.repeat_interleave(eff_s, QK, dim=-1)
             - torch.repeat_interleave(eff_m, QK, dim=-1))
    else:
        raise ValueError(f"unsupported quant format {qt.fmt!r}")
    return w.to(dtype)


def flatten_lead(qt: QuantTensor) -> QuantTensor:
    """Merge the two leading axes of a stacked QuantTensor ([W, O, ...] ->
    [W*O, ...]): the stack viewed as one tall [W*O, I] matrix."""
    w, o = qt.q.shape[:2]
    return qt._map(lambda a: a.reshape((-1,) + tuple(a.shape[2:])),
                   shape=(w * o, qt.shape[-1]))


def dequantize_rows(qt: QuantTensor, rows: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Gather and dequantize selected rows (embedding lookup on packed
    data): rows [...] -> [..., I]."""
    flat = rows.reshape(-1)
    picked = QuantTensor(
        qt.fmt, (flat.shape[0], qt.shape[1]),
        *(None if getattr(qt, f) is None
          else torch.index_select(getattr(qt, f), 0, flat)
          for f in ("q", "d", "sc", "mn", "dmin")))
    return dequantize(picked, dtype).reshape(tuple(rows.shape)
                                             + (qt.shape[1],))


def layout_ok(qt: QuantTensor) -> bool:
    """The matvec kernels contract the planar halves separately, so a
    32-block must not straddle the half boundary: I % 64 == 0 for 4-bit
    formats (the JAX package's pallas_layout_ok)."""
    if qt.fmt in ("q4_0", "q4_k"):
        return qt.q.shape[-1] % QK == 0
    return qt.fmt == "q8_0"


def _int8_from_env() -> bool:
    """MOSHI_TPU_INT8: "1" (the default) or "0"; anything else raises, as
    in the JAX package, which reads it once, at import."""
    flag = os.environ.get("MOSHI_TPU_INT8", "1")
    if flag not in ("0", "1"):
        raise ValueError(f"MOSHI_TPU_INT8 must be '0' or '1', got {flag!r}")
    return flag == "1"


_INT8 = _int8_from_env()


def set_int8(flag: bool):
    """Turn the int8 kernels (K1, and K5, which needs them) on or off."""
    global _INT8
    _INT8 = bool(flag)


def int8_enabled() -> bool:
    return _INT8


def int8_shape_ok(qt: QuantTensor, m: int) -> bool:
    """Can the int8 matvec take this weight at ``m`` activation rows?  The
    JAX package's pallas_matmul_int8.int8_shape_ok: 1 <= m <= 8, packed
    4-bit storage at m > 1, K % 32 == 0, (K/32) % 8 == 0 (the 7B
    depformer linear_out, K = 4224 -> nb = 132, is refused) and the
    activation-spread cap m * pad8(K/32) * K <= 18 MiB."""
    if qt.fmt not in ("q4_k", "q4_0", "q8_0") or not 1 <= m <= 8:
        return False
    if m > 1 and i8_storage(qt):
        return False
    k = qt.shape[-1]
    if k % QK or (k // QK) % 8:
        return False
    nb_pad8 = -(-(k // QK) // 8) * 8
    return m * nb_pad8 * k <= 18 * 1024 * 1024


def storage_ok(qt: QuantTensor, m: int) -> bool:
    """Can the kernels take this weight at ``m`` activation rows?  Packed
    storage always; unpacked int8 storage only where the product goes to
    the int8 kernels (``int8_dispatch``: one row).  The JAX package's
    ``pallas_matmul.storage_ok``."""
    return not i8_storage(qt) or int8_dispatch(qt, m)


def check_packed(qt: QuantTensor):
    """Raise on unpacked int8 storage: the dequant kernels (K2, K6, K7,
    K8) read planar nibbles, and would misread it (the JAX package's
    ``_check_packed``)."""
    if i8_storage(qt):
        raise ValueError(
            f"{qt.fmt} QuantTensor has unpacked i8 storage, which only the "
            f"int8 kernels take (one activation row); the dequant kernels "
            f"read packed nibbles.  Keep packed storage for weights that "
            f"see several rows.")


def int8_dispatch(qt: QuantTensor, m: int) -> bool:
    """Does a product with this weight at ``m`` rows take the int8 kernels?
    The JAX package's ``_int8_dispatch``, the one rule behind ``qmatmul``,
    the GLUs and the mid-layer fusion: the kernels on (MOSHI_TPU_INT8, or
    ``set_int8``), at most MOSHI_TPU_INT8_MAX_M rows (default 1, read at
    each call) and ``int8_shape_ok``."""
    if not _INT8:
        return False
    if m > int(os.environ.get("MOSHI_TPU_INT8_MAX_M", "1")):
        return False
    return int8_shape_ok(qt, m)


def rms_pre_norm(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return xf * torch.rsqrt(ms + 1e-8) * alpha.float()


def qmatmul(x: torch.Tensor, w, out_dtype=None,
            pre_norm_alpha=None) -> torch.Tensor:
    """y = x @ w.T for plain tensors or QuantTensors; x [..., I] -> [..., O]
    (f32 unless ``out_dtype``).  ``pre_norm_alpha`` fuses an rms pre-norm of
    x (in-kernel on the quantized paths)."""
    if isinstance(w, QuantTensor) and w.fmt == "q8_r":
        if pre_norm_alpha is not None:
            x = rms_pre_norm(x, pre_norm_alpha)
        y = q8r_matmul(x, w)
    elif isinstance(w, QuantTensor):
        if int8_dispatch(w, x.numel() // x.shape[-1]):
            from moshi_tpu_torch.quant.matmul_int8 import qmatmul_i8
            y = qmatmul_i8(x, w, alpha=pre_norm_alpha)
        else:
            from moshi_tpu_torch.quant.matmul import qmatmul_dequant
            y = qmatmul_dequant(x, w, alpha=pre_norm_alpha)
    else:
        if pre_norm_alpha is not None:
            x = rms_pre_norm(x, pre_norm_alpha)
        if w.dtype == torch.bfloat16:
            x = x.to(torch.bfloat16)
        if x.is_cuda and w.dtype == torch.bfloat16 and w.dim() == 2:
            y = dense_mm(x, w)
        else:
            # bf16 x bf16 products are exact in f32; accumulate in f32
            y = torch.matmul(x.float(), w.float().transpose(-1, -2))
    if out_dtype is not None:
        y = y.to(out_dtype)
    return y


def dense_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., I] bf16 @ w [O, I].T bf16 -> [..., O] f32 in one cuBLAS call
    (bf16 operands, f32 accumulation and output: the JAX package's
    ``preferred_element_type=f32``)."""
    y = torch.mm(x.reshape(-1, x.shape[-1]), w.T, out_dtype=torch.float32)
    return y.reshape(tuple(x.shape[:-1]) + (w.shape[0],))


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32, exact
    (``torch._int_mm``).  On the card cuBLAS takes more than 16 rows and K
    and N in multiples of 8: the operands are padded with zeros there
    (the sums do not change) and the first M rows and N columns taken
    back."""
    m, k = a.shape
    n = b.shape[1]
    if not a.is_cuda:
        return torch._int_mm(a, b)
    mp = max(32, -(-m // 8) * 8)
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a, b)[:m, :n]


def q8r_matmul(x: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """The JAX package's q8_r product: each activation row quantized to
    int8 by its largest magnitude / 127 (at least 1e-12; a quotient, then
    round half to even), the int8 product summed exactly in int32, then
    scaled by the row's activation scale and the weight's row scale ->
    [..., O] f32."""
    xf = x.float()
    ax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
    x8 = torch.clamp(torch.round(xf / ax), -127, 127).to(torch.int8)
    lead = tuple(x.shape[:-1])
    yi = int8_mm(x8.reshape(-1, x.shape[-1]), w.q.T)
    y = yi.reshape(lead + (w.q.shape[0],)).float() * ax
    return y * w.d.float().reshape((1,) * len(lead) + (-1,))


# ---------------------------------------------------------------------------
# quantize (on the host, once at load time).  The numpy quantizers are the
# JAX package's, float for float: their results are its bits.
# ---------------------------------------------------------------------------


def _bf16_round_np(x: np.ndarray) -> np.ndarray:
    """f32 rounded to bf16 (nearest even), returned as f32."""
    u = np.asarray(x, np.float32).view(np.uint32)
    rounding = 0x7FFF + ((u >> 16) & 1)
    return (((u + rounding) & 0xFFFF0000).astype(np.uint32)).view(np.float32)


def _quantize_q8_0(w: np.ndarray) -> dict:
    o, i = w.shape
    assert i % QK == 0, f"q8_0 needs I % {QK} == 0, got {i}"
    blocks = w.reshape(o, i // QK, QK).astype(np.float32)
    amax = np.max(np.abs(blocks), axis=-1)
    ds = _bf16_round_np(amax / 127.0)
    inv = np.where(ds > 0, 1.0 / np.maximum(ds, 1e-30), 0.0)
    q = np.clip(np.round(blocks * inv[..., None]), -127, 127).astype(np.int8)
    return {"q": q.reshape(o, i), "d": ds}


def _quantize_q8_r(w: np.ndarray) -> dict:
    """Per-row symmetric int8: d = rowmax(|w|) / 127."""
    wf = w.astype(np.float32)
    amax = np.max(np.abs(wf), axis=-1, keepdims=True)       # [O, 1]
    ds = _bf16_round_np(amax / 127.0)
    inv = np.where(ds > 0, 1.0 / np.maximum(ds, 1e-30), 0.0)
    q = np.clip(np.round(wf * inv), -127, 127).astype(np.int8)
    return {"q": q, "d": ds}


def _pack_planar_np(q: np.ndarray) -> np.ndarray:
    """Nibbles [O, I] -> planar bytes [O, I/2]: byte j holds w[j] low and
    w[j + I/2] high."""
    i = q.shape[-1]
    return (q[:, : i // 2] | (q[:, i // 2:] << 4)).astype(np.uint8)


def _quantize_q4_0(w: np.ndarray) -> dict:
    o, i = w.shape
    assert i % QK == 0 and i % 2 == 0
    blocks = w.reshape(o, i // QK, QK).astype(np.float32)
    # the signed extreme / -8 as the scale, so that the extreme lands on
    # an end of [-8, 7]
    idx = np.argmax(np.abs(blocks), axis=-1)
    ext = np.take_along_axis(blocks, idx[..., None], axis=-1)[..., 0]
    ds = _bf16_round_np(ext / -8.0)
    inv = np.where(np.abs(ds) > 0, 1.0 / np.where(ds == 0, 1.0, ds), 0.0)
    q = np.clip(np.round(blocks * inv[..., None]) + 8, 0, 15).astype(np.uint8)
    return {"q": _pack_planar_np(q.reshape(o, i)), "d": ds}


def _fit_asym_subblocks(blocks: np.ndarray):
    """Per-32-subblock asymmetric fit: w ~= s*q - m with q in [0,15], m >= 0."""
    wmin = np.minimum(blocks.min(axis=-1), 0.0)
    wmax = np.maximum(blocks.max(axis=-1), 0.0)
    return (wmax - wmin) / 15.0, -wmin


def _quantize_q4_k(w: np.ndarray) -> dict:
    o, i = w.shape
    assert i % QK_K == 0, f"q4_k needs I % {QK_K} == 0, got {i}"
    nsb = i // QK_K
    blocks = w.reshape(o, nsb, 8, QK).astype(np.float32)
    s, m = _fit_asym_subblocks(blocks)                     # [O, nsb, 8]
    dsnap = _bf16_round_np(s.max(axis=-1) / 63.0)          # [O, nsb]
    dminsnap = _bf16_round_np(m.max(axis=-1) / 63.0)
    ds = dsnap[..., None]
    dmins = dminsnap[..., None]
    sc = np.clip(np.round(np.divide(s, ds, out=np.zeros_like(s),
                                    where=ds > 0)), 0, 63).astype(np.uint8)
    mn = np.clip(np.round(np.divide(m, dmins, out=np.zeros_like(m),
                                    where=dmins > 0)), 0, 63).astype(np.uint8)
    eff_s = ds * sc
    eff_m = dmins * mn
    inv = np.where(eff_s > 0, 1.0 / np.where(eff_s == 0, 1.0, eff_s), 0.0)
    q = np.clip(np.round((blocks + eff_m[..., None]) * inv[..., None]),
                0, 15).astype(np.uint8)
    return {"q": _pack_planar_np(q.reshape(o, i)), "d": dsnap, "sc": sc,
            "mn": mn, "dmin": dminsnap, "es": eff_s.reshape(o, i // QK),
            "em": eff_m.reshape(o, i // QK)}


def _bf16_tensor(a: np.ndarray, dev) -> torch.Tensor:
    """Scales to bf16 on ``dev``: raw bf16 bits (uint16) reinterpreted,
    f32 values rounded to nearest even."""
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).to(dev).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev).to(
        torch.bfloat16)


def quantize(w: np.ndarray, fmt: str, native: bool = True,
             device="cuda") -> QuantTensor:
    """A QuantTensor of ``w`` [O, I] (a host array) in ``fmt`` on
    ``device``: q8_r always, and the others with ``native=False``, by the
    numpy quantizers; q8_0, q4_0 and q4_k by default by the native one,
    which raises if it cannot be built (no fallback).  q4_k comes with
    its es/em."""
    w = np.asarray(w)
    assert w.ndim == 2, f"only 2-D weights quantize, got {w.shape}"
    if fmt not in QUANT_FORMATS:
        raise ValueError(f"unknown quant format {fmt!r}")
    dev = resolve_device(device)
    if fmt == "q8_r":
        f = _quantize_q8_r(w)
    elif native:
        from moshi_tpu_torch.native_quant import quantize_native
        f = quantize_native(w, fmt)
    else:
        f = {"q8_0": _quantize_q8_0, "q4_0": _quantize_q4_0,
             "q4_k": _quantize_q4_k}[fmt](w)
    comps = {k: (torch.from_numpy(f[k]).to(dev) if k in ("q", "sc", "mn")
                 else _bf16_tensor(f[k], dev)) for k in f}
    return QuantTensor(fmt, (w.shape[0], w.shape[1]), **comps).with_eff_scales()
