"""K4 and K11: in-place slot writes into KV rings, and the fp8 ring cast.

Counterparts of ``moshi_tpu/nn/pallas_ring.py`` ``ring_write_stacked``
(K4: both stacked rings [L, B, cap, H, hd] at once, after the stacked
decode's layer loop) and ``ring_write`` (K11: one 4-D ring [B, cap, H, hd],
from ``ring_insert`` in the generic stacks' T = 1 step).  The JAX kernels
aliased their outputs to the ring inputs so that only the written blocks
moved; here the ring tensors are mutated in place, and the functions
return them for symmetry with the JAX signatures.

The rings are bf16 or float8_e4m3fn (``LMConfig.kv_dtype``).  A bf16 ring
takes its rows as bf16 (other float rows are cast first, as the JAX
wrappers cast them).  An fp8 ring takes f32 or bf16 rows and converts them
inside the write by the reference's rule (``fp8_cast``): round to nearest
even in range, NaN (with the value's sign) for |x| > 464 and for NaN, so
±448 at 464 exactly.  That is XLA's convert; PyTorch's own
``.to(float8_e4m3fn)`` saturates to ±448 instead, so every fp8 write of
the port goes through ``fp8_cast``.  The row dtype is the one the JAX
path carries there: f32 in the stacked decode (its f32 rows are cast
straight to fp8; rounding them to bf16 first would round twice).

On CUDA tensors both launch ``csrc/ring_write.cu``'s kernels (bf16: the
copy, counts ``ring_write`` and ``ring_write4``; fp8: the converting
write, entries ``mt_ring_write_fp8`` / ``mt_ring_write4_fp8``, counts
``ring_write_fp8`` and ``ring_write4_fp8``) and raise if they cannot; on
CPU tensors they run ``ring_write_plain`` and ``ring_write4_plain``.
PyTorch has no indexed copy for fp8 tensors, so the plain versions and
``ring_index_copy_`` write an fp8 ring through its uint8 view.  The fp8
kernels take rows of a multiple of 16 values on 16-byte aligned tensors
(16 values a thread, 16-byte accesses) and the wrappers raise otherwise.
"""

from __future__ import annotations

import torch

from moshi_tpu_torch.kernels import build

FP8 = torch.float8_e4m3fn
FP8_NAN_ABOVE = 464.0     # |x| above this converts to NaN (XLA's rule)
RING_TYPES = (torch.bfloat16, FP8)
_ROW_TYPES = (torch.float32, torch.bfloat16)


def fp8_cast(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32 or bf16: both widen exactly) as float8_e4m3fn by the
    reference's rule: nearest even in range, NaN with x's sign where
    |x| > 464 or x is NaN."""
    xf = x.float()
    bits = xf.to(FP8).view(torch.uint8)
    nan = torch.where(torch.signbit(xf), 0xFF, 0x7F).to(torch.uint8)
    return torch.where(xf.abs() <= FP8_NAN_ABOVE, bits, nan).view(FP8)


def to_ring_dtype(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` in a ring's storage dtype: ``fp8_cast`` for fp8, else
    ``.to``."""
    if x.dtype == dtype:
        return x
    return fp8_cast(x) if dtype == FP8 else x.to(dtype)


def ring_bytes(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor's uint8 view (indexed copies take it), else ``t``."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


def ring_index_copy_(dst, dim: int, idx, src):
    """``dst.index_copy_(dim, idx, src)`` with ``src`` in ``dst``'s dtype
    first (``to_ring_dtype``); an fp8 ``dst`` is written through its uint8
    view.  Returns ``dst``."""
    ring_bytes(dst).index_copy_(dim, idx,
                                ring_bytes(to_ring_dtype(src, dst.dtype)))
    return dst


def check_rings(dev, rings, allowed=RING_TYPES) -> bool:
    """Ring operands ((name, tensor), ...): contiguous on ``dev``, all of
    one dtype of ``allowed``.  Returns whether they are fp8."""
    ring_dt = rings[0][1].dtype
    for name, t in rings:
        if t.device != dev or t.dtype != ring_dt or ring_dt not in allowed \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {dev} "
                             f"of {allowed} like the other ring, got "
                             f"{t.dtype} on {t.device}")
    return ring_dt == FP8


def ring_write_stacked(k_stack, v_stack, ks, vs, slot):
    """Write ks/vs [L, B, H, hd] into k_stack/v_stack [L, B, cap, H, hd]
    at per-session slots ``slot`` [B], in place.  Returns the rings."""
    l, b, cap, h, hd = k_stack.shape
    if v_stack.shape != k_stack.shape or ks.shape != (l, b, h, hd) or \
            vs.shape != ks.shape:
        raise ValueError(f"ring {tuple(k_stack.shape)} and rows "
                         f"{tuple(ks.shape)} do not match")
    if k_stack.dtype != FP8:
        ks, vs = ks.to(k_stack.dtype), vs.to(v_stack.dtype)
    if k_stack.is_cuda:
        _launch(k_stack, v_stack, ks.contiguous(), vs.contiguous(), slot)
    else:
        ring_write_plain(k_stack, v_stack, ks, vs, slot)
    return k_stack, v_stack


def ring_write_plain(k_stack, v_stack, ks, vs, slot):
    bi = torch.arange(k_stack.shape[1], device=k_stack.device)
    s = slot.to(device=k_stack.device, dtype=torch.long)
    ring_bytes(k_stack)[:, bi, s] = ring_bytes(to_ring_dtype(ks,
                                                             k_stack.dtype))
    ring_bytes(v_stack)[:, bi, s] = ring_bytes(to_ring_dtype(vs,
                                                             v_stack.dtype))


def _check_operands(dev, rings, rows, row: int):
    """Rings (``check_rings``) and rows: contiguous on ``dev``, bf16 for a
    bf16 ring, f32 or bf16 (all one type) for an fp8 ring, whose rows of
    ``row`` values must be a multiple of 16 on 16-byte aligned tensors.
    Returns (fp8 rings, bf16 rows)."""
    fp8 = check_rings(dev, rings)
    row_dt = rows[0][1].dtype
    allowed = _ROW_TYPES if fp8 else (torch.bfloat16,)
    for name, t in rows:
        if t.device != dev or t.dtype != row_dt or \
                row_dt not in allowed or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {dev} "
                             f"of {allowed} for a {rings[0][1].dtype} ring, "
                             f"got {t.dtype} on {t.device}")
    if fp8 and (row % 16 or any(t.data_ptr() % 16 for _, t in rings + rows)):
        raise ValueError(f"an fp8 ring write takes rows of a multiple of 16 "
                         f"values (got {row}) on 16-byte aligned tensors")
    return fp8, row_dt == torch.bfloat16


def _launch(k_stack, v_stack, ks, vs, slot):
    dev = k_stack.device
    l, b, cap, h, hd = k_stack.shape
    fp8, src_bf16 = _check_operands(
        dev, (("k_stack", k_stack), ("v_stack", v_stack)),
        (("ks", ks), ("vs", vs)), h * hd)
    s = slot.to(device=dev, dtype=torch.int32).contiguous()
    if s.shape != (b,):
        raise ValueError(f"slot must be [B], got {tuple(s.shape)}")
    args = [build.ptr(k_stack), build.ptr(v_stack), build.ptr(ks),
            build.ptr(vs), build.ptr(s), l, b, cap, h * hd]
    types = [build.VP, build.VP, build.VP, build.VP, build.VP, build.I32,
             build.I32, build.I32, build.I32]
    name = "ring_write_fp8" if fp8 else "ring_write"
    if fp8:
        args.append(int(src_bf16))
        types.append(build.I32)
    fn = build.entry("ring_write", f"mt_{name}", types + [build.VP])
    err = fn(*args, build.stream_of(k_stack))
    build.check(err, "ring_write", f"{name} L={l} B={b} cap={cap}")
    build.COUNTS[name] += 1


def ring_write(cache, values, slot):
    """Write values [B, H, hd] into the ring cache [B, cap, H, hd] at
    per-session slots ``slot`` [B], in place.  Returns the ring.  A bf16
    ring takes the values cast to bf16 first, as the JAX wrapper casts
    them; an fp8 ring converts f32 or bf16 values in the write."""
    b, cap, h, hd = cache.shape
    if values.shape != (b, h, hd):
        raise ValueError(f"ring {tuple(cache.shape)} and rows "
                         f"{tuple(values.shape)} do not match")
    if cache.dtype != FP8:
        values = values.to(cache.dtype)
    values = values.contiguous()
    if cache.is_cuda:
        _launch4(cache, values, slot)
    else:
        ring_write4_plain(cache, values, slot)
    return cache


def ring_write4_plain(cache, values, slot):
    bi = torch.arange(cache.shape[0], device=cache.device)
    ring_bytes(cache)[bi, slot.to(device=cache.device, dtype=torch.long)] = \
        ring_bytes(to_ring_dtype(values, cache.dtype))


def _launch4(cache, values, slot):
    dev = cache.device
    b, cap, h, hd = cache.shape
    fp8, src_bf16 = _check_operands(dev, (("cache", cache),),
                                    (("values", values),), h * hd)
    s = slot.to(device=dev, dtype=torch.int32).contiguous()
    if s.shape != (b,):
        raise ValueError(f"slot must be [B], got {tuple(s.shape)}")
    args = [build.ptr(cache), build.ptr(values), build.ptr(s), b, cap,
            h * hd]
    types = [build.VP, build.VP, build.VP, build.I32, build.I32, build.I32]
    name = "ring_write4_fp8" if fp8 else "ring_write4"
    if fp8:
        args.append(int(src_bf16))
        types.append(build.I32)
    fn = build.entry("ring_write", f"mt_{name}", types + [build.VP])
    err = fn(*args, build.stream_of(cache))
    build.check(err, "ring_write", f"{name} B={b} cap={cap}")
    build.COUNTS[name] += 1
