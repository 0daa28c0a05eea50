"""K4 and K11: in-place slot writes into KV rings, and the fp8 ring cast.

Counterparts of ``moshi_tpu/nn/pallas_ring.py`` ``ring_write_stacked``
(K4: both stacked rings [L, B, cap, H, hd] at once, after the stacked
decode's layer loop) and ``ring_write`` (K11: a 4-D ring [B, cap, H, hd],
from ``ring_insert`` in the generic stacks' T = 1 step).  ``ring_write_kv``
writes a layer's k and v rows into its two rings in one launch, the
function ``ring_insert`` computes twice at T = 1; ``ring_write`` is the
one-ring entry.  The JAX kernels aliased their outputs to the ring inputs
so that only the written blocks moved; here the ring tensors are mutated
in place, and the functions return them for symmetry with the JAX
signatures.

Every entry takes a position [B] (int32 or int64, as the caller holds it:
the sessions' offsets, or slots already in [0, cap)) and writes at its
floor mod by cap, as ``torch.remainder`` and JAX's ``%`` give it; the
kernel takes the slot itself, so nothing is launched before it.

The rings are bf16 or float8_e4m3fn (``LMConfig.kv_dtype``); the rows are
f32 or bf16, and are converted in the write: a bf16 ring takes them as
``.to(bf16)`` rounds (nearest even), an fp8 ring by the reference's rule
(``fp8_cast``): round to nearest even in range, NaN (with the value's
sign) for |x| > 464 and for NaN, so ±448 at 464 exactly.  That is XLA's
convert; PyTorch's own ``.to(float8_e4m3fn)`` saturates to ±448 instead,
so every fp8 write of the port goes through ``fp8_cast``.  The row dtype
is the one the JAX path carries there: f32 in the stacked decode (its f32
rows are cast straight to fp8; rounding them to bf16 first would round
twice).

On CUDA tensors every entry launches ``csrc/ring_write.cu``'s one kernel
(C entry ``mt_ring_write_rows``; counts ``ring_write`` for K4 and
``ring_write4`` for K11, ``ring_write_fp8`` / ``ring_write4_fp8`` on fp8
rings) and raises if it cannot; on CPU tensors they run
``ring_write_plain``, ``ring_write_kv_plain`` and ``ring_write4_plain``.
The kernel reads each session's row where it lies (K11's rows are views
into the projection's and the rope's outputs, the sessions a stride
apart), in 16-byte vectors: rows of a multiple of 8 values (bf16 ring) or
16 (fp8 ring), tensors and strides 16-byte aligned; the wrappers raise
otherwise.  PyTorch has no indexed copy for fp8 tensors, so the plain
versions and ``ring_index_copy_`` write an fp8 ring through its uint8
view.
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


def ring_write_stacked(k_stack, v_stack, ks, vs, pos):
    """Write ks/vs [L, B, H, hd] into k_stack/v_stack [L, B, cap, H, hd]
    at slots ``pos`` [B] mod cap (floor mod), in place.  Returns the
    rings."""
    l, b, cap, h, hd = k_stack.shape
    if v_stack.shape != k_stack.shape or ks.shape != (l, b, h, hd) or \
            vs.shape != ks.shape:
        raise ValueError(f"ring {tuple(k_stack.shape)} and rows "
                         f"{tuple(ks.shape)} do not match")
    if k_stack.is_cuda:
        _launch("ring_write", (("k_stack", k_stack), ("v_stack", v_stack)),
                (("ks", ks), ("vs", vs)), pos, l)
    else:
        ring_write_plain(k_stack, v_stack, ks, vs, pos)
    return k_stack, v_stack


def ring_write_plain(k_stack, v_stack, ks, vs, pos):
    bi = torch.arange(k_stack.shape[1], device=k_stack.device)
    s = torch.remainder(pos.to(device=k_stack.device, dtype=torch.long),
                        k_stack.shape[2])
    ring_bytes(k_stack)[:, bi, s] = ring_bytes(to_ring_dtype(ks,
                                                             k_stack.dtype))
    ring_bytes(v_stack)[:, bi, s] = ring_bytes(to_ring_dtype(vs,
                                                             v_stack.dtype))


def ring_write_kv(k_ring, v_ring, k_rows, v_rows, offset):
    """Write a layer's rows k_rows/v_rows [B, H, hd] into its rings
    k_ring/v_ring [B, cap, H, hd] at slots ``offset`` [B] mod cap (floor
    mod), in place: ``ring_insert`` of k and of v at T = 1, one launch.
    Returns the rings."""
    b, cap, h, hd = k_ring.shape
    if v_ring.shape != k_ring.shape or k_rows.shape != (b, h, hd) or \
            v_rows.shape != k_rows.shape:
        raise ValueError(f"ring {tuple(k_ring.shape)} and rows "
                         f"{tuple(k_rows.shape)} do not match")
    if k_ring.is_cuda:
        _launch("ring_write4", (("k_ring", k_ring), ("v_ring", v_ring)),
                (("k_rows", k_rows), ("v_rows", v_rows)), offset, 1)
    else:
        ring_write_kv_plain(k_ring, v_ring, k_rows, v_rows, offset)
    return k_ring, v_ring


def ring_write_kv_plain(k_ring, v_ring, k_rows, v_rows, offset):
    """Two ``ring_write4_plain`` calls, k then v, at offset mod cap."""
    ring_write4_plain(k_ring, k_rows, offset)
    ring_write4_plain(v_ring, v_rows, offset)


def ring_write(cache, values, slot):
    """Write values [B, H, hd] into the ring cache [B, cap, H, hd] at
    slots ``slot`` [B] mod cap (floor mod; a slot in [0, cap) is itself),
    in place.  Returns the ring."""
    b, cap, h, hd = cache.shape
    if values.shape != (b, h, hd):
        raise ValueError(f"ring {tuple(cache.shape)} and rows "
                         f"{tuple(values.shape)} do not match")
    if cache.is_cuda:
        _launch("ring_write4", (("cache", cache),), (("values", values),),
                slot, 1)
    else:
        ring_write4_plain(cache, values, slot)
    return cache


def ring_write4_plain(cache, values, slot):
    bi = torch.arange(cache.shape[0], device=cache.device)
    s = torch.remainder(slot.to(device=cache.device, dtype=torch.long),
                        cache.shape[1])
    ring_bytes(cache)[bi, s] = ring_bytes(to_ring_dtype(values, cache.dtype))


def _row_stride(t, row: int) -> int:
    """Elements between consecutive rows of ``t`` (its rows of ``row``
    contiguous values, the leading dims flattened), or ``row`` where it
    holds one row; raises where one stride does not describe them."""
    try:
        flat = t.view(-1, row)
    except RuntimeError:
        flat = None
    if flat is None or (flat.stride(1) != 1 and row > 1):
        raise ValueError(f"rows of shape {tuple(t.shape)} and strides "
                         f"{t.stride()} are not rows of {row} contiguous "
                         f"values one stride apart")
    return flat.stride(0) if flat.shape[0] > 1 else row


def _check_operands(dev, rings, rows, row: int):
    """Rings (``check_rings``) and rows: on ``dev``, all f32 or all bf16,
    rows of ``row`` contiguous values one stride apart (``_row_stride``),
    ``row`` a multiple of a thread's 16-byte ring vector (8 values on a
    bf16 ring, 16 on fp8), every tensor and stride 16-byte aligned.
    Returns (fp8 rings, bf16 rows, each row tensor's stride in
    elements)."""
    fp8 = check_rings(dev, rings)
    row_dt = rows[0][1].dtype
    for name, t in rows:
        if t.device != dev or t.dtype != row_dt or row_dt not in _ROW_TYPES:
            raise ValueError(f"{name} must be a tensor on {dev} of "
                             f"{_ROW_TYPES}, like the other rows, got "
                             f"{t.dtype} on {t.device}")
    vec = 16 if fp8 else 8
    strides = [_row_stride(t, row) for _, t in rows]
    if row % vec or any(t.data_ptr() % 16 for _, t in rings + rows) or \
            any(s * t.element_size() % 16 for s, (_, t) in zip(strides, rows)):
        raise ValueError(f"a ring write takes rows of a multiple of {vec} "
                         f"values (got {row}) on 16-byte aligned tensors "
                         f"and strides")
    return fp8, row_dt == torch.bfloat16, strides


def _check_pos(dev, pos, b: int):
    """The positions: a [B] int32 or int64 tensor on ``dev``, read in
    place."""
    if not isinstance(pos, torch.Tensor) or pos.device != dev or \
            pos.dtype not in (torch.int32, torch.int64) or \
            pos.shape != (b,) or (b > 1 and pos.stride(0) != 1):
        raise ValueError(f"positions must be a contiguous [{b}] int32 or "
                         f"int64 tensor on {dev}")
    return pos


_ROWS_ARGTYPES = ([build.VP] * 4 + [build.I64] * 2 + [build.VP]
                  + [build.I32] * 7 + [build.VP])


def _launch(name, rings, rows, pos, layers: int, lib: str = "ring_write"):
    """One launch of ``csrc/ring_write.cu`` from ``lib`` (another
    checkout's build may stand in): ``rings`` ((name, tensor), one or
    two) [L, B, cap, H, hd] or [B, cap, H, hd], ``rows`` ((name, tensor)
    for each ring) [L, B, H, hd] or [B, H, hd], each (layer, session)'s
    row at slot ``pos`` [B] mod cap.  Counts ``name`` (``_fp8`` on fp8
    rings)."""
    ring = rings[0][1]
    dev = ring.device
    b, cap, h, hd = ring.shape[-4:]
    row = h * hd
    fp8, rows_bf16, strides = _check_operands(dev, rings, rows, row)
    p = _check_pos(dev, pos, b)
    rt = [t for _, t in rings] + [None] * (2 - len(rings))
    xt = [t for _, t in rows] + [None] * (2 - len(rows))
    strides += [0] * (2 - len(strides))
    fn = build.entry(lib, "mt_ring_write_rows", _ROWS_ARGTYPES)
    err = fn(*(build.ptr(t) if t is not None else None for t in rt + xt),
             *strides, build.ptr(p), int(p.dtype == torch.int64), layers, b,
             cap, row, int(fp8), int(not rows_bf16), build.stream_of(ring))
    count = f"{name}_fp8" if fp8 else name
    build.check(err, lib, f"{count} L={layers} B={b} cap={cap}")
    build.COUNTS[count] += 1
