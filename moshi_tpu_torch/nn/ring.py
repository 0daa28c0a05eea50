"""K4 and K11: in-place slot writes into KV rings.

Counterparts of ``moshi_tpu/nn/pallas_ring.py`` ``ring_write_stacked``
(K4: both stacked rings [L, B, cap, H, hd] at once, after the stacked
decode's layer loop) and ``ring_write`` (K11: one 4-D ring [B, cap, H, hd],
from ``ring_insert`` in the generic stacks' T = 1 step).  The JAX kernels
aliased their outputs to the ring inputs so that only the written blocks
moved; here the ring tensors are mutated in place, and the functions
return them for symmetry with the JAX signatures.

On CUDA tensors both launch ``csrc/ring_write.cu``'s kernel (K11 through
its own C entry, ``mt_ring_write4``, and its own count, ``ring_write4``)
and raise if they cannot; on CPU tensors they run ``ring_write_plain`` and
``ring_write4_plain``.
"""

from __future__ import annotations

import torch

from moshi_tpu_torch.kernels import build


def ring_write_stacked(k_stack, v_stack, ks, vs, slot):
    """Write ks/vs [L, B, H, hd] into k_stack/v_stack [L, B, cap, H, hd]
    at per-session slots ``slot`` [B], in place.  Returns the rings."""
    l, b, cap, h, hd = k_stack.shape
    if v_stack.shape != k_stack.shape or ks.shape != (l, b, h, hd) or \
            vs.shape != ks.shape:
        raise ValueError(f"ring {tuple(k_stack.shape)} and rows "
                         f"{tuple(ks.shape)} do not match")
    if k_stack.is_cuda:
        _launch(k_stack, v_stack, ks, vs, slot)
    else:
        ring_write_plain(k_stack, v_stack, ks, vs, slot)
    return k_stack, v_stack


def ring_write_plain(k_stack, v_stack, ks, vs, slot):
    bi = torch.arange(k_stack.shape[1], device=k_stack.device)
    s = slot.to(device=k_stack.device, dtype=torch.long)
    k_stack[:, bi, s] = ks.to(k_stack.dtype)
    v_stack[:, bi, s] = vs.to(v_stack.dtype)


def _launch(k_stack, v_stack, ks, vs, slot):
    dev = k_stack.device
    l, b, cap, h, hd = k_stack.shape
    for name, t in (("k_stack", k_stack), ("v_stack", v_stack), ("ks", ks),
                    ("vs", vs)):
        if t.device != dev or t.dtype != torch.bfloat16 or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bf16 tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    s = slot.to(device=dev, dtype=torch.int32).contiguous()
    if s.shape != (b,):
        raise ValueError(f"slot must be [B], got {tuple(s.shape)}")
    fn = build.entry("ring_write", "mt_ring_write", [
        build.VP, build.VP, build.VP, build.VP, build.VP, build.I32,
        build.I32, build.I32, build.I32, build.VP])
    err = fn(build.ptr(k_stack), build.ptr(v_stack), build.ptr(ks),
             build.ptr(vs), build.ptr(s), l, b, cap, h * hd,
             build.stream_of(k_stack))
    build.check(err, "ring_write", f"ring write L={l} B={b} cap={cap}")
    build.COUNTS["ring_write"] += 1


def ring_write(cache, values, slot):
    """Write values [B, H, hd] into the ring cache [B, cap, H, hd] at
    per-session slots ``slot`` [B], in place.  Returns the ring.  The
    values are cast to the ring's dtype first, as the JAX wrapper does."""
    b, cap, h, hd = cache.shape
    if values.shape != (b, h, hd):
        raise ValueError(f"ring {tuple(cache.shape)} and rows "
                         f"{tuple(values.shape)} do not match")
    values = values.to(cache.dtype).contiguous()
    if cache.is_cuda:
        _launch4(cache, values, slot)
    else:
        ring_write4_plain(cache, values, slot)
    return cache


def ring_write4_plain(cache, values, slot):
    bi = torch.arange(cache.shape[0], device=cache.device)
    cache[bi, slot.to(device=cache.device, dtype=torch.long)] = \
        values.to(cache.dtype)


def _launch4(cache, values, slot):
    dev = cache.device
    b, cap, h, hd = cache.shape
    for name, t in (("cache", cache), ("values", values)):
        if t.device != dev or t.dtype != torch.bfloat16 or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bf16 tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    s = slot.to(device=dev, dtype=torch.int32).contiguous()
    if s.shape != (b,):
        raise ValueError(f"slot must be [B], got {tuple(s.shape)}")
    fn = build.entry("ring_write", "mt_ring_write4", [
        build.VP, build.VP, build.VP, build.I32, build.I32, build.I32,
        build.VP])
    err = fn(build.ptr(cache), build.ptr(values), build.ptr(s), b, cap,
             h * hd, build.stream_of(cache))
    build.check(err, "ring_write", f"ring write B={b} cap={cap}")
    build.COUNTS["ring_write4"] += 1
