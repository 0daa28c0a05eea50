"""K3, K9 and K10: one-query decode attention over a KV ring, read in place.

K3 is the counterpart of ``moshi_tpu/nn/pallas_attention.py``
``decode_attention_stacked`` (the LM's stacked decode); K9, of its
``decode_attention`` (the generic stacks' T = 1 step, after the ring
insert).  They differ in four pins, each of which changes the result:

- the ring: K3 reads it before this step's write (the current token's
  k/v come in separately), K9 after it (the ring holds ``offset``);
- the mask: delta < context - 1 for K3, delta < context for K9;
- the start: K3 seeds the softmax with the current k/v, K9 starts at
  m = -1e9, l = 0, acc = 0;
- the chunk: ``chunk_for(cap)`` divides cap for K3; K9 takes
  min(256, cap) and masks the padded tail.

K3: the rings [L, B, cap, H, hd] hold the positions before this step (up
to ``offset - 1``); the current token's k/v arrive separately and seed
the online softmax, so the ring write can follow the whole layer loop.  A slot j is valid iff
delta = (last - j) mod cap < context - 1 and last - delta >= 0; masked
scores are -1e9.  The inputs are bf16; their products are formed exactly
in f32 and summed in f32, the probabilities are rounded to bf16 before
they weight the values (as the Pallas kernel's explicit cast does), the
ring is walked in the Pallas kernel's chunks (``chunk_for``), and the
output is f32 [B, H, hd].

K9: the rings [B, cap, H, hd] already hold the current token; with
r = offset % cap, a slot j is valid iff delta = r - j (+ cap if j > r) <
context, offset - delta >= 0 and j < cap.  q is rounded to bf16 first.
The same rounding rules hold as for K3.

K10 is the counterpart of ``decode_attention_stacked``'s MXU form,
which the JAX package takes under ``MOSHI_TPU_ATTN_MXU=1`` for bf16 rings
whose H * hd is a multiple of 128 and whose cap has a chunk
(``use_mxu_attn``, read at each call).  It keeps K3's ring, mask and seed,
and pins three roundings of its own:

- the scores take q pre-scaled and rounded to bf16:
  s_j = sum_d bf16(q_d * hd^-0.5) * k_jd (products exact in f32, f32
  sums); at hd 128 the scale is no power of two, so this rounding moves
  the scores; at hd 64 it is exact.  The seed's score keeps K3's form;
- each chunk's weighted values are rounded to bf16 once:
  acc = acc * corr + bf16(sum_j bf16(p_j) * v_j);
- the chunk is ``chunk_for_mxu(cap)`` (200 at cap 3000, where K3 takes
  250), and p rounds against that chunk's running max.

The rings of K3 and K9 may be float8_e4m3fn (``LMConfig.kv_dtype``): the
Pallas bodies widen each chunk with ``.astype(bf16)``, exact for e4m3, and
run the same arithmetic; so do the plain versions (``.float()`` of an fp8
ring is exact) and the kernel's fp8 instances.  q and K3's current k/v
stay bf16.  K10 takes bf16 rings only (``use_mxu_attn``).

On CUDA tensors ``decode_attention_stacked`` and ``decode_attention``
launch ``csrc/decode_attention.cu`` (K3 through the C entry
``mt_decode_attention`` and the count ``decode_attention``, K9 through
``mt_decode_attention4`` and ``decode_attention4``, K10 through
``mt_decode_attention_mxu`` and ``decode_attention_mxu``; on fp8 rings K3
and K9 through ``mt_decode_attention_fp8`` and
``mt_decode_attention4_fp8``, counts ``decode_attention_fp8`` and
``decode_attention4_fp8``) and raise if they cannot; on CPU tensors they
run ``decode_attention_plain``, ``decode_attention_mxu_plain`` and
``decode_attention4_plain``.

K3, K10 and K9 split the ring's chunks across the card: one block per
(session, head, chunk) from one launch (``launch_plan``).  Each block
forms its chunk's p, sum p and p . v against the walk's running max
before the chunk (K3's seed score, or K9's -1e9, and the earlier chunks'
maxima, which the blocks publish to each other), and the last block of a
(session, head) folds the chunks' parts in the walk's order, so the
outputs are the walk's bit for bit.  The blocks meet in a workspace of
the device (``workspace``), allocated zeroed once and left zeroed by
every call.  A ring of one chunk (the depformer's) needs none.  K9's
chunk need not divide cap (``launch_plan(..., ragged=True)``): its last
chunk is cut at cap.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from moshi_tpu_torch.kernels import build
from moshi_tpu_torch.nn.ring import RING_TYPES, check_rings

NEG = -1e9


def chunk_for(cap: int) -> int:
    """Largest divisor of cap <= 256 (the Pallas kernel's ring chunk)."""
    for c in (256, 250, 200, 128, 125, 100, 64, 50, 40, 32, 25, 20, 16,
              10, 8, 5, 4, 2, 1):
        if cap % c == 0:
            return c
    return 1


def chunk_for_mxu(cap: int) -> int:
    """K10's ring chunk: the largest of the Pallas kernel's sublane-aligned
    chunks that divides cap, cap itself below 8, else 0 (no chunk: K3)."""
    for c in (256, 200, 128, 104, 64, 56, 40, 32, 24, 16, 8):
        if cap % c == 0:
            return c
    return cap if cap < 8 else 0


def use_mxu_attn(kv_dtype, h: int, hd: int, cap: int) -> bool:
    """Does a stacked decode attention take K10?  The JAX package's
    ``_use_mxu_attn``: opt-in (``MOSHI_TPU_ATTN_MXU=1``, read at each
    call), bf16 rings, H * hd a multiple of 128 and a chunk for cap."""
    if os.environ.get("MOSHI_TPU_ATTN_MXU", "0") != "1":
        return False
    return (kv_dtype == torch.bfloat16 and (h * hd) % 128 == 0
            and chunk_for_mxu(cap) > 0)


def decode_attention_stacked(q, k_stack, v_stack, cur_k, cur_v, offset,
                             layer: int, *, cap: int,
                             context: int) -> torch.Tensor:
    """q/cur_k/cur_v [B, H, hd] bf16 (post-rope); k_stack/v_stack
    [L, B, cap, H, hd] bf16 or fp8 before this step's write; offset [B]
    int32 (the current position).  Returns [B, H, hd] f32.  K3, or K10 where
    ``use_mxu_attn`` holds."""
    b, h, hd = q.shape
    if k_stack.shape[1:] != (b, cap, h, hd) or v_stack.shape != k_stack.shape:
        raise ValueError(f"rings {tuple(k_stack.shape)} do not match q "
                         f"{tuple(q.shape)} at cap {cap}")
    if not 0 <= int(layer) < k_stack.shape[0]:
        raise IndexError(f"layer {layer} of {k_stack.shape[0]}")
    chunk = chunk_for(cap)
    if chunk < 8 and chunk != cap:
        raise ValueError(f"cap {cap} has no usable chunk divisor")
    if use_mxu_attn(k_stack.dtype, h, hd, cap):
        chunk = chunk_for_mxu(cap)
        if q.is_cuda:
            return _launch(q, k_stack, v_stack, cur_k, cur_v, offset,
                           int(layer), cap, context, chunk, mxu=True)
        return decode_attention_mxu_plain(
            q, k_stack[layer], v_stack[layer], cur_k, cur_v, offset,
            cap=cap, context=context, chunk=chunk)
    if q.is_cuda:
        return _launch(q, k_stack, v_stack, cur_k, cur_v, offset, int(layer),
                       cap, context, chunk)
    return decode_attention_plain(q, k_stack[layer], v_stack[layer], cur_k,
                                  cur_v, offset, cap=cap, context=context,
                                  chunk=chunk)


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def decode_attention_plain(q, k_ring, v_ring, cur_k, cur_v, offset, *,
                           cap: int, context: int,
                           chunk: int) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch for one layer's rings
    [B, cap, H, hd]."""
    hd = q.shape[-1]
    scale = hd ** -0.5
    qf = q.float()
    s_cur = (cur_k.float() * qf).sum(-1) * scale                  # [B, H]
    m = s_cur
    lsum = torch.ones_like(s_cur)
    acc = cur_v.float()                                           # [B, H, hd]
    last = offset.long() - 1
    r = torch.remainder(last, cap)
    for c0 in range(0, cap, chunk):
        k = k_ring[:, c0:c0 + chunk].float()                      # [B, C, H, hd]
        v = v_ring[:, c0:c0 + chunk].float()
        s = (k * qf[:, None]).sum(-1) * scale                     # [B, C, H]
        j = torch.arange(c0, c0 + chunk, device=q.device)[None, :]
        delta = torch.where(j > r[:, None], r[:, None] - j + cap,
                            r[:, None] - j)
        valid = (delta < context - 1) & (last[:, None] - delta >= 0)
        s = torch.where(valid[..., None], s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(dim=1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        lsum = lsum * corr + p.sum(dim=1)
        pv = (_bf16_round(p)[..., None] * v).sum(dim=1)
        acc = acc * corr[..., None] + pv
        m = m_new
    return acc / lsum[..., None]


def _scores_query(qf, scale):
    """K10's query for the chunk scores and the factor applied after the
    sum: bf16(q * scale), 1 (a control applies the scale after the sum,
    as K3 does)."""
    return _bf16_round(qf * scale), 1.0


def _pv_round(x: torch.Tensor) -> torch.Tensor:
    """K10's rounding of a chunk's weighted values (a control keeps f32)."""
    return _bf16_round(x)


def decode_attention_mxu_plain(q, k_ring, v_ring, cur_k, cur_v, offset, *,
                               cap: int, context: int,
                               chunk: int) -> torch.Tensor:
    """K10's arithmetic in PyTorch for one layer's rings [B, cap, H, hd]:
    K3's seed, ring and mask, with q pre-scaled and rounded to bf16 for
    the chunk scores and each chunk's p . v rounded to bf16."""
    hd = q.shape[-1]
    scale = hd ** -0.5
    qf = q.float()
    s_cur = (cur_k.float() * qf).sum(-1) * scale                  # [B, H]
    qs, post = _scores_query(qf, scale)
    m = s_cur
    lsum = torch.ones_like(s_cur)
    acc = cur_v.float()                                           # [B, H, hd]
    last = offset.long() - 1
    r = torch.remainder(last, cap)
    for c0 in range(0, cap, chunk):
        k = k_ring[:, c0:c0 + chunk].float()                      # [B, C, H, hd]
        v = v_ring[:, c0:c0 + chunk].float()
        s = (k * qs[:, None]).sum(-1) * post                      # [B, C, H]
        j = torch.arange(c0, c0 + chunk, device=q.device)[None, :]
        delta = torch.where(j > r[:, None], r[:, None] - j + cap,
                            r[:, None] - j)
        valid = (delta < context - 1) & (last[:, None] - delta >= 0)
        s = torch.where(valid[..., None], s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(dim=1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        lsum = lsum * corr + p.sum(dim=1)
        pv = _pv_round((_bf16_round(p)[..., None] * v).sum(dim=1))
        acc = acc * corr[..., None] + pv
        m = m_new
    return acc / lsum[..., None]


class LaunchPlan(NamedTuple):
    """The grid and workspace of one K3/K10/K9 call."""
    blocks: int        # one per (session, head, chunk)
    chunks: int        # ceil(cap / chunk)
    sync_bytes: int    # tickets, arrival counters and chunk states
    parts_bytes: int   # each chunk's p . v, corr and sum p


def launch_plan(b: int, h: int, hd: int, cap: int, chunk: int,
                ragged: bool = False) -> LaunchPlan:
    """A split launch over B = ``b`` sessions of ``h`` heads on a ring of
    ``cap`` slots in chunks of ``chunk``: the layout of
    ``csrc/decode_attention.cu``'s ``workspace_at``.  K3's and K10's chunk
    divides cap; K9's (``ragged``) need not, and its last chunk holds the
    cap % chunk slots left.  The sync region holds per (session, head) a
    ticket and an arrival counter (4 bytes each), then per chunk its state
    (8 bytes); the parts, per chunk its p . v, corr and sum p and two
    floats of padding (hd + 4 floats).  A ring of one chunk needs
    neither."""
    if chunk < 1 or (cap % chunk and not ragged):
        raise ValueError(f"chunk {chunk} does not divide cap {cap}")
    heads, nch = b * h, -(-cap // chunk)
    if nch == 1:
        return LaunchPlan(heads, 1, 0, 0)
    return LaunchPlan(heads * nch, nch, 8 * heads + 8 * heads * nch,
                      4 * heads * nch * (hd + 4))


_WORKSPACE: dict = {}     # device -> (sync, parts), both uint8


def workspace(device, sync_bytes: int, parts_bytes: int):
    """The device's K3/K10/K9 workspace, (sync, parts), at least as long as
    asked.  The sync region is allocated zeroed (every call leaves the
    bytes it used zeroed, so calls of any shape share it), the parts
    uninitialized (written before they are read); each is allocated anew
    only when a call needs more.  Calls on one device share them, so they
    must run on one stream, in order."""
    device = torch.device(device)
    sync, parts = _WORKSPACE.get(device, (None, None))
    if sync is None or sync.numel() < sync_bytes:
        sync = torch.zeros(sync_bytes, dtype=torch.uint8, device=device)
    if parts is None or parts.numel() < parts_bytes:
        parts = torch.empty(parts_bytes, dtype=torch.uint8, device=device)
    _WORKSPACE[device] = (sync, parts)
    return sync, parts


# the library of this checkout's kernels, and whether its entries take a
# workspace (another checkout's, built beside this one, may not)
THIS_BUILD = ("decode_attention", True)


def _workspace_args(dev, plan: LaunchPlan):
    """The workspace operands of a split entry (sync, its bytes, parts,
    its bytes): null at one chunk."""
    if plan.chunks == 1:
        return [None, 0, None, 0]
    sync, parts = workspace(dev, plan.sync_bytes, plan.parts_bytes)
    return [build.ptr(sync), sync.numel(), build.ptr(parts), parts.numel()]


def _launch(q, k_stack, v_stack, cur_k, cur_v, offset, layer, cap, context,
            chunk, mxu: bool = False, lib=THIS_BUILD):
    """One launch of K3 or K10 (``mxu``).  ``lib`` names the library and
    whether its entries take a workspace (another checkout's, built
    beside this one, may not)."""
    lib_name, takes_ws = lib
    dev = q.device
    for name, t in (("q", q), ("cur_k", cur_k), ("cur_v", cur_v)):
        if t.device != dev or t.dtype != torch.bfloat16 or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bf16 tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    fp8 = check_rings(dev, (("k_stack", k_stack), ("v_stack", v_stack)),
                      (torch.bfloat16,) if mxu else RING_TYPES)
    if cur_k.shape != q.shape or cur_v.shape != q.shape:
        raise ValueError("cur_k/cur_v must match q")
    b, h, hd = q.shape
    if hd not in (32, 64, 128):
        raise ValueError(f"head dim {hd} not supported (32, 64 or 128)")
    off = offset.to(device=dev, dtype=torch.int32).contiguous()
    if off.shape != (b,):
        raise ValueError(f"offset must be [B], got {tuple(off.shape)}")
    plan = launch_plan(b, h, hd, cap, chunk)
    name = ("decode_attention_mxu" if mxu else
            "decode_attention_fp8" if fp8 else "decode_attention")
    args = [build.VP, build.VP, build.VP, build.VP, build.VP, build.VP,
            build.VP, build.I32, build.I32, build.I32, build.I32, build.I32,
            build.I32, build.I32, build.F32]
    fn = build.entry(lib_name, f"mt_{name}",
                     args + ([build.VP, build.I64] * 2 if takes_ws else [])
                     + [build.VP])
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    vals = [build.ptr(q), build.ptr(cur_k), build.ptr(cur_v),
            build.ptr(k_stack), build.ptr(v_stack), build.ptr(off),
            build.ptr(out), b, h, hd, cap, context, chunk, layer, hd ** -0.5]
    if takes_ws:
        vals += _workspace_args(dev, plan)
    err = fn(*vals, build.stream_of(q))
    build.check(err, lib_name, f"{name} B={b} H={h} hd={hd} cap={cap} "
                f"({plan.blocks} blocks)")
    build.COUNTS[name] += 1
    return out


def chunk4_for(cap: int) -> int:
    """K9's ring chunk: min(256, cap), the last chunk padded and masked."""
    return min(256, cap)


def decode_attention(q, kc, vc, offset, *, cap: int,
                     context: int) -> torch.Tensor:
    """q [B, H, hd] (post-rope, any float type); kc/vc [B, cap, H, hd]
    bf16 or fp8 after this step's insert; offset [B] int32 (the query's
    position).  Returns [B, H, hd] f32."""
    b, h, hd = q.shape
    if kc.shape != (b, cap, h, hd) or vc.shape != kc.shape:
        raise ValueError(f"rings {tuple(kc.shape)} do not match q "
                         f"{tuple(q.shape)} at cap {cap}")
    if q.is_cuda:
        return _launch4(q.to(torch.bfloat16).contiguous(), kc, vc, offset,
                        cap, context)
    return decode_attention4_plain(q, kc, vc, offset, cap=cap,
                                   context=context)


def decode_attention4_plain(q, kc, vc, offset, *, cap: int, context: int,
                            chunk: int = 0) -> torch.Tensor:
    """K9's arithmetic in PyTorch, chunk by chunk as the Pallas grid walks
    the padded ring (``chunk`` 0 takes K9's own, ``chunk4_for``)."""
    chunk = chunk or chunk4_for(cap)
    b, h, hd = q.shape
    scale = hd ** -0.5
    qf = q.to(torch.bfloat16).float()
    m = torch.full((b, h), NEG, dtype=torch.float32, device=q.device)
    lsum = torch.zeros_like(m)
    acc = torch.zeros((b, h, hd), dtype=torch.float32, device=q.device)
    off = offset.to(q.device).long()
    r = torch.remainder(off, cap)
    for c0 in range(0, cap, chunk):
        k = kc[:, c0:c0 + chunk].float()                          # [B, C, H, hd]
        v = vc[:, c0:c0 + chunk].float()
        pad = chunk - k.shape[1]
        if pad:                       # the padded tail, zeros as in JAX
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        s = (k * qf[:, None]).sum(-1) * scale                     # [B, C, H]
        j = torch.arange(c0, c0 + chunk, device=q.device)[None, :]
        delta = torch.where(j > r[:, None], r[:, None] - j + cap,
                            r[:, None] - j)
        valid = (delta < context) & (off[:, None] - delta >= 0) & (j < cap)
        s = torch.where(valid[..., None], s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(dim=1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        lsum = lsum * corr + p.sum(dim=1)
        acc = acc * corr[..., None] + (_bf16_round(p)[..., None] * v).sum(1)
        m = m_new
    return acc / lsum[..., None]


def _launch4(q, kc, vc, offset, cap, context, lib=THIS_BUILD):
    """One launch of K9; ``lib`` as for ``_launch``."""
    lib_name, takes_ws = lib
    dev = q.device
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous bf16 tensor, got "
                         f"{q.dtype}")
    fp8 = check_rings(dev, (("kc", kc), ("vc", vc)))
    b, h, hd = q.shape
    if hd not in (32, 64, 128):
        raise ValueError(f"head dim {hd} not supported (32, 64 or 128)")
    off = offset.to(device=dev, dtype=torch.int32).contiguous()
    if off.shape != (b,):
        raise ValueError(f"offset must be [B], got {tuple(off.shape)}")
    chunk = chunk4_for(cap)
    plan = launch_plan(b, h, hd, cap, chunk, ragged=True)
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    name = "decode_attention4_fp8" if fp8 else "decode_attention4"
    fn = build.entry(lib_name, f"mt_{name}", [
        build.VP, build.VP, build.VP, build.VP, build.VP, build.I32,
        build.I32, build.I32, build.I32, build.I32, build.I32, build.F32]
        + ([build.VP, build.I64] * 2 if takes_ws else []) + [build.VP])
    vals = [build.ptr(q), build.ptr(kc), build.ptr(vc), build.ptr(off),
            build.ptr(out), b, h, hd, cap, context, chunk, hd ** -0.5]
    if takes_ws:
        vals += _workspace_args(dev, plan)
    err = fn(*vals, build.stream_of(q))
    build.check(err, lib_name, f"{name} (4-D ring) B={b} H={h} hd={hd} "
                f"cap={cap} ({plan.blocks} blocks)")
    build.COUNTS[name] += 1
    return out
