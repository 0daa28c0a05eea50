#!/usr/bin/env python3
"""The decode attention kernels, K3 (bf16 and fp8 rings), K10 and K9
(``moshi_tpu_torch/csrc/decode_attention.cu``), and the ring writes, K11
and K4 (``moshi_tpu_torch/csrc/ring_write.cu``), against the same sources
in another checkout, on one card: bit identity and device time in turns.

    python3 attn_ab.py OTHER [--out F]
    python3 attn_ab.py OTHER --frames [--out F]

OTHER is the root of another checkout of this repository, for example
``mkdir -p build/other && git archive <commit> | tar -x -C build/other``.
Its ``decode_attention.cu`` (with its own headers) is built with this
tree's nvcc flags into ``build/ab/`` and called through the port's
launcher (``nn/decode_attention.py`` ``_launch`` and ``_launch4``; its K3,
K10 and K9 entries take the workspace where its source does); this tree's
build is called through the same launcher.  Then:

1. every output of K3 (bf16 and fp8 rings) and K10 on the 7B temporal
   ring (cap 3000, H 32, hd 128): at B = 1 a fresh session (offsets 0, 1
   and 16), partly filled rings (cap // 3, and each of K3's and K10's
   first chunk boundaries +- 1), wrapped rings (cap + 7, 2 cap + 250), a
   ring whose keys grow along the slots (the running max rises at almost
   every chunk, so every state update rescales) and a context shorter
   than the ring (leading chunks masked, and a window across the wrap);
   at B = 8 the sessions at ``chip_smoke.pool_offsets``; the depformer's
   ring (cap 8) at steps 0-7, at B = 1 and 8 (each on ``DRAWS`` draws of
   the query and current k/v at both layers of a two-layer ring); K9
   (``k9_cases``) on the stt-1b ring (cap 750: chunks 256, 256, 238) at
   offsets 0, 1, 255, 256, 257, 749, 750 and 2 * 750 + 9, in
   ``chip_smoke.stt_ring_states``' three states and on
   ``chip_smoke.k9_boundary_case``, and on the TTS ring (cap 500: 256,
   244) wrapped at B = 1 and at B = 8 at ``chip_smoke.pool_offsets``,
   bf16 and fp8, ``DRAWS`` queries each.  The two builds' outputs must
   agree bit for bit, and a second call of this build on the workspace
   the first left must repeat the first's bits; after each case the
   workspace's sync bytes read zero;
2. the main path's calls timed in turns (other, this, this, other; CUDA
   events, L2 flushed before each launch, as ``chip_smoke.time_ms``)
   (also at B = 8 with young sessions, one live chunk each, as in a
   pool's first ticks) beside SDPA on the same ring (fp8 rings widened
   first) and the bound
   (the valid ring rows, q, the current k/v and the output, once each,
   over 3.35 TB/s), with the blocks per call of each build;
3. the ring writes: OTHER's ``ring_write.cu`` is built into ``build/ab/``
   beside this tree's; a source with this tree's C entry
   (``mt_ring_write_rows``) is called through the port's launcher
   (``nn/ring.py`` ``_launch``), an older one through ``old_ring_write4``
   and ``old_ring_write_stacked``, which make the calls as that tree's
   frame made them (the slot by ``torch.remainder``, its int32 cast, the
   rows cast to a bf16 ring and made contiguous, then one launch per
   ring).  Every ring byte must be the same after every call of either
   build, on every case of ``ring_cases``: K11 (its k and v rings, and one
   ring) on the stt-1b ring, bf16 and fp8 rings, f32 and bf16 rows, B = 1
   and 8, rows contiguous and strided (views into a [B, 3 H hd]
   projection), at offsets 0, 5, cap - 1, cap, 2 cap + 7 and 2^31 - 1
   (int32), and past 2^40 (int64); K4 on the 7B temporal rings (all 32
   layers) at B = 1 and 8 the same way;
4. the ring writes timed in turns (other, this, this, other): each call
   by ``chip_smoke.time_ms`` (L2 flushed), back to back (one event pair
   around ``B2B`` calls, the host kept out of the window by a spin
   kernel), and the STT frame's and the TTS pool tick's ring writes in
   the frame's order (per layer the ring write, then K9 on that layer's
   ring, over all layers; the older build's sequence includes its own
   remainder, casts and copies), beside an empty kernel's launch timed
   by ``time_ms`` and back to back (the floor of any launch);
5. with ``--frames``, in place of 1-4: the frames whose ring writes
   changed, end to end, each checkout in a process of its own in turns
   (other, this, this, other; ``frame_worker``, which imports that
   checkout's ``chip_smoke`` and package and builds its kernels): the
   STT frame (bf16 and fp8 rings), the TTS frame (q4_k and bf16
   weights) and the TTS pool tick at B = ``chip_smoke.POOL_B``, at full
   width with that checkout's random weights and inputs, each
   ``FRAME_WARMUP`` frames then ``FRAME_TIMED`` timed ones on the host
   clock (each frame fetches its output), then one profile of each by
   that checkout's ``chip_smoke`` (device busy, launches; a checkout
   whose profile holds the kernels around its ring writes holds them).

Exits 1 at the first disagreement.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
REPS = 20
DRAWS = 3
BF16 = torch.bfloat16
OTHER_LIB = "decode_attention_other"
RING_LIB = "ring_write_other"
EMPTY_LIB = "empty_kernel"
# calls in a back-to-back window: a pair of the older build's K11 is 8
# launches, and the window stays well below the ~1,000 launches CUDA
# queues before the host blocks (a full queue lets the host into the
# window)
B2B = 50
YOUNG = [4, 6, 8, 10, 12, 14, 16, 18]   # a pool's ages in its first ticks


def fail(msg: str):
    print(f"attn_ab: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def build_other(other: Path):
    """Build OTHER's decode_attention.cu and register it with the loader;
    returns (nvcc's log, whether its K3/K10 entries take a workspace,
    whether its K9 entries do)."""
    src = other / "moshi_tpu_torch" / "csrc" / "decode_attention.cu"
    log = build_lib(src, OTHER_LIB)
    text = src.read_text()
    k9_ws = re.search(r"mt_decode_attention4\([^)]*parts_len", text)
    return log, "parts_len" in text, k9_ws is not None


def build_lib(src: Path, name: str):
    """``src`` built with this tree's nvcc flags into ``build/ab/`` and
    registered with the loader as ``name``; returns nvcc's log."""
    from moshi_tpu_torch.kernels import build
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{name}.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
        capture_output=True, text=True)
    if proc.returncode:
        fail(f"nvcc {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.mt_error_string.argtypes = [ctypes.c_int]
    lib.mt_error_string.restype = ctypes.c_char_p
    build._LIBS[name] = lib
    return proc.stdout + proc.stderr


EMPTY_SRC = r"""// an empty kernel: the floor of any launch
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int mt_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
extern "C" const char* mt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
"""


def build_rings(other: Path):
    """OTHER's ring_write.cu and the empty kernel, built and registered;
    returns (nvcc's log for OTHER's source, whether it has this tree's C
    entry)."""
    src = other / "moshi_tpu_torch" / "csrc" / "ring_write.cu"
    log = build_lib(src, RING_LIB)
    empty = ROOT / "build" / "ab" / "empty.cu"
    empty.write_text(EMPTY_SRC)
    build_lib(empty, EMPTY_LIB)
    return log, "mt_ring_write_rows" in src.read_text()


def launch_empty(_i=None):
    from moshi_tpu_torch.kernels import build
    fn = build.entry(EMPTY_LIB, "mt_empty", [build.VP])
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    build.check(fn(stream), EMPTY_LIB, "empty kernel")


def big_ring(shape, gen, fp8: bool):
    """A ring of ``shape`` on the card, N(0, 1) (fp8 by the reference's
    cast), drawn one leading slice at a time (a 7B pool's rings drawn in
    f32 at once would take 25 GB)."""
    import chip_smoke as cs
    if fp8:
        return cs.fp8_ring(shape, gen)
    r = torch.empty(shape, dtype=BF16, device="cuda")
    for i in range(shape[0]):
        r[i].copy_(torch.randn(shape[1:], generator=gen, device="cuda"))
    return r


def old_ring_write4(lib, cache, values, positions):
    """K11 on one ring as a tree before the pair entry made it
    (``nn/attention.py`` ``ring_insert`` at T = 1, ``nn/ring.py``
    ``ring_write`` / ``_launch4``): the slot by ``torch.remainder`` of the
    int64 positions, the rows cast to a bf16 ring's dtype and made
    contiguous, the slot cast to int32, then ``mt_ring_write4`` (or its
    fp8 entry)."""
    from moshi_tpu_torch.kernels import build
    from moshi_tpu_torch.nn.ring import FP8
    b, cap, h, hd = cache.shape
    slot = torch.remainder(positions.long(), cap)
    fp8 = cache.dtype == FP8
    if not fp8:
        values = values.to(cache.dtype)
    values = values.contiguous()
    s = slot.to(dtype=torch.int32).contiguous()
    args = [build.ptr(cache), build.ptr(values), build.ptr(s), b, cap,
            h * hd]
    types = [build.VP, build.VP, build.VP, build.I32, build.I32, build.I32]
    if fp8:
        args.append(int(values.dtype == BF16))
        types.append(build.I32)
    name = "mt_ring_write4_fp8" if fp8 else "mt_ring_write4"
    fn = build.entry(lib, name, types + [build.VP])
    build.check(fn(*args, build.stream_of(cache)), lib, name)


def old_ring_write_stacked(lib, k_stack, v_stack, ks, vs, offset):
    """K4 as a tree before this one's made it (``nn/transformer.py``
    ``_forward_stacked_decode``, ``nn/ring.py`` ``ring_write_stacked`` /
    ``_launch``): the slot by ``torch.remainder`` of the offsets and its
    int32 cast, the rows cast to a bf16 ring's dtype and made contiguous,
    then ``mt_ring_write`` (or its fp8 entry)."""
    from moshi_tpu_torch.kernels import build
    from moshi_tpu_torch.nn.ring import FP8
    l, b, cap, h, hd = k_stack.shape
    slot = torch.remainder(offset, cap).to(torch.int32)
    fp8 = k_stack.dtype == FP8
    if not fp8:
        ks, vs = ks.to(k_stack.dtype), vs.to(v_stack.dtype)
    ks, vs = ks.contiguous(), vs.contiguous()
    s = slot.to(dtype=torch.int32).contiguous()
    args = [build.ptr(k_stack), build.ptr(v_stack), build.ptr(ks),
            build.ptr(vs), build.ptr(s), l, b, cap, h * hd]
    types = [build.VP] * 5 + [build.I32] * 4
    if fp8:
        args.append(int(ks.dtype == BF16))
        types.append(build.I32)
    name = "mt_ring_write_fp8" if fp8 else "mt_ring_write"
    fn = build.entry(lib, name, types + [build.VP])
    build.check(fn(*args, build.stream_of(k_stack)), lib, name)


def ring_calls(lib, new: bool):
    """One build's (pair, one ring, stacked) calls: fn(k_ring, v_ring, k,
    v, pos), fn(ring, x, pos), fn(k_stack, v_stack, ks, vs, pos); ``new``:
    the build has this tree's entry, called through the port's launcher
    (``pos`` as the caller holds it), else through the old sequence
    (K11 given the int64 positions its frame held)."""
    from moshi_tpu_torch.nn import ring as rw
    if new:
        return (lambda kr, vr, k, v, p: rw._launch(
                    "ring_write4", (("k_ring", kr), ("v_ring", vr)),
                    (("k_rows", k), ("v_rows", v)), p, 1, lib=lib),
                lambda r, x, p: rw._launch("ring_write4", (("cache", r),),
                                           (("values", x),), p, 1, lib=lib),
                lambda kr, vr, ks, vs, p: rw._launch(
                    "ring_write", (("k_stack", kr), ("v_stack", vr)),
                    (("ks", ks), ("vs", vs)), p, kr.shape[0], lib=lib))

    def pair(kr, vr, k, v, p):
        old_ring_write4(lib, kr, k, p)
        old_ring_write4(lib, vr, v, p)

    return (pair, lambda r, x, p: old_ring_write4(lib, r, x, p),
            lambda kr, vr, ks, vs, p: old_ring_write_stacked(lib, kr, vr, ks,
                                                             vs, p))


def ring_positions(cap, b):
    """The positions each ring case is written at, as [B] tensors:
    ``chip_smoke.ring_offsets`` one by one at B = 1, every session at
    another of them (and cap // 3, 3 cap + 1) at B = 8, int32; then int64
    positions past 2^40."""
    import chip_smoke as cs
    offs = cs.ring_offsets(cap) + [cap // 3, 3 * cap + 1]
    sets = ([[o] for o in cs.ring_offsets(cap)] if b == 1 else
            [[offs[(i + s) % len(offs)] for i in range(b)] for s in (0, 3)])
    return ([torch.tensor(p, dtype=torch.int32, device="cuda")
             for p in sets]
            + [torch.tensor([2 ** 40 + 5 + 7 * i for i in range(b)],
                            dtype=torch.int64, device="cuda")])


def ring_cases(stt, temporal_layers, temporal):
    """(kernel, ring shape, ring fp8, row dtype, B, strided) of every ring
    case: K11 on the stt-1b ring, K4 on the 7B temporal rings."""
    out = []
    cap, h, hd, _ = stt
    for fp8 in (False, True):
        for rows in (torch.float32, BF16):
            for b in (1, 8):
                for strided in (False, True):
                    out.append(("K11", (b, cap, h, hd), fp8, rows, b,
                                strided))
    cap, h, hd, _ = temporal
    for fp8 in (False, True):
        for rows in (torch.float32, BF16):
            for b in (1, 8):
                out.append(("K4", (temporal_layers, b, cap, h, hd), fp8,
                            rows, b, False))
    return out


def ring_bytes_equal(a, b):
    return all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(a, b))


def compare_rings(gen, other_calls, this_calls, stt, temporal_layers,
                  temporal):
    """Phase 3: every ring case, the two builds from the same rings; after
    each call every ring byte must agree.  Returns the calls and the ring
    bytes compared, per kernel."""
    import chip_smoke as cs
    n = {}
    for kernel, shape, fp8, rows_dt, b, strided in ring_cases(
            stt, temporal_layers, temporal):
        mine = [big_ring(shape, gen, fp8) for _ in range(2)]
        theirs = [r.clone() for r in mine]
        row_shape = shape[:-3] + shape[-2:]
        for pos in ring_positions(shape[-3], b):
            k = cs._ring_rows(row_shape, gen, rows_dt, strided)
            v = cs._ring_rows(row_shape, gen, rows_dt, strided)
            what = (f"{kernel} {'fp8' if fp8 else 'bf16'} ring "
                    f"{list(shape)}, {rows_dt} rows"
                    f"{', strided' if strided else ''}, positions "
                    f"{pos.tolist()}")
            calls = ([("k and v", 0, (k, v)), ("one ring", 1, (v,))]
                     if kernel == "K11" else [("k and v", 2, (k, v))])
            for label, i, xs in calls:
                for build_calls, rings in ((other_calls, theirs),
                                           (this_calls, mine)):
                    build_calls[i](*rings[:len(xs)], *xs, pos)
                torch.cuda.synchronize()
                if not ring_bytes_equal(mine, theirs):
                    fail(f"{what}, {label}: a ring byte differs from the "
                         f"other build's")
                rec = n.setdefault(kernel, {"calls": 0, "ring_bytes": 0})
                rec["calls"] += 1
                rec["ring_bytes"] += sum(r.numel() * r.element_size()
                                         for r in mine)
        print(f"  {kernel:3s} {'fp8' if fp8 else 'bf16'} ring "
              f"{list(shape)}, {str(rows_dt).split('.')[-1]} rows"
              f"{', strided' if strided else ''}: every ring byte "
              f"identical", flush=True)
        del mine, theirs
    return n


_SPIN_MS = []          # device ms a spin-kernel cycle takes


def spin_ms(cycles: int) -> float:
    """Device ms of ``torch.cuda._sleep(cycles)``, from one timed spin."""
    if not _SPIN_MS:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(10_000_000)
        b.record()
        torch.cuda.synchronize()
        _SPIN_MS.append(a.elapsed_time(b) / 10_000_000)
    return cycles * _SPIN_MS[0]


def back_to_back(fn, reps: int = B2B, spin: int = 1_000_000):
    """(device ms, host ms) a call of ``fn(i)`` takes in a stream of
    ``reps`` back-to-back calls: one event pair around them, the host's
    enqueueing kept out of the window by a spin kernel of ``spin`` cycles
    a call.  Fails where the host's enqueueing outlasted the spin (the
    window would hold host time)."""
    fn(0)
    torch.cuda.synchronize()
    torch.cuda._sleep(reps * spin)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    host = (time.perf_counter() - t0) * 1e3
    b.record()
    torch.cuda.synchronize()
    if host >= spin_ms(reps * spin):
        fail(f"back to back: the host's enqueueing ({host:.2f} ms) "
             f"outlasted the spin ({spin_ms(reps * spin):.2f} ms)")
    return a.elapsed_time(b) / reps, host / reps


def ring_timings(gen, turns, stt, tts, temporal):
    """Phase 4: per case the per-call time by ``time_ms`` and back to back,
    in turns; the frames' ring writes with K9 in the frame's order; the
    empty kernel."""
    import chip_smoke as cs
    from moshi_tpu_torch.nn import decode_attention as da
    rows = []
    nl = 16                                # stt-1b and TTS temporal layers
    cases = []
    for label, geo, b, fp8 in (("K11 stt-1b", stt, 1, False),
                               ("K11 fp8 stt-1b", stt, 1, True),
                               ("K11 TTS pool", tts, 8, False)):
        cap, h, hd, context = geo
        shape = (b, cap, h, hd)
        qkv = [cs.kv_views(torch.randn((b, h, hd), generator=gen,
                                       device="cuda"), gen)
               for _ in range(4)]
        offs = torch.tensor([cap + 37 + 5 * i for i in range(b)],
                            dtype=torch.int32, device="cuda")
        cases.append((label, "pair", shape, fp8, qkv, offs, nl, geo))
    cap, h, hd, _ = temporal
    for label, b, fp8, rows_dt in (("K4 7B", 1, False, BF16),
                                   ("K4 fp8 7B", 1, True, torch.float32),
                                   ("K4 7B pool tick", 8, False, BF16),
                                   ("K4 fp8 7B pool tick", 8, True,
                                    torch.float32)):
        shape = (32, b, cap, h, hd)
        kv = [(torch.randn((32, b, h, hd), generator=gen,
                           device="cuda").to(rows_dt),
               torch.randn((32, b, h, hd), generator=gen,
                           device="cuda").to(rows_dt)) for _ in range(4)]
        offs = torch.tensor(cs.pool_offsets(cap, b), dtype=torch.int32,
                            device="cuda")
        cases.append((label, "stacked", shape, fp8, kv, offs, 1, None))
    for label, form, shape, fp8, kv, offs, per_frame, geo in cases:
        rings = [cs.fp8_ring(shape, gen) if fp8 else
                 torch.zeros(shape, dtype=BF16, device="cuda")
                 for _ in range(2)]
        pos64 = offs.long()
        row = {"case": label, "shape": list(shape), "calls_per_frame":
               per_frame, "time_ms": {}, "back_to_back_ms": {}}
        for turn, (calls, new) in turns:
            fn = calls[0] if form == "pair" else calls[2]
            pos = offs if new or form == "stacked" else pos64

            def call(i, fn=fn, pos=pos):
                fn(*rings, *kv[i % 4], pos)

            row["time_ms"].setdefault(turn, []).append(cs.time_ms(call,
                                                                  cs.REPS))
            dev, host = back_to_back(call)
            row["back_to_back_ms"].setdefault(turn, []).append(dev)
            row.setdefault("host_ms", {}).setdefault(turn, []).append(host)
        if form == "pair":
            # the frame's order: per layer the ring write, then K9 on that
            # layer's rings
            cap, h, hd, context = geo
            b = shape[0]
            layer_rings = [[r.clone() for r in rings] for _ in range(nl)]
            q = torch.randn((b, h, hd), generator=gen,
                            device="cuda").to(BF16)
            row["frame_ms"] = {}
            for turn, (calls, new) in turns:
                pos = offs if new else pos64

                def frame(_i, fn=calls[0], pos=pos):
                    for lyr in range(nl):
                        kr, vr = layer_rings[lyr]
                        fn(kr, vr, *kv[lyr % 4], pos)
                        da._launch4(q, kr, vr, offs, cap, context)

                row["frame_ms"].setdefault(turn, []).append(
                    back_to_back(frame, reps=4, spin=nl * 1_000_000)[0])
            del layer_rings
        rows.append(row)
        show = "; ".join(
            f"{key} " + ", ".join(f"{t} {v * 1e3:.2f}"
                                  for t, vs in row[key].items() for v in vs)
            for key in ("time_ms", "back_to_back_ms", "frame_ms", "host_ms")
            if key in row)
        print(f"  {label:20s} us: {show}  [{cs.CARD}]", flush=True)
        del rings
    empty = {"case": "empty kernel",
             "time_ms": cs.time_ms(launch_empty, cs.REPS),
             "back_to_back_ms": back_to_back(launch_empty)[0]}
    print(f"  empty kernel: time_ms {empty['time_ms'] * 1e3:.2f} us, back "
          f"to back {empty['back_to_back_ms'] * 1e3:.2f} us  [{cs.CARD}]",
          flush=True)
    rows.append(empty)
    return rows


def geometry():
    """(temporal, depformer, stt, tts) as (cap, heads, head dim,
    context): the 7B's rings, the stt-1b's and the TTS class's temporal
    ring."""
    import chip_smoke as cs
    from moshi_tpu_torch.models.lm import LMConfig
    cfg = LMConfig(delays=cs._7B_DELAYS)
    scfg, tcfg = cs.stt_config(), cs.tts_config()
    out = []
    for tc in (cfg.transformer, cfg.depformer, scfg.transformer,
               tcfg.transformer):
        m = tc.mha
        out.append((m.cap, m.num_heads, m.head_dim, tc.context))
    return out


def ring(shape, gen, fp8: bool, rising: bool = False):
    """A random ring [2, B, cap, H, hd] on the card (bf16, or fp8 by the
    reference's cast); ``rising``: each slot's keys scaled by 1 + 3 j /
    cap, so that scores grow along the ring."""
    import chip_smoke as cs
    if fp8:
        return cs.fp8_ring(shape, gen)
    r = torch.randn(shape, generator=gen, device="cuda")
    if rising:
        cap = shape[2]
        r *= (1 + 3 * torch.arange(cap, device="cuda") / cap)[
            None, None, :, None, None]
    return r.to(BF16)


def k3_cases(temporal, depformer):
    """(label, kernel, B, offsets, context, rising, geometry) of K3, K3 fp8
    and K10."""
    from moshi_tpu_torch.nn import decode_attention as da
    import chip_smoke as cs
    cap, _, _, ctx = temporal
    out = []
    bounds = sorted({c + d for c in (da.chunk_for(cap), da.chunk_for_mxu(cap))
                     for d in (-1, 0, 1)})
    for kernel in ("K3", "K3 fp8", "K10"):
        for label, offs, context, rising in (
                ("fresh", [0], ctx, False), ("fresh", [1], ctx, False),
                ("fresh", [16], ctx, False),
                ("partly filled", [cap // 3], ctx, False),
                *(("chunk boundary", [o + 1], ctx, False) for o in bounds),
                ("wrapped", [cap + 7], ctx, False),
                ("wrapped", [2 * cap + 250], ctx, False),
                ("rising keys", [cap + 7], ctx, True),
                ("short context", [2500], 1000, False),
                ("short context, wrapped", [2 * cap + 250], 1000, False),
                ("B = 8", cs.pool_offsets(cap, 8), ctx, False)):
            out.append((label, kernel, len(offs), offs, context, rising,
                        temporal))
        if kernel != "K3 fp8":     # the depformer's rings stay bf16
            for step in range(8):
                out.append((f"depformer step {step}", kernel, 1, [step],
                            depformer[3], False, depformer))
            out.append(("depformer, B = 8", kernel, 8, list(range(8)),
                        depformer[3], False, depformer))
    return out


def k3_calls(kernel, lib, geo, k_ring, v_ring, context):
    """fn(cur, offset, layer) -> out of one build."""
    from moshi_tpu_torch.nn import decode_attention as da
    cap = geo[0]
    mxu = kernel == "K10"
    chunk = da.chunk_for_mxu(cap) if mxu else da.chunk_for(cap)

    def call(cur, offset, layer):
        return da._launch(cur[0], k_ring, v_ring, cur[1], cur[2], offset,
                          layer, cap, context, chunk, mxu=mxu, lib=lib)

    return call


def k9_cases(stt, tts):
    """(label, geometry, offsets) of K9's rings: the stt-1b's at the ages
    where its chunks fill and wrap and in its three states, and the TTS
    ring at B = 1 and 8.  ``chip_smoke.k9_boundary_case`` comes on top."""
    import chip_smoke as cs
    cap = stt[0]
    out = [(f"stt offset {o}", stt, [o])
           for o in (0, 1, 255, 256, 257, cap - 1, cap, 2 * cap + 9)]
    out += [(f"stt {label}", stt, [o])
            for label, o in cs.stt_ring_states(cap)]
    out += [("tts wrapped", tts, [tts[0] + 37]),
            ("tts B = 8", tts, cs.pool_offsets(tts[0], 8))]
    return out


def same_bits(a, b) -> int:
    """Elements whose bits differ."""
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def check_workspace(what):
    """Every byte of the device's sync region reads zero."""
    from moshi_tpu_torch.nn import decode_attention as da
    sync, _ = da._WORKSPACE.get(torch.device("cuda", 0), (None, None))
    if sync is not None and int(sync.count_nonzero()):
        fail(f"{what}: {int(sync.count_nonzero())} bytes of the workspace's "
             f"sync region are not zero after the calls")


def compare(gen, other_lib, this_lib, other4, temporal, depformer, stt,
            tts):
    """Phase 1 (``other4``: the other build's library for K9, with its
    workspace flag).  Returns the outputs compared, by kernel."""
    from moshi_tpu_torch.nn import decode_attention as da
    import chip_smoke as cs
    n = {}
    for label, kernel, b, offs, context, rising, geo in k3_cases(temporal,
                                                                 depformer):
        cap, h, hd, _ = geo
        fp8 = kernel == "K3 fp8"
        shape = (2, b, cap, h, hd)
        k_ring = ring(shape, gen, fp8, rising)
        v_ring = ring(shape, gen, fp8)
        theirs = k3_calls(kernel, other_lib, geo, k_ring, v_ring, context)
        mine = k3_calls(kernel, this_lib, geo, k_ring, v_ring, context)
        offset = torch.tensor(offs, dtype=torch.int32, device="cuda")
        chunk = da.chunk_for_mxu(cap) if kernel == "K10" else \
            da.chunk_for(cap)
        plan = da.launch_plan(b, h, hd, cap, chunk)
        for layer in (0, 1):
            for d in range(DRAWS):
                cur = [torch.randn((b, h, hd), generator=gen,
                                   device="cuda").to(BF16) for _ in range(3)]
                a, m1, m2 = (theirs(cur, offset, layer),
                             mine(cur, offset, layer),
                             mine(cur, offset, layer))
                torch.cuda.synchronize()
                what = (f"{kernel} {label} B={b} offsets {offs} context "
                        f"{context} layer {layer} draw {d}")
                bad = same_bits(a, m1)
                if bad:
                    fail(f"{what}: {bad} of {a.numel()} outputs differ from "
                         f"the other build's")
                if same_bits(m1, m2):
                    fail(f"{what}: a second call on the same workspace "
                         f"differs from the first")
                n[kernel] = n.get(kernel, 0) + a.numel()
        check_workspace(f"{kernel} {label}")
        print(f"  {kernel:6s} {label:24s} B={b} cap={cap} offsets "
              f"{offs if b == 1 else 'pool'} context {context}: "
              f"bit-identical, {plan.blocks} blocks  ", flush=True)
        del k_ring, v_ring
    # K9: the stt-1b and TTS rings, bf16 and fp8, and the chunk-boundary
    # ring; every call of this build twice on the same workspace
    for fp8 in (False, True):
        kernel = "K9 fp8" if fp8 else "K9"
        cases = [(label, geo, offs, None)
                 for label, geo, offs in k9_cases(stt, tts)]
        bgen = torch.Generator(device="cuda").manual_seed(11)
        off, qs, bkc, bvc = cs.k9_boundary_case(stt[0], stt[1], stt[2],
                                                bgen)
        if fp8:
            from moshi_tpu_torch.nn.ring import fp8_cast
            bkc, bvc = fp8_cast(bkc.float()), fp8_cast(bvc.float())
        cases.append(("stt chunk boundary", stt, [off], (qs, bkc, bvc)))
        for label, geo, offs, special in cases:
            cap, h, hd, context = geo
            b = len(offs)
            offset = torch.tensor(offs, dtype=torch.int32, device="cuda")
            qs, k, v = special or (
                [torch.randn((b, h, hd), generator=gen, device="cuda")
                 .to(BF16) for _ in range(DRAWS)],
                ring((1, b, cap, h, hd), gen, fp8)[0],
                ring((1, b, cap, h, hd), gen, fp8)[0])
            for q in qs:
                a = da._launch4(q, k, v, offset, cap, context, lib=other4)
                m1 = da._launch4(q, k, v, offset, cap, context, lib=this_lib)
                m2 = da._launch4(q, k, v, offset, cap, context, lib=this_lib)
                torch.cuda.synchronize()
                what = f"{kernel} {label} offsets {offs}"
                bad = same_bits(a, m1)
                if bad:
                    fail(f"{what}: {bad} of {a.numel()} outputs differ from "
                         f"the other build's")
                if same_bits(m1, m2):
                    fail(f"{what}: a second call on the same workspace "
                         f"differs from the first")
                n[kernel] = n.get(kernel, 0) + a.numel()
            check_workspace(f"{kernel} {label}")
            plan = da.launch_plan(b, h, hd, cap, da.chunk4_for(cap),
                                  ragged=True)
            print(f"  {kernel:6s} {label:24s} B={b} cap={cap} offsets "
                  f"{offs if b == 1 else 'pool'}: bit-identical, "
                  f"{plan.blocks} blocks", flush=True)
            del k, v
    return n


def timings(gen, other_lib, this_lib, other4, takes_ws, temporal, depformer,
            stt, tts):
    """Phase 2: the main path's calls, in turns."""
    from moshi_tpu_torch.nn import decode_attention as da
    import chip_smoke as cs
    rows = []
    tcap = temporal[0]
    for kernel, label, b, offs, geo in (
            ("K3", "temporal, full ring", 1, [tcap + 7], temporal),
            ("K3", "temporal, fresh (16)", 1, [16], temporal),
            ("K3", "temporal, B = 8", 8, cs.pool_offsets(tcap, 8), temporal),
            ("K3", "temporal, B = 8 young", 8, YOUNG, temporal),
            ("K3", "depformer, step 4", 1, [4], depformer),
            ("K3", "depformer, B = 8", 8, list(range(8)), depformer),
            ("K10", "temporal, full ring", 1, [tcap + 7], temporal),
            ("K10", "temporal, B = 8", 8, cs.pool_offsets(tcap, 8),
             temporal),
            ("K10", "depformer, step 4", 1, [4], depformer),
            ("K3 fp8", "temporal, full ring", 1, [tcap + 7], temporal),
            ("K3 fp8", "temporal, B = 8", 8, cs.pool_offsets(tcap, 8),
             temporal),
            ("K9", "stt-1b, wrapped", 1, [stt[0] + 37], stt),
            ("K9", "stt-1b, fresh (93)", 1, [stt[0] // 8], stt),
            ("K9", "tts, wrapped", 1, [tts[0] + 37], tts),
            ("K9", "tts, B = 8", 8, cs.pool_offsets(tts[0], 8), tts),
            ("K9", "tts, B = 8 young", 8, YOUNG, tts),
            ("K9 fp8", "stt-1b, wrapped", 1, [stt[0] + 37], stt)):
        cap, h, hd, context = geo
        fp8 = kernel.endswith("fp8")
        k9 = kernel.startswith("K9")
        shape = (1 if k9 else 2, b, cap, h, hd)
        k_ring, v_ring = ring(shape, gen, fp8), ring(shape, gen, fp8)
        offset = torch.tensor(offs, dtype=torch.int32, device="cuda")
        curs = [[torch.randn((b, h, hd), generator=gen, device="cuda")
                 .to(BF16) for _ in range(3)] for _ in range(4)]
        if k9:
            def make(lib):
                return lambda i: da._launch4(curs[i % 4][0], k_ring[0],
                                             v_ring[0], offset, cap, context,
                                             lib=lib)
            chunk = da.chunk4_for(cap)
            blocks = da.launch_plan(b, h, hd, cap, chunk, ragged=True).blocks
            blocks_other = blocks if other4[1] else b * h
        else:
            def make(lib):
                call = k3_calls(kernel, lib, geo, k_ring, v_ring, context)
                return lambda i: call(curs[i % 4], offset, i % 2)
            chunk = (da.chunk_for_mxu(cap) if kernel == "K10"
                     else da.chunk_for(cap))
            blocks = da.launch_plan(b, h, hd, cap, chunk).blocks
            blocks_other = blocks if takes_ws else b * h
        theirs, mine = make(other4 if k9 else other_lib), make(this_lib)
        t = {}
        for turn, fn in (("other", theirs), ("this", mine), ("this2", mine),
                         ("other2", theirs)):
            t[turn] = cs.time_ms(fn, REPS)

        def run_lib(i):
            kk = k_ring[i % shape[0]].to(BF16).transpose(1, 2)
            vv = v_ring[i % shape[0]].to(BF16).transpose(1, 2)
            return torch.nn.functional.scaled_dot_product_attention(
                curs[i % 4][0][:, :, None], kk, vv)

        t_lib = cs.time_ms(run_lib, REPS)
        row = h * hd
        esize = 1 if fp8 else 2
        window = context if k9 else context - 1
        valid = sum(max(0, min(o + (1 if k9 else 0), window)) for o in offs)
        nb = valid * row * esize * 2 + b * ((1 if k9 else 3) * row * 2
                                            + row * 4)
        b_ms, b_by = cs.bound_ms(nb, 4.0 * (valid + b) * row, "f32")
        rows.append({"kernel": kernel, "case": label, "B": b, "cap": cap,
                     "chunk": chunk, "blocks_other": blocks_other,
                     "blocks_this": blocks,
                     "other_ms": [t["other"], t["other2"]],
                     "this_ms": [t["this"], t["this2"]],
                     "library_ms": t_lib, "bound_ms": b_ms, "bound_by": b_by,
                     "bytes": nb})
        print(f"  {kernel:6s} {label:22s} other {t['other'] * 1e3:7.1f} us, "
              f"this {t['this'] * 1e3:7.1f} us, this "
              f"{t['this2'] * 1e3:7.1f} us, other {t['other2'] * 1e3:7.1f} "
              f"us; sdpa {t_lib * 1e3:6.1f} us, bound {b_ms * 1e3:5.1f} us; "
              f"blocks {blocks_other} / {blocks}  [{cs.CARD}]", flush=True)
        del k_ring, v_ring
    return rows


FRAME_WARMUP = 3     # frames of each path before the timed ones
FRAME_TIMED = 20     # timed frames (or pool ticks) of each path


def _wall_ms(step):
    """``step(f)`` (which fetches its frame's output to the host) for
    FRAME_WARMUP + FRAME_TIMED frames; the timed frames' host-clock ms."""
    ms = []
    for f in range(FRAME_WARMUP + FRAME_TIMED):
        t0 = time.perf_counter()
        step(f)
        if f >= FRAME_WARMUP:
            ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def _accepts(fn, name: str) -> bool:
    import inspect
    return name in inspect.signature(fn).parameters


def frame_worker(root: Path, out: Path):
    """Section 5's worker, in a process of its own: the checkout at
    ``root`` (its ``chip_smoke`` and its package, imported before
    anything of this tree), its kernels built, its STT, TTS and TTS pool
    frames timed and profiled; the numbers go to ``out`` as JSON."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from moshi_tpu_torch.kernels import build
    from moshi_tpu_torch.models.device_machine import (compile_script,
                                                       init_device_state)
    from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
    from moshi_tpu_torch.models.state_machine import StateMachine
    from moshi_tpu_torch.nn.transformer import transformer_cross_kv
    from moshi_tpu_torch.runtime.pipeline import STTPipeline, TTSPipeline
    from moshi_tpu_torch.runtime.synth import (synth_lm_params,
                                               synth_mimi_params)
    for mod in (cs, build):
        if not Path(mod.__file__).resolve().is_relative_to(root):
            fail(f"{mod.__name__} imported from {mod.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.CARD = cs.smi_line()
    build.build_all()
    res = {}

    def keep(path, ms, prof):
        res[path] = {"ms": ms, "mean": sum(ms) / len(ms),
                     "median": sorted(ms)[len(ms) // 2],
                     "profile": {k: prof[k] for k in (
                         "wall_ms_per_frame", "device_busy_ms_per_frame",
                         "kernel_launches_per_frame")}}
        print(f"  {path}: ms/frame mean {res[path]['mean']:.3f}, median "
              f"{res[path]['median']:.3f}; profiled: device busy "
              f"{prof['device_busy_ms_per_frame']:.3f} ms, "
              f"{prof['kernel_launches_per_frame']:.0f} launches",
              flush=True)

    scfg = cs.stt_config()
    sparams = synth_lm_params(scfg, None, device=cs.DEV, seed=cs.SEED)
    mimi32 = MimiModel(MimiConfig(n_q=scfg.n_q))
    mparams = synth_mimi_params(mimi32.cfg, device=cs.DEV, seed=cs.SEED + 1)
    for path, cfg in (("stt", scfg), ("stt_fp8", cs.fp8_config(scfg))):
        pipe = STTPipeline(mimi32, cfg, device=cs.DEV)
        audio = cs._sts_inputs(pipe.frame_samples,
                               FRAME_WARMUP + FRAME_TIMED, cs.SEED + 11)
        box = {"state": pipe.init_state(1, seed=cs.SEED + 12)}

        def stt_step(f):
            o, box["state"] = pipe.step(mparams, sparams, box["state"],
                                        audio[f])
            torch.stack([o["text"][0].float(), o["vad"][0]]).cpu()

        keep(path, _wall_ms(stt_step),
             cs.profile_stt(cfg, sparams, mimi32, mparams))
    del sparams
    tcfg = cs.tts_config()
    mimi_tts = MimiModel(MimiConfig(n_q=tcfg.n_q))
    mparams_tts = synth_mimi_params(mimi_tts.cfg, device=cs.DEV,
                                    seed=cs.SEED + 2)
    csum, cross = cs.tts_voice(tcfg, cs.SEED + 47)
    tparams = synth_lm_params(tcfg, "q4_k", device=cs.DEV, seed=cs.SEED)
    for path in ("tts", "tts_bf16"):
        params = (tparams if path == "tts" else
                  synth_lm_params(tcfg, None, device=cs.DEV, seed=cs.SEED))
        pipe = TTSPipeline(mimi_tts, tcfg, device=cs.DEV)
        dm = pipe.enable_device_fsm(
            StateMachine(text_card=tcfg.text_card + 1))
        script = compile_script(cs.tts_scripts(tcfg, 4)[3:], dm,
                                device=cs.DEV)
        ckv = transformer_cross_kv(tcfg.transformer, params["transformer"],
                                   cross)
        box = {"state": pipe.init_state(1, seed=cs.SEED + 48),
               "mstate": init_device_state(dm, script)}

        def tts_step(f):
            o, box["state"], box["mstate"] = pipe.step_device(
                mparams_tts, params, box["state"], box["mstate"], script,
                condition_sum=csum, cross_kv=ckv)
            torch.stack([o["audio_out"].sum(),
                         o["audio_tokens"].sum().float()]).cpu()

        with cs.fusion("1"):
            ms = _wall_ms(tts_step)
        kw = ({"bf16": path == "tts_bf16"}
              if _accepts(cs.profile_tts, "bf16") else {})
        keep(path, ms, cs.profile_tts(tcfg, params, mimi_tts, mparams_tts,
                                      **kw))
        del params
    pool = cs._tts_pool(tcfg, tparams, mimi_tts, mparams_tts, cs.POOL_B,
                        cs.DEV, cs.SEED + 49)
    scripts = cs.tts_scripts(tcfg, cs.POOL_B)

    def tick(t):
        for i, sc in enumerate(scripts):
            if i // 3 == t:
                pool.attach(f"s{i}", sc)
        pool.tick()                           # one copy to the host

    keep("tts_pool", _wall_ms(tick), cs.profile_tts_pool(pool))
    out.write_text(json.dumps({"root": str(root), "card": cs.CARD,
                               "paths": res}))


def frames_in_turns(other: Path):
    """Section 5: ``frame_worker`` on OTHER and on this tree in turns
    (other, this, this, other), each in a process of its own.  Returns
    per path the turns' numbers."""
    turns = [("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)]
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = {}
    for i, (who, root) in enumerate(turns):
        print(f"  turn {i + 1}: {who} ({root})", flush=True)
        out = out_dir / f"frames_{i}.json"
        out.unlink(missing_ok=True)
        proc = subprocess.run([sys.executable, str(ROOT / "attn_ab.py"),
                               str(root), "--frame-worker", str(out)],
                              cwd=root)
        if proc.returncode or not out.exists():
            fail(f"turn {i + 1} ({who}) exited {proc.returncode}")
        got = json.loads(out.read_text())
        for path, r in got["paths"].items():
            rows.setdefault(path, []).append({"build": who,
                                              "card": got["card"], **r})
    for path, rs in rows.items():
        line = {"mean": [r["mean"] for r in rs],
                "median": [r["median"] for r in rs],
                "launches": [r["profile"]["kernel_launches_per_frame"]
                             for r in rs],
                "device busy ms": [r["profile"]["device_busy_ms_per_frame"]
                                   for r in rs]}
        print(f"  {path}, in turns: " + "; ".join(
            f"{k} {', '.join(f'{v:.3f}' for v in vs)}"
            for k, vs in line.items()), flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--out", default=None,
                    help="also write the numbers to this JSON file")
    ap.add_argument("--frames", action="store_true",
                    help="only section 5: the frames in turns")
    ap.add_argument("--frame-worker", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if args.frame_worker is not None:
        frame_worker(args.other.resolve(), args.frame_worker)
        return
    if args.frames:
        print("5. the frames in turns (other, this, this, other)",
              flush=True)
        rows = frames_in_turns(args.other.resolve())
        if args.out:
            with open(args.out, "w") as fh:
                json.dump({"frames": rows}, fh, indent=1)
        print(json.dumps({"ok": True, "frames": {
            p: [round(r["mean"], 3) for r in rs] for p, rs in rows.items()}}))
        return
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from moshi_tpu_torch.kernels import build
    from moshi_tpu_torch.nn import decode_attention as da
    cs.CARD = cs.smi_line()
    print(f"card: {cs.CARD}", flush=True)
    build.build_all()
    for line in build.BUILD_LOG.get("decode_attention", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  this: {line.strip()}")
    log, takes_ws, takes_ws4 = build_other(args.other.resolve())
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  other: {line.strip()}")
    other_lib, this_lib = (OTHER_LIB, takes_ws), da.THIS_BUILD
    other4 = (OTHER_LIB, takes_ws4)
    temporal, depformer, stt, tts = geometry()
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("1. bit identity, other against this", flush=True)
    n = compare(gen, other_lib, this_lib, other4, temporal, depformer, stt,
                tts)
    print(f"  outputs bit-identical: {n}", flush=True)
    print("2. device time in turns (other, this, this, other)", flush=True)
    rows = timings(gen, other_lib, this_lib, other4, takes_ws, temporal,
                   depformer, stt, tts)
    log, new = build_rings(args.other.resolve())
    other_rings = ring_calls(RING_LIB, new)
    this_rings = ring_calls("ring_write", True)
    how = "through the port launcher" if new else "as its frame made them"
    print(f"3. ring writes, bit identity (the other build {how})",
          flush=True)
    rgen = torch.Generator(device="cuda").manual_seed(2)
    n_rings = compare_rings(rgen, other_rings, this_rings, stt, 32, temporal)
    print(f"  ring writes bit-identical: {n_rings}", flush=True)
    print("4. ring writes timed in turns (other, this, this, other)",
          flush=True)
    turns = [("other", (other_rings, new)), ("this", (this_rings, True)),
             ("this", (this_rings, True)), ("other", (other_rings, new))]
    ring_rows = ring_timings(rgen, turns, stt, tts, temporal)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": cs.CARD, "identical": n, "times": rows,
                       "rings_identical": n_rings, "ring_times": ring_rows},
                      fh, indent=1)
    print(json.dumps({"ok": True, "identical": n,
                      "rings_identical": n_rings}))


if __name__ == "__main__":
    main()
