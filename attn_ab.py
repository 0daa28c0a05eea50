#!/usr/bin/env python3
"""The decode attention kernels, K3 (bf16 and fp8 rings), K10 and K9
(``moshi_tpu_torch/csrc/decode_attention.cu``), against the same source
in another checkout, on one card: bit identity and device time in turns.

    python3 attn_ab.py OTHER [--out F]

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
   over 3.35 TB/s), with the blocks per call of each build.

Exits 1 at the first disagreement.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
REPS = 20
DRAWS = 3
BF16 = torch.bfloat16
OTHER_LIB = "decode_attention_other"
YOUNG = [4, 6, 8, 10, 12, 14, 16, 18]   # a pool's ages in its first ticks


def fail(msg: str):
    print(f"attn_ab: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def build_other(other: Path):
    """Build OTHER's decode_attention.cu and register it with the loader;
    returns (nvcc's log, whether its K3/K10 entries take a workspace,
    whether its K9 entries do)."""
    from moshi_tpu_torch.kernels import build
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = other / "moshi_tpu_torch" / "csrc" / "decode_attention.cu"
    out = out_dir / f"{OTHER_LIB}.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
        capture_output=True, text=True)
    if proc.returncode:
        fail(f"nvcc {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.mt_error_string.argtypes = [ctypes.c_int]
    lib.mt_error_string.restype = ctypes.c_char_p
    build._LIBS[OTHER_LIB] = lib
    text = src.read_text()
    k9_ws = re.search(r"mt_decode_attention4\([^)]*parts_len", text)
    return proc.stdout + proc.stderr, "parts_len" in text, k9_ws is not None


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--out", default=None,
                    help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
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
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": cs.CARD, "identical": n, "times": rows}, fh,
                      indent=1)
    print(json.dumps({"ok": True, "identical": n}))


if __name__ == "__main__":
    main()
