#!/usr/bin/env python3
"""The dequant kernels, K2 and K6 (``moshi_tpu_torch/csrc/dequant_matvec.cu``)
and the dequant GLU, K7 and K8 (``csrc/glu_matvec.cu``), against the same
sources in another checkout, on one card: bit identity and device time in
turns.

    python3 dequant_ab.py OTHER [--out F]

OTHER is the root of another checkout of this repository, for example
``mkdir -p build/other && git archive <commit> | tar -x -C build/other``.
Its ``dequant_matvec.cu`` and ``glu_matvec.cu`` (each with its own
headers) are built with this tree's nvcc flags into ``build/ab/`` and
called through the port's launcher (``quant/matmul.py`` ``_launch``);
this tree's are called through the same launcher.  Then:

1. every K2 and K6 product shape of the 7B frame, the B = 8 pool and the
   TTS pool (``SHAPES``), in q4_k, q4_0 and q8_0, and every K7 and K8
   GLU shape of the pools (and one of odd H, whose last tile clamps its
   rows), in q4_k and q8_0; each with and without the fused norm (f32
   and bf16 alpha), at m = 1, 2, 8 and 12 rows, on random weights and
   activations, once more on activations and scales so small that the
   products fall below f32's normal range (where a fused multiply-add and
   a rounded product differ), and for the GLU once more on activations so
   large that gates on both sides pass |g| = 90 (where exp(-g) overflows
   or underflows): the two builds' outputs must agree bit for bit;
2. ``chip_smoke.check_dequant_probe`` on this tree's build;
3. each shape at its own format and rows, timed in turns (other, this,
   this, other; CUDA events, L2 flushed before each launch, as
   ``chip_smoke.time_ms``) beside one library call (bf16 ``torch.matmul``
   on the weight dequantized beforehand; for the GLU, then silu(gate) *
   value) and the bound.

Exits 1 at the first disagreement.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
REPS = 20
ROWS = (1, 2, 8, 12)
FORMATS = {"K2": ("q4_k", "q4_0", "q8_0"), "K6": ("q4_k", "q4_0", "q8_0"),
           "K7": ("q4_k", "q8_0"), "K8": ("q4_k", "q8_0")}
F32, BF16 = torch.float32, torch.bfloat16
SATURATE = 64.0   # the GLU's large round: activations times this, no norm
# (kernel, shape, O, K, format, fused norm, activation dtype, timed rows);
# O counts weight rows, 2H for a GLU
SHAPES = [
    ("K2", "temporal in_proj", 12288, 4096, "q4_k", True, F32, 8),
    ("K2", "temporal out_proj", 4096, 4096, "q4_k", False, BF16, 8),
    ("K2", "temporal linear_out", 4096, 11264, "q4_k", False, BF16, 8),
    ("K2", "depformer in_proj", 3072, 1024, "q4_k", True, BF16, 8),
    ("K2", "depformer out_proj", 1024, 1024, "q4_k", False, BF16, 8),
    ("K2", "depformer linear_out", 1024, 4224, "q4_0", False, BF16, 8),
    ("K2", "depformer logits", 2048, 1024, "q4_k", False, BF16, 8),
    ("K6", "text head", 32000, 4096, "q4_k", False, F32, 8),
    ("K6", "depformer in", 8192, 4096, "q4_k", False, BF16, 8),
    ("K2", "depformer linear_out", 1024, 4224, "q4_0", False, BF16, 1),
    ("K6", "TTS temporal in_proj", 6144, 2048, "q4_k", True, F32, 8),
    ("K6", "TTS temporal out_proj", 2048, 2048, "q4_k", False, F32, 8),
    ("K6", "TTS temporal linear_out", 2048, 8448, "q4_k", False, F32, 8),
    ("K6", "TTS text head", 8000, 2048, "q4_k", False, F32, 8),
    ("K6", "TTS depformer in", 32768, 2048, "q4_k", False, BF16, 8),
    ("K8", "temporal linear_in (GLU)", 22528, 4096, "q4_k", True, F32, 8),
    ("K8", "depformer linear_in (GLU)", 8448, 1024, "q4_k", True, BF16, 8),
    ("K7", "TTS temporal linear_in (GLU)", 16896, 2048, "q4_k", True, F32,
     8),
    ("K8", "odd H (GLU)", 2050, 1024, "q4_k", False, BF16, 8),
]
GLU = ("K7", "K8")
# the other checkout's libraries, by source
_OTHER = {"dequant_matvec": "dequant_matvec_other",
          "glu_matvec": "glu_matvec_other"}


def fail(msg: str):
    print(f"dequant_ab: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def build_other(other: Path) -> str:
    """Build OTHER's dequant_matvec.cu and glu_matvec.cu (one nvcc each,
    together) and register them with the loader."""
    from moshi_tpu_torch.kernels import build
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src_name, lib_name in _OTHER.items():
        src = other / "moshi_tpu_torch" / "csrc" / f"{src_name}.cu"
        out = out_dir / f"{lib_name}.so"
        procs[lib_name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            src, out)
    log = ""
    for lib_name, (proc, src, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            fail(f"nvcc {src}:\n{stdout}{stderr}")
        log += stdout + stderr
        lib = ctypes.CDLL(str(out))
        lib.mt_error_string.argtypes = [ctypes.c_int]
        lib.mt_error_string.restype = ctypes.c_char_p
        build._LIBS[lib_name] = lib
    return log


def weight(fmt, o, k, layers, gen, scale=0.01):
    """A random QuantTensor [layers, O, K] (flat if layers is 1) on the
    card: uniform packed values, scales |N(0, 1)| * ``scale`` (q4_0 and
    q8_0 signed)."""
    from moshi_tpu_torch.quant.formats import QK, QuantTensor
    lead = (layers,) if layers > 1 else ()
    cols = k if fmt == "q8_0" else k // 2
    q = torch.randint(0, 256, lead + (o, cols), generator=gen,
                      device="cuda", dtype=torch.int32)
    q = q.to(torch.uint8) if fmt != "q8_0" else (q - 128).to(torch.int8)

    def sc(signed):
        s = torch.randn(lead + (o, k // QK), generator=gen, device="cuda")
        return ((s if signed else s.abs()) * scale).to(BF16)

    if fmt == "q4_k":
        es = sc(False)
        return QuantTensor(fmt, (o, k), q=q, d=es, es=es, em=sc(False))
    return QuantTensor(fmt, (o, k), q=q, d=sc(True))


def flat(kernel) -> bool:
    """K6 and K7 take a flat weight; K2 and K8 a layer of a stacked one."""
    return kernel in ("K6", "K7")


def launchers(kernel, qt, layer):
    """(other, this) callables x, alpha -> y for one product."""
    from moshi_tpu_torch.quant import matmul as mm
    rows = qt.q.shape[-2]
    out = rows // 2 if kernel in GLU else rows
    row0 = None if flat(kernel) else layer * rows
    mine = {"K2": mm._K2, "K6": mm._K6, "K7": mm._K7, "K8": mm._K8}[kernel]
    theirs = (_OTHER[mine[0]], mine[1], "dequant_ab_other")

    def make(spec):
        return lambda x, a: mm._launch(spec, x, qt, a, out, row0)

    return make(theirs), make(mine)


def saturated(x, qt, layer):
    """Counts of gates above 90 and below -90 of the plain version's GLU
    gates for x (no norm)."""
    from moshi_tpu_torch.quant import matmul as mm
    g = mm._dequant_product(x, qt.with_eff_scales(), layer)
    g = g[:, :g.shape[-1] // 2]
    return int((g > 90).sum()), int((g < -90).sum())


def compare(gen):
    """Phase 1: bit identity over shapes, formats, norm and rows.  Returns
    the products compared, by kernel."""
    seen, n = set(), {}
    for kernel, name, o, k, _, _, xdt, _ in SHAPES:
        glu = kernel in GLU
        for fmt in FORMATS[kernel]:
            if (kernel, o, k, fmt, xdt) in seen:
                continue
            seen.add((kernel, o, k, fmt, xdt))
            layers = 1 if flat(kernel) else 2
            layer = layers - 1
            for scale in ("normal", "tiny") + (("large",) if glu else ()):
                tiny = scale == "tiny"
                qt = weight(fmt, o, k, layers, gen,
                            scale=2.0 ** -70 if tiny else 0.01)
                theirs, mine = launchers(kernel, qt, layer)
                for norm in ((None, F32, BF16) if scale == "normal"
                             else (None,)):
                    alpha = (None if norm is None else
                             (1 + 0.1 * torch.randn(k, generator=gen,
                                                    device="cuda")).to(norm))
                    for m in ROWS:
                        x = torch.randn((m, k), generator=gen, device="cuda")
                        x = (x * 2.0 ** -60 if tiny else
                             x * SATURATE if scale == "large" else x).to(xdt)
                        if scale == "large":
                            hi, lo = saturated(x, qt, layer)
                            if not (hi and lo):
                                fail(f"{kernel} {name} {fmt} m={m}: the "
                                     f"large round has {hi} gates above "
                                     f"90 and {lo} below -90")
                        a, b = theirs(x, alpha), mine(x, alpha)
                        torch.cuda.synchronize()
                        if not torch.equal(a.view(torch.int32),
                                           b.view(torch.int32)):
                            bad = int((a.view(torch.int32)
                                       != b.view(torch.int32)).sum())
                            fail(f"{kernel} {name} {fmt} O={o} K={k} m={m} "
                                 f"alpha {norm} {scale}: {bad} of "
                                 f"{a.numel()} outputs differ")
                        n[kernel] = n.get(kernel, 0) + 1
            print(f"  {kernel} {name:28s} {fmt} O={o:5d} K={k:5d}: bit-"
                  f"identical at m {list(ROWS)}, without the norm and with "
                  f"it (f32 and bf16 alpha), and on subnormal products"
                  + (", and with gates past |g| = 90" if glu else ""),
                  flush=True)
    return n


def timings(gen):
    """Phase 3: each shape at its format and rows, in turns."""
    import chip_smoke as cs
    from moshi_tpu_torch.quant import matmul as mm
    rows = []
    for kernel, name, o, k, fmt, norm, xdt, m in SHAPES:
        glu = kernel in GLU
        out = o // 2 if glu else o
        layers = 1 if flat(kernel) else 2
        qt = weight(fmt, o, k, layers, gen)
        theirs, mine = launchers(kernel, qt, layers - 1)
        alpha = ((1 + 0.1 * torch.randn(k, generator=gen, device="cuda"))
                 .to(BF16) if norm else None)     # the model's norms: bf16
        xs = [torch.randn((m, k), generator=gen, device="cuda").to(xdt)
              for _ in range(4)]
        t = {}
        for turn, fn in (("other", theirs), ("this", mine), ("this2", mine),
                         ("other2", theirs)):
            t[turn] = cs.time_ms(lambda i, fn=fn: fn(xs[i % 4], alpha), REPS)
        wd = mm.dequantize_layer_bf16(qt, layers - 1)

        def run_lib(i):
            y = torch.matmul(xs[i % 4].to(BF16), wd.T)
            if glu:
                gate, value = y.float().chunk(2, dim=-1)
                y = torch.nn.functional.silu(gate) * value
            return y

        t_lib = cs.time_ms(run_lib, REPS)
        nbytes = (cs._qt_layer_bytes(qt, o) + m * k * xs[0].element_size()
                  + (k * 2 if norm else 0) + m * out * 4)
        b_ms, b_by = cs.bound_ms(nbytes, 2.0 * m * o * k, "bf16")
        row = {"kernel": kernel, "shape": name, "O": o, "K": k, "fmt": fmt,
               "norm": norm, "m": m, "other_ms": [t["other"], t["other2"]],
               "this_ms": [t["this"], t["this2"]], "library_ms": t_lib,
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        print(f"  {kernel} {name:28s} {fmt} O={o:5d} K={k:5d} m={m}: other "
              f"{t['other'] * 1e3:8.1f} us, this {t['this'] * 1e3:7.1f} us, "
              f"this {t['this2'] * 1e3:7.1f} us, other "
              f"{t['other2'] * 1e3:8.1f} us; lib {t_lib * 1e3:6.1f} us, "
              f"bound {b_ms * 1e3:5.1f} us  [{cs.CARD}]", flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path,
                    help="root of the other checkout")
    ap.add_argument("--out", default=None,
                    help="also write the numbers to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from moshi_tpu_torch.kernels import build
    cs.CARD = cs.smi_line()
    print(f"card: {cs.CARD}", flush=True)
    build.build_all()
    for src in _OTHER:
        for line in build.BUILD_LOG.get(src, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  this: {line.strip()}")
    for line in build_other(args.other.resolve()).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  other: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("1. bit identity, other against this", flush=True)
    n = compare(gen)
    print(f"  products bit-identical: {n}", flush=True)
    print("2. the dequantization probe (this build)", flush=True)
    probe = cs.check_dequant_probe()
    print("3. device time in turns (other, this, this, other)", flush=True)
    rows = timings(gen)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": cs.CARD, "identical": n, "probe": probe,
                       "times": rows}, fh, indent=1)
    print(json.dumps({"ok": True, "identical": n}))


if __name__ == "__main__":
    main()
