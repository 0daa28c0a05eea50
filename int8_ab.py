#!/usr/bin/env python3
"""K1, the int8 matvec (``moshi_tpu_torch/csrc/int8_matvec.cu``), K5,
the fused out_proj + norm + GLU (``csrc/attn_ffn_fused.cu``), and K12,
K1's function split over K in its k-segment and split-spread forms
(``csrc/split_matvec.cu``), against the same sources in another checkout,
on one card: bit identity, device time in turns, and where each build's
time goes, stage by stage.

    python3 int8_ab.py OTHER [--stages] [--this ROOT] [--out F]

OTHER is the root of another checkout of this repository, for example
``mkdir -p build/other && git archive <commit> | tar -x -C build/other``.
Its ``csrc/`` (``int8_matvec.cu``, ``attn_ffn_fused.cu`` and
``split_matvec.cu`` with their own headers) is copied into ``build/ab/``
and built with this tree's nvcc flags (one nvcc per source, all
together).  K5 is called through this tree's launcher (``quant/fused.py``
``_launch``) for both builds.  K1 and K12 are called through the launcher
of their C interface: this tree's (``quant/matmul_int8.py`` ``_launch``,
``_launch_split``) for a source whose entry quantizes the activation
itself, and ``launch_k1_scratch`` / ``launch_k12_scratch`` (the caller's
scratch xq/dx/xs, a prep launch, then the matvec) for a source whose
entry takes that scratch, as the port's K1 and K12 did before each
became one launch a call.  ``--this ROOT`` takes another checkout's
sources for "this" (both builds from one commit measure that commit
alone).  Then:

1. every K1 product shape of the STS, TTS and ``sts_mxu`` frames
   (``SHAPES``) in every format code 0-4 (int8_dot.cuh: q4_k, q4_0, q8_0
   packed; q4_k and q4_0 in unpacked int8 storage), at m = 1, 2 and 8
   rows (unpacked storage at one row only), f32 and bf16 activations,
   without the norm and with it (f32 and bf16 alpha); and every K5 shape
   in the 25 (out_proj, linear_in) format pairs, with attn and hcur f32
   and bf16, f32 and bf16 alpha; each once more on activations and scales
   so small that the products fall below f32's normal range, and the GLU
   forms once more on activations so large that gates on both sides pass
   |g| = 90; and K12 in both forms at the 7B temporal linear_out (q4_k,
   O 4096, K 11264) at layers 0 and L-1 of a 32-layer weight, x f32 and
   bf16, without the norm and with it (f32 and bf16 alpha), on subnormal
   products and on ``chip_smoke.k12_tie_input``: the two builds' outputs
   (K5: g and h_mid) must agree bit for bit, and a second call of this
   build must repeat the first's bits;
2. each shape at the frame's format and rows (q4_k, and the unpacked q4_k
   of the ``--i8-storage`` frame), timed in turns (other, this, this,
   other; CUDA events, L2 flushed before each launch, as
   ``chip_smoke.time_ms``) beside one library call (bf16 ``torch.matmul``
   on the weight dequantized beforehand; for a GLU, then silu(gate) *
   value) and the bound; and the sums per frame of each path; each also
   timed in the same turns with L2 flushed by a 1 GiB read (``time_clean``:
   no dirty lines left to write back, as in a frame) and in a stream of
   back-to-back calls over enough layers that each finds its weights cold
   (``time_stream``: the frame's conditions, launches overlapping); and
   the 7B temporal stack's K1, K5, K1 calls a layer, 32 layers back to
   back, each call between CUDA events and, once a build, under
   ``torch.profiler`` (``temporal_frame``), and the same with each K12
   form in linear_out's place; K12's rows beside K1's linear_out;
3. ``--stages``: where the time goes.  Each build is copied once more
   with every warp stamping ``%globaltimer`` at the points ``FORMS``
   names (a text transform in ``build/ab/``, nothing in the sources), and
   each shape at one row in q4_k gives its stages (the mean of
   ``STAMP_REPS`` calls, each on cold weights right after a call on
   another layer): K1 the prep against the matvec, K5 quantize, out_proj,
   grid sync, norm, GLU, K12 the prep against the split matvec (a
   source with a prep launch) or the staging against the walk and fold.

Exits 1 at the first bit that differs.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
AB_DIR = ROOT / "build" / "ab"
REPS = 20
STAMP_REPS = 5
ROWS = (1, 2, 8)
CODES = (0, 1, 2, 3, 4)     # int8_dot.cuh's format codes
CODE_NAMES = {0: "q4_k", 1: "q4_0", 2: "q8_0", 3: "q4_k i8", 4: "q4_0 i8"}
F32, BF16 = torch.float32, torch.bfloat16
SATURATE = 64.0   # the GLU's large round: activations (K5: alpha) times this
SOURCES = ("int8_matvec", "attn_ffn_fused", "split_matvec")
K12_FORMS = {"kseg": "K12k", "split": "K12s"}
K12_LAYERS = 32   # the 7B temporal stack

# K1: (shape, O weight rows (2H for a GLU), K, fused norm, GLU, activation
# dtype, rows timed, calls per frame by path).  The STS frame's 122 calls
# (in_proj and linear_out per temporal layer, the text head, the depformer
# input projection, and per depformer step and layer the in_proj, per step
# the logits), sts_mxu's (linear_out on K12), and the TTS frame's 258 (per
# temporal layer the in_proj, out_proj, the cross-attention's query
# projection and out_proj, the GLU, linear_out; the text head, the
# depformer's input projection, per step and layer its in_proj, per step
# its logits); the TTS pool sends the temporal products at 8 rows under
# MOSHI_TPU_INT8_MAX_M.
K1_SHAPES = [
    ("temporal in_proj", 12288, 4096, True, False, F32, 1,
     {"sts": 32, "sts_mxu": 32}),
    ("temporal linear_out", 4096, 11264, False, False, BF16, 1, {"sts": 32}),
    ("text head", 32000, 4096, False, False, F32, 1,
     {"sts": 1, "sts_mxu": 1}),
    ("depformer in", 8192, 4096, False, False, BF16, 1,
     {"sts": 1, "sts_mxu": 1}),
    ("depformer in_proj", 3072, 1024, True, False, BF16, 1,
     {"sts": 48, "sts_mxu": 48, "tts": 128}),
    ("depformer logits", 2048, 1024, False, False, BF16, 1,
     {"sts": 8, "sts_mxu": 8, "tts": 32}),
    ("TTS temporal in_proj", 6144, 2048, True, False, F32, 1, {"tts": 16}),
    ("TTS temporal out_proj", 2048, 2048, False, False, F32, 1, {"tts": 16}),
    ("TTS cross in_proj (q)", 6144, 2048, False, False, F32, 1, {"tts": 16}),
    ("TTS cross out_proj", 2048, 2048, False, False, F32, 1, {"tts": 16}),
    ("TTS temporal linear_in (GLU)", 16896, 2048, True, True, F32, 1,
     {"tts": 16}),
    ("TTS temporal linear_out", 2048, 8448, False, False, F32, 1,
     {"tts": 16}),
    ("TTS text head", 8000, 2048, False, False, F32, 1, {"tts": 1}),
    ("TTS depformer in", 32768, 2048, False, False, BF16, 1, {"tts": 1}),
    ("TTS temporal linear_in (GLU), 8 rows", 16896, 2048, True, True, F32,
     8, {}),
    ("TTS temporal in_proj, 8 rows", 6144, 2048, True, False, F32, 8, {}),
]
# K5: (shape, K, H, hcur dtype, calls per frame by path)
# K12: the 7B temporal linear_out (O, K), bf16 activation, no norm; per
# frame on its path (sts_mxu: k-segment, lm_split: split-spread)
K12_SHAPE = ("temporal linear_out", 4096, 11264)
K12_CALLS = {"kseg": {"sts_mxu": 32}, "split": {"lm_split": 32}}
K5_SHAPES = [
    ("temporal", 4096, 11264, F32, {"sts": 32, "sts_mxu": 32}),
    ("depformer", 1024, 4224, BF16, {"sts": 48, "sts_mxu": 48, "tts": 128}),
]

# The stamp points of each source form: (file, anchor, text inserted
# before or after it, where).  Every warp's lane 0 stamps a point
# (``mt_stamp(point, slot)``, slot = the warp's index in the grid), so a
# stage's end is the last warp's and its start the first warp's.  A
# transform takes the first form whose anchors are each found once.
_P = "mt_stamp({}, MT_WARP_SLOT);"
FORMS = {
    "int8_matvec": [
        ("prep launch, then matvec", [
            ("int8_dot.cuh", "  __shared__ float red[32];\n",
             "  " + _P.format(0) + "\n", "after"),
            ("int8_dot.cuh",
             "    mt_i8::quant_block(v, i, b, lane, xq, dx, xs);\n  }\n}\n",
             "    mt_i8::quant_block(v, i, b, lane, xq, dx, xs);\n  }\n  "
             + _P.format(1) + "\n}\n", "replace"),
            ("int8_matvec.cu",
             "  if (o >= O) return;  // whole warps leave together\n",
             "  " + _P.format(2) + "\n", "after"),
            ("int8_matvec.cu",
             "            GLU ? g[m] * (1.f / (1.f + expf(-g[m]))) * v[m] : "
             "g[m];\n    }\n  }\n}\n",
             "            GLU ? g[m] * (1.f / (1.f + expf(-g[m]))) * v[m] : "
             "g[m];\n    }\n  }\n  " + _P.format(3) + "\n}\n", "replace"),
        ], [("prep", (0, "min"), (1, "max")),
            ("launch gap", (1, "max"), (2, "min")),
            ("matvec", (2, "min"), (3, "max"))]),
        ("one launch", [
            ("int8_matvec.cu", "  // stage: start\n",
             "  " + _P.format(0) + "\n", "after"),
            ("int8_matvec.cu", "  // stage: activation staged\n",
             "  " + _P.format(1) + "\n", "after"),
            ("int8_matvec.cu", "  // stage: end\n",
             "  " + _P.format(3) + "\n", "after"),
        ], [("prep", (0, "min"), (1, "max")),
            ("matvec after the prep", (1, "max"), (3, "max"))]),
    ],
    "attn_ffn_fused": [
        ("cooperative, stages 1-5", [
            ("attn_ffn_fused.cu",
             "  const int gwarps = gridDim.x * nwarps;\n",
             "  " + _P.format(0) + "\n", "after"),
            ("attn_ffn_fused.cu",
             "    mt_i8::quant_block(mt_load(attn, i, attn_bf16), i, b, lane,"
             " xq, dx, xs);\n  }\n  __syncthreads();\n",
             "  " + _P.format(1) + "\n", "after"),
            ("attn_ffn_fused.cu", "  cg::this_grid().sync();\n",
             "  " + _P.format(2) + "\n", "before"),
            ("attn_ffn_fused.cu", "  cg::this_grid().sync();\n",
             "  " + _P.format(3) + "\n", "after"),
            ("attn_ffn_fused.cu",
             "    mt_i8::quant_block(v, i, b, lane, xq, dx, xs);\n  }\n"
             "  __syncthreads();\n",
             "  " + _P.format(4) + "\n", "after"),
            ("attn_ffn_fused.cu",
             "    if (lane == 0) g[o] = gate * (1.f / (1.f + expf(-gate))) *"
             " val;\n  }\n}\n",
             "    if (lane == 0) g[o] = gate * (1.f / (1.f + expf(-gate))) *"
             " val;\n  }\n  " + _P.format(5) + "\n}\n", "replace"),
        ], None),
        ("cooperative, marked stages", [
            ("attn_ffn_fused.cu", "  // stage: start\n",
             "  " + _P.format(0) + "\n", "after"),
            ("attn_ffn_fused.cu", "  // stage: attn quantized\n",
             "  " + _P.format(1) + "\n", "after"),
            ("attn_ffn_fused.cu", "  // stage: out_proj done\n",
             "  " + _P.format(2) + "\n", "after"),
            ("attn_ffn_fused.cu", "  // stage: synced\n",
             "  " + _P.format(3) + "\n", "after"),
            ("attn_ffn_fused.cu", "  // stage: n2 quantized\n",
             "  " + _P.format(4) + "\n", "after"),
            ("attn_ffn_fused.cu", "  // stage: end\n",
             "  " + _P.format(5) + "\n", "after"),
        ], None),
    ],
    "split_matvec": [
        ("prep launch, then split matvec", [
            ("int8_dot.cuh", "  __shared__ float red[32];\n",
             "  " + _P.format(0) + "\n", "after"),
            ("int8_dot.cuh",
             "    mt_i8::quant_block(v, i, b, lane, xq, dx, xs);\n  }\n}\n",
             "    mt_i8::quant_block(v, i, b, lane, xq, dx, xs);\n  }\n  "
             + _P.format(1) + "\n}\n", "replace"),
            ("split_matvec.cu",
             "  __shared__ float part[ROWS][MAX_SEGS][32];\n",
             "  " + _P.format(2) + "\n", "after"),
            ("split_matvec.cu", "    if (lane == 0) y[o] = v;\n  }\n}\n",
             "    if (lane == 0) y[o] = v;\n  }\n  " + _P.format(3)
             + "\n}\n", "replace"),
        ], [("prep", (0, "min"), (1, "max")),
            ("launch gap", (1, "max"), (2, "min")),
            ("split matvec", (2, "min"), (3, "max"))]),
        ("one launch", [
            ("split_matvec.cu", "  // stage: start\n",
             "  " + _P.format(0) + "\n", "after"),
            ("split_matvec.cu", "  // stage: activation staged\n",
             "  " + _P.format(1) + "\n", "after"),
            ("split_matvec.cu", "  // stage: end\n",
             "  " + _P.format(3) + "\n", "after"),
        ], [("staging", (0, "min"), (1, "max")),
            ("walk and fold", (1, "max"), (3, "max"))]),
    ],
}
K5_STAGES = [("quantize", (0, "min"), (1, "max")),
             ("out_proj", (1, "max"), (2, "max")),
             ("grid sync", (2, "max"), (3, "max")),
             ("norm", (3, "max"), (4, "max")),
             ("GLU", (4, "max"), (5, "max"))]
POINTS, SLOTS = 8, 32768
_STAMP_DECL = f"""
// stage stamps (int8_ab.py --stages): lane 0 of each warp writes
// %globaltimer at a point, into its warp's slot
#define MT_POINTS {POINTS}
#define MT_SLOTS {SLOTS}
#define MT_WARP_SLOT ((int)(blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)))
__device__ unsigned long long mt_stamps[MT_POINTS * MT_SLOTS];
__device__ __forceinline__ void mt_stamp(int point, int slot) {{
  if ((threadIdx.x & 31) == 0 && slot < MT_SLOTS) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    mt_stamps[point * MT_SLOTS + slot] = t;
  }}
}}
"""
_STAMP_IO = """
extern "C" int mt_stamps_reset(void* stream) {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, mt_stamps);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(p, 0, sizeof(unsigned long long) * MT_POINTS *
                          MT_SLOTS, static_cast<cudaStream_t>(stream));
  return (int)err;
}
extern "C" int mt_read_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(
      dst, mt_stamps, sizeof(unsigned long long) * MT_POINTS * MT_SLOTS);
}
"""


def fail(msg: str):
    print(f"int8_ab: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _insert(text: str, anchor: str, piece: str, where: str) -> str:
    if where == "after":
        return text.replace(anchor, anchor + piece)
    if where == "before":
        return text.replace(anchor, piece + anchor)
    return text.replace(anchor, piece)


def stamp_form(source: str, files: dict):
    """The first of ``FORMS[source]`` whose anchors are each found once in
    ``files`` (name -> text): (label, points, stages); None if none."""
    for label, points, stages in FORMS[source]:
        if all(files.get(f, "").count(a) == 1 for f, a, _, _ in points):
            return label, points, stages or K5_STAGES
    return None


def stamped(source: str, files: dict) -> dict:
    """``files`` (name -> text of a csrc directory) with ``source``'s stamp
    points inserted, the stamp buffer declared in common.cuh and its
    reset and read entries appended to ``source``.cu."""
    form = stamp_form(source, files)
    if form is None:
        fail(f"{source}.cu: no stamp form finds its anchors")
    out = dict(files)
    for f, anchor, piece, where in form[1]:
        out[f] = _insert(out[f], anchor, piece, where)
    out["common.cuh"] = out["common.cuh"] + _STAMP_DECL
    out[f"{source}.cu"] = out[f"{source}.cu"] + _STAMP_IO
    return out


def k1_takes_scratch(csrc: Path) -> bool:
    """Does this source's K1 entry take the caller's xq/dx/xs scratch (a
    prep launch before the matvec)?"""
    return "int* launched" in (csrc / "int8_matvec.cu").read_text()


def build_libs(specs):
    """Build each (name, csrc dir, source, stamped?) as a copy under
    build/ab/ (one nvcc each, all together), and register it with the
    loader.  Raises if nvcc is missing.  Returns nvcc's logs by name."""
    from moshi_tpu_torch.kernels import build
    nvcc = build._nvcc()
    AB_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, csrc, source, stamps in specs:
        src_dir = AB_DIR / name
        if src_dir.exists():
            shutil.rmtree(src_dir)
        shutil.copytree(csrc, src_dir)
        if stamps:
            files = {p.name: p.read_text() for p in src_dir.iterdir()
                     if p.suffix in (".cu", ".cuh")}
            for fname, text in stamped(source, files).items():
                (src_dir / fname).write_text(text)
        out = AB_DIR / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(out),
             str(src_dir / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out)
    logs = {}
    for name, (proc, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            fail(f"nvcc {name}:\n{stdout}{stderr}")
        logs[name] = stdout + stderr
        lib = ctypes.CDLL(str(out))
        lib.mt_error_string.argtypes = [ctypes.c_int]
        lib.mt_error_string.restype = ctypes.c_char_p
        build._LIBS[name] = lib
    return logs


def launch_k1_scratch(lib, x, qt, layer, alpha, glu, o):
    """K1 through a C entry that takes the caller's scratch (xq [m, K] i8,
    dx/xs [m, K/32] f32) and launches the prep, then the matvec."""
    from moshi_tpu_torch.kernels import build
    from moshi_tpu_torch.quant import matmul_int8 as mi
    dev = x.device
    m, k = x.shape
    q, s1, s2, code = mi._weight_operands(qt, k, dev, "")
    nb = k // 32
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    dx = torch.empty((m, nb), dtype=torch.float32, device=dev)
    xs = torch.empty((m, nb), dtype=torch.float32, device=dev)
    y = torch.empty((m, o), dtype=torch.float32, device=dev)
    fn = build.entry(lib, "mt_int8_matvec", [
        build.VP, build.I32, build.VP, build.I32, build.I32, build.I32,
        build.VP, build.VP, build.VP, build.VP, build.VP, build.VP, build.VP,
        build.I32, build.I64, build.I32, build.I32, build.VP,
        ctypes.POINTER(ctypes.c_int)])
    launched = ctypes.c_int(0)
    err = fn(build.ptr(x), int(x.dtype == BF16),
             None if alpha is None else build.ptr(alpha),
             int(alpha is not None and alpha.dtype == BF16), m, k,
             build.ptr(xq), build.ptr(dx), build.ptr(xs), build.ptr(q),
             build.ptr(s1), None if s2 is None else build.ptr(s2),
             build.ptr(y), o, layer * qt.q.shape[-2], code, int(glu),
             build.stream_of(x), ctypes.byref(launched))
    build.check(err, lib, f"{lib} K={k} O={o}")
    return y


def k12_takes_scratch(csrc: Path) -> bool:
    """Does this source's K12 entry take the caller's xq/dx/xs scratch (a
    prep launch before the split matvec)?"""
    return "int* launched" in (csrc / "split_matvec.cu").read_text()


def launch_k12_scratch(lib, x, qt, layer, alpha, form, o):
    """K12 (``form`` "kseg" or "split") through a C entry that takes the
    caller's scratch (xq [1, K] i8, dx/xs [1, K/32] f32) and launches the
    prep, then the split matvec."""
    from moshi_tpu_torch.kernels import build
    k = x.shape[1]
    dev = x.device
    nb = k // 32
    xq = torch.empty((1, k), dtype=torch.int8, device=dev)
    dx = torch.empty((1, nb), dtype=torch.float32, device=dev)
    xs = torch.empty((1, nb), dtype=torch.float32, device=dev)
    y = torch.empty((1, o), dtype=torch.float32, device=dev)
    name = "int8_kseg" if form == "kseg" else "int8_split"
    fn = build.entry(lib, f"mt_{name}", [
        build.VP, build.I32, build.VP, build.I32, build.I32, build.VP,
        build.VP, build.VP, build.VP, build.VP, build.VP, build.VP,
        build.I32, build.I64, build.VP, ctypes.POINTER(ctypes.c_int)])
    launched = ctypes.c_int(0)
    err = fn(build.ptr(x), int(x.dtype == BF16),
             None if alpha is None else build.ptr(alpha),
             int(alpha is not None and alpha.dtype == BF16), k,
             build.ptr(xq), build.ptr(dx), build.ptr(xs), build.ptr(qt.q),
             build.ptr(qt.es), build.ptr(qt.em), build.ptr(y), o,
             layer * qt.q.shape[-2], build.stream_of(x),
             ctypes.byref(launched))
    build.check(err, lib, f"{lib} {name} K={k} O={o}")
    return y


class Builds:
    """The K1, K5 and K12 callables of each library by label."""

    def __init__(self, scratch: dict):
        self.scratch = scratch    # K1/K12 library name -> takes scratch

    def k1(self, lib, x, qt, layer, alpha, glu):
        from moshi_tpu_torch.quant import matmul_int8 as mi
        o = qt.q.shape[-2] // (2 if glu else 1)
        qt = qt.with_eff_scales()
        if self.scratch[lib]:
            return launch_k1_scratch(lib, x, qt, layer, alpha, glu, o)
        return mi._launch(x, qt, layer, alpha, glu, o, lib_name=lib)

    def k12(self, lib, x, qt, layer, alpha, form):
        from moshi_tpu_torch.quant import matmul_int8 as mi
        o = qt.q.shape[-2]
        qt = qt.with_eff_scales()
        if self.scratch[lib]:
            return launch_k12_scratch(lib, x, qt, layer, alpha, form, o)
        return mi._launch_split(x, qt, layer, alpha, o, form, lib_name=lib)

    @staticmethod
    def k5(lib, attn, hcur, out_qt, glu_qt, alpha, layer):
        from moshi_tpu_torch.quant import fused
        return fused._launch(attn, hcur, out_qt.with_eff_scales(),
                             glu_qt.with_eff_scales(), alpha, layer,
                             lib_name=lib)


def weight(code, o, k, layers, gen, scale=0.01, centered=False):
    """A random QuantTensor [layers, O, K] on the card in format ``code``
    (int8_dot.cuh's: 3 and 4 are q4_k and q4_0 in unpacked int8 storage):
    uniform values, scales |N(0, 1)| * ``scale`` (q4_0 and q8_0 signed);
    ``centered``: q4_k's em = 7.5 * es, so that its weights es * q - em
    have mean 0 as q4_0's and q8_0's do (a row of the GLU's gates then
    takes both signs on one normed activation)."""
    from moshi_tpu_torch.quant.formats import QK, QuantTensor
    fmt = {0: "q4_k", 1: "q4_0", 2: "q8_0", 3: "q4_k", 4: "q4_0"}[code]
    cols = k if fmt == "q8_0" else k // 2
    q = torch.randint(0, 256, (layers, o, cols), generator=gen,
                      device="cuda", dtype=torch.int32)
    q = q.to(torch.uint8) if fmt != "q8_0" else (q - 128).to(torch.int8)

    def sc(signed):
        s = torch.randn((layers, o, k // QK), generator=gen, device="cuda")
        return ((s if signed else s.abs()) * scale).to(BF16)

    if fmt == "q4_k":
        es = sc(False)
        em = (es.float() * 7.5).to(BF16) if centered else sc(False)
        qt = QuantTensor(fmt, (o, k), q=q, d=es, es=es, em=em)
    else:
        qt = QuantTensor(fmt, (o, k), q=q, d=sc(True))
    return qt.with_i8_storage() if code >= 3 else qt


def bits(t):
    return t.contiguous().view(torch.uint8)


def same(what, a, b):
    if not torch.equal(bits(a), bits(b)):
        bad = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        fail(f"{what}: {bad} of {a.numel()} outputs differ")
    return a.numel()


def gates_past(g_plain):
    """Counts of gates above 90 and below -90."""
    return int((g_plain > 90).sum()), int((g_plain < -90).sum())


def compare_k1(bl, other, this, gen):
    """Phase 1 for K1.  Returns the outputs compared."""
    from moshi_tpu_torch.quant import matmul_int8 as mi
    n = 0
    seen = set()
    for name, o, k, _, glu, _, _, _ in K1_SHAPES:
        if (o, k, glu) in seen:
            continue
        seen.add((o, k, glu))
        for code in CODES:
            rows = (1,) if code >= 3 else ROWS
            for scale in ("normal", "tiny") + (("large",) if glu else ()):
                tiny = scale == "tiny"
                qt = weight(code, o, k, 2, gen,
                            scale=2.0 ** -70 if tiny else 0.01)
                for norm in ((None, F32, BF16) if scale == "normal"
                             else (None,)):
                    alpha = (None if norm is None else
                             (1 + 0.1 * torch.randn(k, generator=gen,
                                                    device="cuda")).to(norm))
                    for m in rows:
                        for xdt in (F32, BF16):
                            x = torch.randn((m, k), generator=gen,
                                            device="cuda")
                            x = (x * 2.0 ** -60 if tiny else x * SATURATE
                                 if scale == "large" else x).to(xdt)
                            if scale == "large":
                                gp = mi.int8_matvec_plain(
                                    x, qt.with_eff_scales(), 1)
                                hi, lo = gates_past(gp[:, :o // 2])
                                if not (hi and lo):
                                    fail(f"K1 {name} {CODE_NAMES[code]} "
                                         f"m={m}: the large round has {hi} "
                                         f"gates above 90 and {lo} below "
                                         f"-90")
                            a = bl.k1(other, x, qt, 1, alpha, glu)
                            b = bl.k1(this, x, qt, 1, alpha, glu)
                            c = bl.k1(this, x, qt, 1, alpha, glu)
                            torch.cuda.synchronize()
                            what = (f"K1 {name} {CODE_NAMES[code]} O={o} "
                                    f"K={k} m={m} x {xdt} alpha {norm} "
                                    f"{scale}")
                            n += same(what, a, b)
                            same(what + " (second call)", b, c)
        print(f"  K1 {name:36s} O={o:5d} K={k:5d}: bit-identical in codes "
              f"0-4, m {list(ROWS)} (unpacked at 1), x f32 and bf16, "
              f"without the norm and with it (f32 and bf16 alpha), on "
              f"subnormal products" + (", and with gates past |g| = 90"
                                       if glu else ""), flush=True)
    return n


def compare_k5(bl, other, this, gen):
    """Phase 1 for K5.  Returns the outputs compared."""
    from moshi_tpu_torch.quant import matmul_int8 as mi
    n = 0
    for name, k, h, _, _ in K5_SHAPES:
        for scale in ("normal", "tiny", "large"):
            tiny = scale == "tiny"
            ws = 2.0 ** -70 if tiny else 0.01
            big = scale == "large"
            outs = [weight(c, k, k, 2, gen, ws, big) for c in CODES]
            glus = [weight(c, 2 * h, k, 2, gen, ws, big) for c in CODES]
            for co in CODES:
                for cg in CODES:
                    for adt, hdt, ndt in ((BF16, F32, BF16), (F32, BF16, F32),
                                          (BF16, BF16, F32),
                                          (F32, F32, BF16)):
                        attn = torch.randn(k, generator=gen, device="cuda")
                        hcur = torch.randn(k, generator=gen, device="cuda")
                        alpha = 1 + 0.1 * torch.randn(k, generator=gen,
                                                      device="cuda")
                        if tiny:
                            attn, hcur = attn * 2.0 ** -60, hcur * 2.0 ** -60
                        if scale == "large":
                            alpha = alpha * SATURATE
                        attn, hcur = attn.to(adt), hcur.to(hdt)
                        alpha = alpha.to(ndt)
                        if scale == "large" and adt == BF16 and hdt == F32:
                            o_plain = mi.int8_matvec_plain(
                                attn, outs[co].with_eff_scales(), 1)
                            g = mi.int8_matvec_plain(
                                hcur.float() + o_plain,
                                glus[cg].with_eff_scales(), 1, alpha)
                            hi, lo = gates_past(g[:h])
                            if not (hi and lo):
                                fail(f"K5 {name} {CODE_NAMES[co]}/"
                                     f"{CODE_NAMES[cg]}: the large round "
                                     f"has {hi} gates above 90 and {lo} "
                                     f"below -90")
                        res = [bl.k5(lib, attn, hcur, outs[co], glus[cg],
                                     alpha, 1) for lib in (other, this, this)]
                        torch.cuda.synchronize()
                        what = (f"K5 {name} {CODE_NAMES[co]}/"
                                f"{CODE_NAMES[cg]} attn {adt} hcur {hdt} "
                                f"alpha {ndt} {scale}")
                        for i, part in enumerate(("g", "h_mid")):
                            n += same(f"{what}: {part}", res[0][i],
                                      res[1][i])
                            same(f"{what}: {part} (second call)", res[1][i],
                                 res[2][i])
            del outs, glus
        print(f"  K5 {name:10s} K={k:5d} H={h:5d}: g and h_mid bit-"
              f"identical in the 25 format pairs, attn/hcur/alpha f32 and "
              f"bf16, on subnormal products and with gates past |g| = 90",
              flush=True)
    return n


def compare_k12(bl, other, this, gen):
    """Phase 1 for K12.  Returns the outputs compared."""
    import chip_smoke as cs
    name, o, k = K12_SHAPE
    n = 0
    for scale in ("normal", "tiny"):
        tiny = scale == "tiny"
        qt = weight(0, o, k, K12_LAYERS, gen,
                    scale=2.0 ** -70 if tiny else 0.01)
        cases = []
        for norm in ((None, F32, BF16) if not tiny else (None,)):
            alpha = (None if norm is None else
                     (1 + 0.1 * torch.randn(k, generator=gen,
                                            device="cuda")).to(norm))
            for xdt in (F32, BF16):
                x = torch.randn((1, k), generator=gen, device="cuda")
                cases.append((f"x {xdt} alpha {norm}",
                              (x * 2.0 ** -60 if tiny else x).to(xdt),
                              alpha))
        if not tiny:
            cases.append(("k12_tie_input", cs.k12_tie_input(k, 22), None))
        for form, kname in K12_FORMS.items():
            for what, x, alpha in cases:
                for layer in (0, K12_LAYERS - 1):
                    a = bl.k12(other, x, qt, layer, alpha, form)
                    b = bl.k12(this, x, qt, layer, alpha, form)
                    c = bl.k12(this, x, qt, layer, alpha, form)
                    torch.cuda.synchronize()
                    label = (f"{kname} {name} O={o} K={k} layer {layer} "
                             f"{what} {scale}")
                    n += same(label, a, b)
                    same(label + " (second call)", b, c)
        del qt
    print(f"  K12 {name:35s} O={o:5d} K={k:5d}: both forms bit-identical "
          f"at layers 0 and {K12_LAYERS - 1}, x f32 and bf16, without the "
          f"norm and with it (f32 and bf16 alpha), on subnormal products "
          f"and on k12_tie_input", flush=True)
    return n


def dense_bf16(qt, layer):
    """Layer ``layer`` of a weight from ``weight`` as a bf16 matrix: its
    values times the block scale (q4_k: es * q - em), as the kernels read
    them."""
    from moshi_tpu_torch.quant.formats import QK, _values
    v = _values(qt)[layer]
    if qt.fmt == "q4_k":
        w = (v * qt.es[layer].float().repeat_interleave(QK, dim=-1)
             - qt.em[layer].float().repeat_interleave(QK, dim=-1))
    else:
        w = v * qt.d[layer].float().repeat_interleave(QK, dim=-1)
    return w.to(BF16)


def time_clean(fn, reps: int) -> float:
    """``chip_smoke.time_ms`` with L2 flushed by reading 1 GiB instead of
    writing it: the launch finds L2 full of clean lines, as a frame's
    kernels find it (every weight read once), not of ~50 MB of dirty lines
    that its reads must first write back."""
    import chip_smoke as cs
    if cs._FLUSH is None:
        cs._FLUSH = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    flush = cs._FLUSH.view(torch.int64)
    fn(0)
    torch.cuda.synchronize()
    evs = []
    for i in range(reps):
        flush.sum()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(i)
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / reps


STREAM_BYTES = 160 * 2 ** 20   # weight bytes a stream cycles through


def stream_layers(layer_bytes: int) -> int:
    """Layers of a weight whose cycle exceeds L2 (50 MB) three times over."""
    return max(2, -(-STREAM_BYTES // layer_bytes))


def time_stream(fn, n_layers: int) -> float:
    """Device ms a call of ``fn(i)`` (layer i % n_layers) takes in a
    stream of back-to-back calls, as a frame's kernels run: one event pair
    around max(40, 2 * n_layers) calls on distinct layers, after a pass
    over them and a 1 GiB read (each call finds its weights cold and L2
    clean, and its launch overlaps the one before; the host's enqueueing
    is kept out of the window by a spin kernel before it)."""
    import chip_smoke as cs
    if cs._FLUSH is None:
        cs._FLUSH = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    reps = max(40, 2 * n_layers)
    for i in range(n_layers):
        fn(i)
    cs._FLUSH.view(torch.int64).sum()
    # the device spins while the host enqueues the calls (~40 us each),
    # so that the window holds device time alone
    torch.cuda._sleep(reps * 100_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(reps):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def library_k1(qt, x, glu):
    wd = dense_bf16(qt, 1)

    def run(i):
        y = torch.matmul(x[i % len(x)].to(BF16), wd.T)
        if glu:
            gate, value = y.float().chunk(2, dim=-1)
            y = torch.nn.functional.silu(gate) * value
        return y
    return run


def timings(bl, turns, gen):
    """Phase 2: each shape at the frame's format and rows, in turns;
    the sums per frame by path."""
    import chip_smoke as cs
    rows = []
    for code in (0, 3):
        for name, o, k, norm, glu, xdt, m, calls in K1_SHAPES:
            if code == 3 and (m > 1 or "sts" not in calls):
                continue
            qt = weight(code, o, k, 2, gen)
            alpha = ((1 + 0.1 * torch.randn(k, generator=gen,
                                            device="cuda")).to(BF16)
                     if norm else None)
            xs = [torch.randn((m, k), generator=gen, device="cuda").to(xdt)
                  for _ in range(4)]
            t = [cs.time_ms(lambda i, lib=lib: bl.k1(lib, xs[i % 4], qt, 1,
                                                     alpha, glu), REPS)
                 for _, lib in turns]
            t_lib = cs.time_ms(library_k1(qt, xs, glu), REPS)
            t_clean = [time_clean(lambda i, lib=lib: bl.k1(
                lib, xs[i % 4], qt, 1, alpha, glu), REPS)
                for _, lib in turns]
            nl = stream_layers(cs._qt_layer_bytes(qt, o))
            qs = weight(code, o, k, nl, gen)
            t_stream = [time_stream(lambda i, lib=lib: bl.k1(
                lib, xs[i % 4], qs, i % nl, alpha, glu), nl)
                for _, lib in turns]
            del qs
            out = o // 2 if glu else o
            nbytes = (cs._qt_layer_bytes(qt, o) + m * k * xs[0].element_size()
                      + (k * 2 if norm else 0) + m * out * 4)
            b_ms, b_by = cs.bound_ms(nbytes, 2.0 * m * o * k, "int8")
            paths = ({p + "_i8": c for p, c in calls.items() if p == "sts"}
                     if code == 3 else calls)
            rows.append({"kernel": "K1" + (" i8" if code == 3 else ""),
                         "shape": name, "O": o, "K": k, "m": m,
                         "code": code, "turns": [lb for lb, _ in turns],
                         "ms": t, "ms_clean_flush": t_clean,
                         "ms_stream": t_stream, "stream_layers": nl,
                         "library_ms": t_lib, "bound_ms": b_ms,
                         "bound_by": b_by, "calls": paths})
            print(f"  K1 {CODE_NAMES[code]:7s} {name:36s} m={m}: "
                  + ", ".join(f"{lb} {v * 1e3:7.1f}" for (lb, _), v in
                              zip(turns, t))
                  + f" us; lib {t_lib * 1e3:7.1f} us, bound "
                  f"{b_ms * 1e3:6.1f} us; clean flush "
                  + ", ".join(f"{v * 1e3:.1f}" for v in t_clean)
                  + " us; stream "
                  + ", ".join(f"{v * 1e3:.1f}" for v in t_stream)
                  + f" us  [{cs.CARD}]", flush=True)
    for code in (0, 3):
        for name, k, h, hdt, calls in K5_SHAPES:
            if code == 3 and "sts" not in calls:
                continue
            ow, gw = weight(code, k, k, 2, gen), weight(code, 2 * h, k, 2,
                                                        gen)
            alpha = (1 + 0.1 * torch.randn(k, generator=gen,
                                           device="cuda")).to(BF16)
            draws = [(torch.randn(k, generator=gen, device="cuda").to(BF16),
                      torch.randn(k, generator=gen, device="cuda").to(hdt))
                     for _ in range(4)]
            t = [cs.time_ms(lambda i, lib=lib: bl.k5(
                lib, *draws[i % 4], ow, gw, alpha, 1), REPS)
                for _, lib in turns]
            wo, wg = dense_bf16(ow, 1), dense_bf16(gw, 1)

            def run_lib(i):
                a, hc = draws[i % 4]
                torch.matmul(a, wo.T)
                torch.matmul(hc.to(BF16), wg.T)

            t_lib = cs.time_ms(run_lib, REPS)
            t_clean = [time_clean(lambda i, lib=lib: bl.k5(
                lib, *draws[i % 4], ow, gw, alpha, 1), REPS)
                for _, lib in turns]
            nl = stream_layers(cs._qt_layer_bytes(ow, k)
                               + cs._qt_layer_bytes(gw, 2 * h))
            os_, gs_ = weight(code, k, k, nl, gen), weight(code, 2 * h, k, nl,
                                                          gen)
            t_stream = [time_stream(lambda i, lib=lib: bl.k5(
                lib, *draws[i % 4], os_, gs_, alpha, i % nl), nl)
                for _, lib in turns]
            del os_, gs_
            nbytes = (cs._qt_layer_bytes(ow, k) + cs._qt_layer_bytes(gw, 2 * h)
                      + 2 * k + k * draws[0][1].element_size() + 2 * k
                      + h * 4 + k * 4)
            b_ms, b_by = cs.bound_ms(nbytes, 2.0 * k * (k + 2 * h), "int8")
            paths = ({p + "_i8": c for p, c in calls.items() if p == "sts"}
                     if code == 3 else calls)
            rows.append({"kernel": "K5" + (" i8" if code == 3 else ""),
                         "shape": name, "K": k, "H": h, "code": code,
                         "turns": [lb for lb, _ in turns], "ms": t,
                         "ms_clean_flush": t_clean, "ms_stream": t_stream,
                         "stream_layers": nl, "library_ms": t_lib,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "calls": paths})
            print(f"  K5 {CODE_NAMES[code]:7s} {name:36s}: "
                  + ", ".join(f"{lb} {v * 1e3:7.1f}" for (lb, _), v in
                              zip(turns, t))
                  + f" us; lib {t_lib * 1e3:7.1f} us, bound "
                  f"{b_ms * 1e3:6.1f} us; clean flush "
                  + ", ".join(f"{v * 1e3:.1f}" for v in t_clean)
                  + " us; stream "
                  + ", ".join(f"{v * 1e3:.1f}" for v in t_stream)
                  + f" us  [{cs.CARD}]", flush=True)
    rows += k12_timings(bl, turns, gen)
    sums = per_frame(rows)
    for (kernel, path), v in sorted(sums.items()):
        print(f"  {kernel} per {path} frame: "
              + ", ".join(f"{lb} {x:.4f}" for lb, x in
                          zip(v["turns"], v["ms"]))
              + f" ms; lib {v['library_ms']:.4f}, bound {v['bound_ms']:.4f}"
              f" ms; {v['calls']} calls; clean flush "
              + ", ".join(f"{lb} {x:.4f}" for lb, x in
                          zip(v["turns"], v["ms_clean_flush"]))
              + " ms; stream "
              + ", ".join(f"{lb} {x:.4f}" for lb, x in
                          zip(v["turns"], v["ms_stream"]))
              + f" ms  [{cs.CARD}]", flush=True)
    return rows, sums


def k12_timings(bl, turns, gen):
    """Phase 2 for K12: both forms at the 7B temporal linear_out (bf16 x,
    no norm) in the three harnesses, in turns, beside the library call
    and the bound (K1's linear_out is K1's row of the same shape)."""
    import chip_smoke as cs
    name, o, k = K12_SHAPE
    qt = weight(0, o, k, 2, gen)
    xs = [torch.randn((1, k), generator=gen, device="cuda").to(BF16)
          for _ in range(4)]
    t_lib = cs.time_ms(library_k1(qt, xs, False), REPS)
    nl = stream_layers(cs._qt_layer_bytes(qt, o))
    qs = weight(0, o, k, nl, gen)
    nbytes = cs._qt_layer_bytes(qt, o) + k * 2 + o * 4
    b_ms, b_by = cs.bound_ms(nbytes, 2.0 * o * k, "int8")
    rows = []
    for form, kname in K12_FORMS.items():
        t = [cs.time_ms(lambda i, lib=lib: bl.k12(lib, xs[i % 4], qt, 1,
                                                  None, form), REPS)
             for _, lib in turns]
        t_clean = [time_clean(lambda i, lib=lib: bl.k12(
            lib, xs[i % 4], qt, 1, None, form), REPS) for _, lib in turns]
        t_stream = [time_stream(lambda i, lib=lib: bl.k12(
            lib, xs[i % 4], qs, i % nl, None, form), nl)
            for _, lib in turns]
        rows.append({"kernel": kname, "shape": name, "O": o, "K": k,
                     "m": 1, "code": 0, "turns": [lb for lb, _ in turns],
                     "ms": t, "ms_clean_flush": t_clean,
                     "ms_stream": t_stream, "stream_layers": nl,
                     "library_ms": t_lib, "bound_ms": b_ms,
                     "bound_by": b_by, "calls": K12_CALLS[form]})
        print(f"  {kname:4s} q4_k    {name:36s} m=1: "
              + ", ".join(f"{lb} {v * 1e3:7.1f}" for (lb, _), v in
                          zip(turns, t))
              + f" us; lib {t_lib * 1e3:7.1f} us, bound "
              f"{b_ms * 1e3:6.1f} us; clean flush "
              + ", ".join(f"{v * 1e3:.1f}" for v in t_clean)
              + " us; stream "
              + ", ".join(f"{v * 1e3:.1f}" for v in t_stream)
              + f" us  [{cs.CARD}]", flush=True)
    del qs
    return rows


def temporal_frame(bl, turns, gen, layers: int = 32):
    """Phase 2b: the 7B temporal stack's K1 and K5 calls as a frame makes
    them, back to back: per layer K1 in_proj (norm, f32 x), K5, K1
    linear_out (bf16 x), over ``layers`` layers of random q4_k weights
    (each weight read once, cold), a CUDA event between every two calls
    and the host kept out of the window by a spin kernel.  Per turn, the
    mean device ms of each of the three calls, and again with each K12
    form in linear_out's place; and, for the first two turns, the
    kernels' own durations as ``torch.profiler`` reads them."""
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    d, hidden = 4096, 11264
    w_in = weight(0, 3 * d, d, layers, gen)
    w_out = weight(0, d, d, layers, gen)
    w_glu = weight(0, 2 * hidden, d, layers, gen)
    w_lo = weight(0, d, hidden, layers, gen)
    n1 = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(BF16)
    n2 = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(BF16)
    x = torch.randn((1, d), generator=gen, device="cuda")
    attn = torch.randn(d, generator=gen, device="cuda").to(BF16)
    hcur = torch.randn(d, generator=gen, device="cuda")
    xl = torch.randn((1, hidden), generator=gen, device="cuda").to(BF16)
    def names(form):
        return ("K1 in_proj", "K5", "K1 linear_out" if form is None else
                f"{K12_FORMS[form]} linear_out")

    def calls(libs, lyr, form):
        return (lambda: bl.k1(libs, x, w_in, lyr, n1, False),
                lambda: bl.k5(libs, attn, hcur, w_out, w_glu, n2, lyr),
                (lambda: bl.k1(libs, xl, w_lo, lyr, None, False))
                if form is None else
                (lambda: bl.k12(libs, xl, w_lo, lyr, None, form)))

    def run(libs, form=None):
        evs = []
        cs._FLUSH.view(torch.int64).sum()
        torch.cuda._sleep(layers * 3 * 120_000)
        for lyr in range(layers):
            for fn in calls(libs, lyr, form):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                evs.append((a, b))
        torch.cuda.synchronize()
        ms = [0.0] * 3
        for i, (a, b) in enumerate(evs):
            ms[i % 3] += a.elapsed_time(b) / layers
        return ms

    out = {"layers": layers, "turns": []}
    for label, libs in turns:
        rec = {"turn": label}
        for form in (None, *K12_FORMS):
            run(libs, form)
            ms = run(libs, form)
            rec["ms" if form is None else f"ms {K12_FORMS[form]}"] = dict(
                zip(names(form), ms))
            print(f"  {label:5s} temporal frame, per call: " + ", ".join(
                f"{n} {v * 1e3:.1f}" for n, v in zip(names(form), ms))
                + f" us (x{layers})  [{cs.CARD}]", flush=True)
        out["turns"].append(rec)
    for label, libs in turns[:2]:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(libs)
        kern = {}
        for e in prof.key_averages():
            key = ("K5" if "fused_kernel" in e.key else "K1" if
                   "matvec_kernel" in e.key else "K1 prep" if "prep_kernel"
                   in e.key else None)
            if key:
                dev = getattr(e, "device_time_total",
                              getattr(e, "cuda_time_total", 0))
                kern[key] = kern.get(key, 0.0) + dev / 1e3 / layers
        out[f"profiler {label}"] = kern
        print(f"  {label:5s} temporal frame, profiler ms a layer: "
              + ", ".join(f"{k} {v:.4f}" for k, v in kern.items())
              + f"  [{cs.CARD}]", flush=True)
    return out


def per_frame(rows):
    """ms per frame by (kernel, path): each row times its calls there."""
    sums = {}
    for r in rows:
        for path, c in r["calls"].items():
            s = sums.setdefault((r["kernel"], path), {
                "turns": r["turns"], "ms": [0.0] * len(r["ms"]),
                "library_ms": 0.0, "bound_ms": 0.0, "calls": 0})
            s["ms"] = [a + c * b for a, b in zip(s["ms"], r["ms"])]
            for key in ("ms_clean_flush", "ms_stream"):
                s.setdefault(key, [0.0] * len(r[key]))
                s[key] = [a + c * b for a, b in zip(s[key], r[key])]
            s["library_ms"] += c * r["library_ms"]
            s["bound_ms"] += c * r["bound_ms"]
            s["calls"] += c
    return sums


def reset_stamps(lib):
    from moshi_tpu_torch.kernels import build
    fn = build._LIBS[lib].mt_stamps_reset
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if fn(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)):
        fail(f"{lib}: resetting the stamps failed")


def read_points(lib):
    """(min, max) in ns of each stamp point over the warps that wrote it
    (None where none did)."""
    from moshi_tpu_torch.kernels import build
    fn = build._LIBS[lib].mt_read_stamps
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = torch.zeros(POINTS * SLOTS, dtype=torch.int64)
    if fn(ctypes.c_void_p(buf.data_ptr())):
        fail(f"{lib}: reading the stamps failed")
    out = []
    for p in buf.view(POINTS, SLOTS):
        v = p[p > 0]
        out.append((int(v.min()), int(v.max())) if v.numel() else None)
    return out


def split(lib, stages, call, n_layers, before=None):
    """Mean ms of each stage over STAMP_REPS calls of ``call(layer)``, each
    on a layer whose weights are cold, right after a call on another layer
    (L2 holds that call's clean lines, as in a frame), or after
    ``before(layer)`` where given."""
    call(0)
    torch.cuda.synchronize()
    per = {name: 0.0 for name, _, _ in stages}
    for rep in range(STAMP_REPS):
        if before is None:
            call((2 * rep + 1) % n_layers)
        reset_stamps(lib)
        if before is not None:
            before((2 * rep + 2) % n_layers)
        call((2 * rep + 2) % n_layers)
        torch.cuda.synchronize()
        pts = read_points(lib)
        for name, (pa, ka), (pb, kb) in stages:
            if pts[pa] is None or pts[pb] is None:
                fail(f"{lib}: stage {name} has no stamps")
            a = pts[pa][0 if ka == "min" else 1]
            b = pts[pb][0 if kb == "min" else 1]
            per[name] += (b - a) / 1e6 / STAMP_REPS
    return per


def stage_split(bl, libs, forms, gen):
    """Phase 3: each shape at one row in q4_k, its stages in each stamped
    library ((label, K1 library, K5 library, K12 library))."""
    import chip_smoke as cs
    out = {}
    for name, o, k, norm, glu, xdt, m, calls in K1_SHAPES:
        if m != 1:
            continue
        qt = weight(0, o, k, 1, gen)
        nl = max(3, stream_layers(cs._qt_layer_bytes(qt, o)))
        qt = weight(0, o, k, nl, gen)
        alpha = ((1 + 0.1 * torch.randn(k, generator=gen, device="cuda"))
                 .to(BF16) if norm else None)
        x = torch.randn((1, k), generator=gen, device="cuda").to(xdt)
        for label, k1, _, _ in libs:
            per = split(k1, forms[k1][2],
                        lambda j: bl.k1(k1, x, qt, j, alpha, glu), nl)
            out[f"{label} K1 {name}"] = per
            print(f"  {label:5s} K1 {name:36s}: " + ", ".join(
                f"{s} {v * 1e3:.2f}" for s, v in per.items())
                + f" us  [{cs.CARD}]", flush=True)
        del qt
    name, o, k = K12_SHAPE
    qt = weight(0, o, k, 1, gen)
    nl = max(3, stream_layers(cs._qt_layer_bytes(qt, o)))
    qt = weight(0, o, k, nl, gen)
    x = torch.randn((1, k), generator=gen, device="cuda").to(BF16)
    for form, kname in K12_FORMS.items():
        for label, _, _, k12 in libs:
            per = split(k12, forms[k12][2],
                        lambda j: bl.k12(k12, x, qt, j, None, form), nl)
            out[f"{label} {kname} {name}"] = per
            print(f"  {label:5s} {kname} {name:35s}: " + ", ".join(
                f"{s} {v * 1e3:.2f}" for s, v in per.items())
                + f" us  [{cs.CARD}]", flush=True)
    del qt
    for name, k, h, hdt, calls in K5_SHAPES:
        ow = weight(0, k, k, 1, gen)
        gw = weight(0, 2 * h, k, 1, gen)
        nl = max(3, stream_layers(cs._qt_layer_bytes(ow, k)
                                  + cs._qt_layer_bytes(gw, 2 * h)))
        ow, gw = weight(0, k, k, nl, gen), weight(0, 2 * h, k, nl, gen)
        alpha = (1 + 0.1 * torch.randn(k, generator=gen,
                                       device="cuda")).to(BF16)
        a = torch.randn(k, generator=gen, device="cuda").to(BF16)
        hc = torch.randn(k, generator=gen, device="cuda").to(hdt)
        for label, k1, k5, _ in libs:
            per = split(k5, forms[k5][2],
                        lambda j: bl.k5(k5, a, hc, ow, gw, alpha, j), nl)
            out[f"{label} K5 {name}"] = per
            print(f"  {label:5s} K5 {name:36s}: " + ", ".join(
                f"{s} {v * 1e3:.2f}" for s, v in per.items())
                + f" us  [{cs.CARD}]", flush=True)
        if name == "temporal":
            # as the frame has it: the layer's K1 in_proj (this tree's
            # K1) just before
            wi = weight(0, 3 * k, k, nl, gen)
            xi = torch.randn((1, k), generator=gen, device="cuda")
            for label, k1, k5, _ in libs:
                k1p = k1.replace("_stamped", "")
                per = split(k5, forms[k5][2],
                            lambda j: bl.k5(k5, a, hc, ow, gw, alpha, j), nl,
                            before=lambda j: bl.k1(k1p, xi, wi, j, alpha,
                                                   False))
                out[f"{label} K5 {name} after K1 in_proj"] = per
                print(f"  {label:5s} K5 {name + ' after K1 in_proj':36s}: "
                      + ", ".join(f"{s} {v * 1e3:.2f}" for s, v in
                                  per.items()) + f" us  [{cs.CARD}]",
                      flush=True)
            del wi
        del ow, gw
    return out


def csrc_files(csrc: Path) -> dict:
    return {p.name: p.read_text() for p in csrc.iterdir()
            if p.suffix in (".cu", ".cuh")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--out", default=None,
                    help="also write the numbers to this JSON file")
    ap.add_argument("--stages", action="store_true",
                    help="also split each build's time by stage")
    ap.add_argument("--this", type=Path, default=ROOT, dest="this_root",
                    help="root of the checkout whose sources play 'this' "
                         "(default: this one)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from moshi_tpu_torch.kernels import build
    cs.CARD = cs.smi_line()
    print(f"card: {cs.CARD}", flush=True)
    this_csrc = args.this_root.resolve() / "moshi_tpu_torch" / "csrc"
    other_csrc = args.other.resolve() / "moshi_tpu_torch" / "csrc"
    specs = [(f"{s}_other", other_csrc, s, False) for s in SOURCES]
    specs += [(f"{s}_this", this_csrc, s, False) for s in SOURCES]
    if args.stages:
        specs += [(f"{s}_{t}_stamped", c, s, True) for s in SOURCES
                  for t, c in (("other", other_csrc), ("this", this_csrc))]
    for name, text in build_libs(specs).items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    scratch = {f"{src}_{t}{s}": takes(c)
               for src, takes in (("int8_matvec", k1_takes_scratch),
                                  ("split_matvec", k12_takes_scratch))
               for t, c in (("other", other_csrc), ("this", this_csrc))
               for s in ("", "_stamped")}
    bl = Builds(scratch)
    report = {"card": cs.CARD, "takes_scratch": scratch}
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("1. bit identity, other against this", flush=True)
    report["identical"] = {
        "K1": compare_k1(bl, "int8_matvec_other", "int8_matvec_this", gen),
        "K5": compare_k5(bl, "attn_ffn_fused_other", "attn_ffn_fused_this",
                         gen),
        "K12": compare_k12(bl, "split_matvec_other", "split_matvec_this",
                           gen)}
    print(f"   outputs compared: {report['identical']}", flush=True)
    print("2. device time in turns (other, this, this, other)", flush=True)
    turns = tuple((t, tuple(f"{s}_{t}" for s in SOURCES))
                  for t in ("other", "this", "this", "other"))

    class Turns(Builds):
        """The same calls, with a turn's (K1, K5, K12) libraries."""

        def k1(self, libs, *a):
            return Builds.k1(self, libs[0], *a)

        def k5(self, libs, *a):
            return Builds.k5(libs[1], *a)

        def k12(self, libs, *a):
            return Builds.k12(self, libs[2], *a)

    rows, sums = timings(Turns(scratch), turns, gen)
    report["temporal_frame"] = temporal_frame(Turns(scratch), turns, gen)
    report["times"] = rows
    report["per_frame"] = {f"{k} {p}": v for (k, p), v in sums.items()}
    if args.stages:
        print("3. where the time goes: stages (each warp's %globaltimer at "
              "the stamp points)", flush=True)
        forms = {}
        for t, c in (("other", other_csrc), ("this", this_csrc)):
            files = csrc_files(c)
            for s in SOURCES:
                forms[f"{s}_{t}_stamped"] = stamp_form(s, files)
                print(f"  {t} {s}: stamp form "
                      f"\"{forms[f'{s}_{t}_stamped'][0]}\"", flush=True)
        report["stages"] = stage_split(
            bl, [(t, *(f"{s}_{t}_stamped" for s in SOURCES))
                 for t in ("other", "this")], forms, gen)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps({"ok": True, "identical": report["identical"]}))


if __name__ == "__main__":
    main()
