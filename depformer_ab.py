#!/usr/bin/env python3
"""K14, the depformer megakernels (``moshi_tpu_torch/csrc/dep_step.cu``:
K14a ``mt_dep_full_step``, K14c ``mt_dep_frame_step``), against the same
source in another checkout, on one card: bit identity, device time in
turns, and where each build's time goes, stage by stage.

    python3 depformer_ab.py OTHER [--out F] [--stages] [--set NAME=VALUE ...]

OTHER is the root of another checkout of this repository, for example
``mkdir -p build/other && git archive <commit> | tar -x -C build/other``.
Its ``csrc/`` (``dep_step.cu`` with its own headers) is copied into
``build/ab/`` and built with this tree's nvcc flags, and called through
this tree's launchers (``nn/depformer.py`` ``_launch_step`` and
``_launch_frame``), as this tree's build is.  On the synthesized 7B
depformer (``runtime/synth.py``, seed 0, q4_k by the policy, its
linear_out q4_0):

1. K14a at every step cb 0-7 on rings whose rows before cb are random, h
   in f32 and in bf16; the same with a q4_k linear_out (random es/em at
   K = 4224); on a ring of 4 slots (cb >= cap: no write, every slot
   attended); and on a ring of 32 slots (the TTS depformer's, read in
   pieces), cb up to 40: ``h_out`` and both rings of the two builds must
   be equal bit for bit.  K14c at temp 0 and at temp 0.8 with top-k 250, ``DRAWS``
   draws each, with and without ``logits_out``: the tokens and the logits
   must be equal bit for bit.  A second call of this build must repeat
   the first's bits;
2. K14c per frame (temp 0 and 0.8) and K14a per call (cb 0-7 in turn),
   timed in turns (other, this, this, other; CUDA events, L2 flushed
   before each launch, as ``chip_smoke.time_ms``; the rings copied once,
   outside the window: a repeated call at one cb rewrites the same row
   with the same bits), beside the bounds ``chip_smoke.py`` computes;
3. ``--set NAME=VALUE``: this tree's source with ``constexpr int NAME``
   set to VALUE (one build with all of them), timed in turns with this
   build (this, variant, variant, this) after checking its bits against
   this build's on every case of 1;
4. ``--stages``: where the time goes.  Each build is copied once more
   with a stamp of ``%globaltimer`` by block 0 at the kernel's start and
   after every grid sync (nothing else changes; the stamped build also
   records its grid), and K14c's frame (temp 0 and 0.8) and K14a's step
   give each stage's time (the mean of ``STAMP_REPS`` calls, L2 flushed
   before each); and a kernel that only syncs as often as K14c's frame
   does (215 times at the 7B) is timed: the grid group's sync at each
   build's grid, and a counter barrier written out (its scheme without
   what it adds around it) at this build's.

Exits 1 at the first disagreement.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import torch

import temporal_ab

ROOT = Path(__file__).resolve().parent
REPS = 20
DRAWS = 3
STAMP_REPS = 5
SOURCE = "dep_step.cu"
THIS = "dep_step"
OTHER, VARIANT = "dep_step_other", "dep_step_variant"
LAYER_STAGES = ("qkv", "attention + out_proj", "GLU", "linear_out")
FRAME_STAGES = ("embedding",) + LAYER_STAGES + ("logits", "sampler")

_STAMP_DECL = """
__device__ unsigned long long mt_stamps[4096];
__device__ int mt_nstamps;
__device__ int mt_grid;
__device__ __forceinline__ void mt_stamp(bool start) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (start) {
      mt_nstamps = 0;
      mt_grid = gridDim.x;
    }
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (mt_nstamps < 4096) mt_stamps[mt_nstamps] = t;
    ++mt_nstamps;
  }
}
"""
_STAMP_READ = """
extern "C" int mt_read_stamps(void* dst, int n, int* count, int* grid) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, mt_stamps,
                                         sizeof(unsigned long long) * n);
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(count, mt_nstamps, sizeof(int));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(grid, mt_grid, sizeof(int));
  return (int)err;
}
"""
_START = "cg::grid_group grid = cg::this_grid();"
_SYNC = "grid.sync();"


def fail(msg: str):
    print(f"depformer_ab: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def stamped(text: str) -> str:
    """``dep_step.cu`` with block 0's stamps at each kernel's start and
    after every grid sync (the count kept in a device variable, since the
    syncs sit in device functions the kernels share)."""
    anchor = "namespace cg = cooperative_groups;"
    if text.count(anchor) != 1 or _START not in text or _SYNC not in text:
        fail(f"{SOURCE}: no grid to stamp")
    text = text.replace(anchor, anchor + "\n" + _STAMP_DECL, 1)
    text = text.replace(_START, _START + "\n  mt_stamp(true);")
    text = text.replace(_SYNC, _SYNC + "\n    mt_stamp(false);")
    return text + _STAMP_READ


def with_constants(text: str, sets: dict) -> str:
    """``dep_step.cu`` with each ``constexpr int NAME = ...;`` set."""
    for name, value in sets.items():
        pat = re.compile(rf"(constexpr int {name} = )[^;]+;")
        if len(pat.findall(text)) != 1:
            fail(f"{SOURCE} has no single constexpr int {name}")
        text = pat.sub(rf"\g<1>{value};", text)
    return text


def frame_stage_names(dep_q: int, layers: int):
    """The stage each interval between K14c's stamps belongs to."""
    out = []
    for st in range(dep_q):
        if st:
            out.append("embedding")
        out += list(LAYER_STAGES) * layers
        out += ["logits", "sampler"]
    return out


def step_stage_names(layers: int):
    return list(LAYER_STAGES) * layers


class Setup:
    """The 7B depformer's K14 operands: K14a's cases (weights, rings, h)
    and K14c's draws (h_in, text embedding, noise)."""

    def __init__(self):
        import chip_smoke as cs
        from moshi_tpu_torch.models import lm
        from moshi_tpu_torch.runtime.synth import synth_lm_params
        self.cfg = lm.LMConfig(delays=cs._7B_DELAYS, num_layers=2)
        d = self.cfg.depformer
        self.dd, self.nl, self.heads = d.dim, d.num_layers, d.num_heads
        self.hidden, self.cap = d.hidden_dim, d.mha.cap
        self.dep_q, self.card = self.cfg.dep_q, self.cfg.card
        params = synth_lm_params(self.cfg, "q4_k", device="cuda", seed=0)
        self.gen = torch.Generator(device="cuda").manual_seed(1)
        dep = params["depformer"]
        step_w = lm._per_step_weights(self.cfg, dep)
        norms = (dep["layers"]["norm1"]["alpha"],
                 dep["layers"]["norm2"]["alpha"])
        self.step_w = [cs._step_weights(step_w, norms, cb)
                       for cb in range(self.dep_q)]
        self.frame_w = cs._frame_weights(params, self.cfg)

    def q4k_lout(self, w):
        """``w`` with its linear_out in q4_k: the q4_0 values as they are,
        random es and em per 32-block (K = 4224 has no 256-blocks, so the
        scales are drawn at the granularity the kernel reads)."""
        from moshi_tpu_torch.quant.formats import QuantTensor
        lo = w["lout"]
        shape = lo.d.shape
        es = (torch.rand(shape, generator=self.gen, device="cuda")
              * 4e-3).to(torch.bfloat16)
        em = (torch.rand(shape, generator=self.gen, device="cuda")
              * 3e-2).to(torch.bfloat16)
        w = dict(w)
        w["lout"] = QuantTensor("q4_k", lo.shape, lo.q, lo.d, es=es, em=em)
        return w

    def step_cases(self):
        """(label, weights, cap, cb, k ring, v ring, h) of phase 1's K14a
        calls."""
        out = []
        q4k = [self.q4k_lout(w) for w in self.step_w]
        steps = range(self.dep_q)
        for lout, ws, cap, cbs in (("q4_0", self.step_w, self.cap, steps),
                                   ("q4_k", q4k, self.cap, steps),
                                   ("q4_0", self.step_w, 4, steps),
                                   ("q4_0", self.step_w, 32,
                                    (0, 8, 9, 17, 31, 40))):
            for cb in cbs:
                for hb in (False, True):
                    kr = torch.zeros((self.nl, cap, self.dd),
                                     dtype=torch.bfloat16, device="cuda")
                    vr = torch.zeros_like(kr)
                    kr[:, :cb].normal_(generator=self.gen)
                    vr[:, :cb].normal_(generator=self.gen)
                    h = torch.randn((1, self.dd), generator=self.gen,
                                    device="cuda")
                    if hb:
                        h = h.to(torch.bfloat16)
                    label = (f"linear_out {lout}, cap {cap}, cb {cb}, h "
                             f"{'bf16' if hb else 'f32'}")
                    out.append((label, ws[cb % self.dep_q], cap, cb, kr,
                                vr, h))
        return out

    def step(self, lib, case, kr, vr):
        from moshi_tpu_torch.nn import depformer as dp
        _, w, cap, cb, _, _, h = case
        return dp._launch_step(h, kr, vr, cb, w, cap=cap, heads=self.heads,
                               nlayers=self.nl, lib_name=lib)

    def draws(self, n):
        from moshi_tpu_torch.nn.sampling import gumbel
        return [(torch.randn((self.dep_q, 1, self.dd), generator=self.gen,
                             device="cuda"),
                 0.1 * torch.randn((1, self.dd), generator=self.gen,
                                   device="cuda"),
                 gumbel((self.dep_q, 1, self.card), self.gen, "cuda"))
                for _ in range(n)]

    def frame(self, lib, draw, temp, logits_out=None):
        from moshi_tpu_torch.nn import depformer as dp
        h_in, text, noise = draw
        return dp._launch_frame(h_in, text, self.frame_w, noise,
                                cap=self.cap, heads=self.heads,
                                nlayers=self.nl, card=self.card, temp=temp,
                                top_k=250, logits_out=logits_out,
                                lib_name=lib)


def bits(t):
    return t.contiguous().view(torch.uint8)


def same(what, a, b):
    if not torch.equal(bits(a), bits(b)):
        bad = int((a.float() != b.float()).sum())
        fail(f"{what} differs ({bad} of {a.numel()} elements)")
    return a.numel()


def compare(st, first, second, label):
    """Phase 1 for two libraries.  Returns the outputs compared."""
    n = 0
    cases = st.step_cases()
    for case in cases:
        what, _, _, _, kr, vr, _ = case
        outs = []
        for lib in (first, second, second):
            k, v = kr.clone(), vr.clone()
            h_out, _, _ = st.step(lib, case, k, v)
            outs.append((h_out, k, v))
        torch.cuda.synchronize()
        for i, name in enumerate(("h_out", "k ring", "v ring")):
            n += same(f"{label}: K14a {what}: {name}", outs[0][i],
                      outs[1][i])
            same(f"{label}: K14a {what}: {name} of a second call",
                 outs[1][i], outs[2][i])
    print(f"  {label}: K14a, {len(cases)} cases (linear_out q4_0 and "
          f"q4_k, cap 8 at cb 0-7, cap 4 and 32 past their ends too, h f32 "
          f"and bf16): h_out, both rings bit-identical", flush=True)
    for temp in (0.0, 0.8):
        for d, draw in enumerate(st.draws(DRAWS)):
            for with_logits in (False, True):
                outs = []
                for lib in (first, second, second):
                    lo = (torch.empty((st.dep_q, st.card), device="cuda")
                          if with_logits else None)
                    outs.append((st.frame(lib, draw, temp, lo), lo))
                torch.cuda.synchronize()
                what = (f"{label}: K14c temp {temp:g} draw {d}"
                        f"{' with logits_out' if with_logits else ''}")
                n += same(f"{what}: tokens", outs[0][0], outs[1][0])
                same(f"{what}: tokens of a second call", outs[1][0],
                     outs[2][0])
                if with_logits:
                    n += same(f"{what}: logits", outs[0][1], outs[1][1])
                    same(f"{what}: logits of a second call", outs[1][1],
                         outs[2][1])
        print(f"  {label}: K14c temp {temp:g}: {DRAWS} draws, tokens and "
              f"logits bit-identical", flush=True)
    return n


def bounds(st):
    """(K14a bound ms per call, K14c bound ms per frame at temp 0 and 0.8),
    as chip_smoke.py's checks reckon them."""
    import chip_smoke as cs
    nl, dd, hidden = st.nl, st.dd, st.hidden
    w0 = st.step_w[0]
    wbytes = sum(cs._qt_bytes(w0[n], nl) for n in ("qkv", "out", "glu",
                                                   "lout"))
    mean_valid = sum(min(cb + 1, st.cap) for cb in range(st.dep_q)) / st.dep_q
    nbytes = (wbytes + 2 * nl * dd * w0["n1"].element_size()
              + 2 * nl * (mean_valid - 1) * dd * 2 + 2 * nl * dd * 2
              + 2 * dd * 4)
    ops = (2.0 * nl * dd * (3 * dd + dd + 2 * hidden + hidden)
           + 4.0 * nl * mean_valid * dd)
    step = cs.bound_ms(nbytes, ops, "f32")[0]
    w = st.frame_w
    lr, dep_q, card = w["emb"].shape[-1], st.dep_q, st.card
    fbytes = sum(cs._qt_bytes(w[n], dep_q * nl)
                 for n in ("qkv", "out", "glu", "lout"))
    fbytes += cs._qt_bytes(w["linears"], dep_q)
    fops = (2.0 * dep_q * nl * dd * (3 * dd + dd + 3 * hidden)
            + 2.0 * dep_q * card * dd + 2.0 * (dep_q - 1) * dd * lr)
    frame = {}
    for temp in (0.0, 0.8):
        nb = (fbytes + 2 * nl * dd * w["n1"].element_size()
              + (dep_q - 1) * (lr + dd * lr) * w["emb"].element_size()
              + dep_q * dd * 4 + dd * 4 + dep_q * 4
              + (dep_q * card * 4 if temp else 0))
        frame[temp] = cs.bound_ms(nb, fops, "f32")[0]
    return step, frame


def timings(st, turns, what):
    """Phase 2 (or 3): K14c per frame at temp 0 and 0.8, K14a per call, in
    ``turns`` ((label, library), ...)."""
    import chip_smoke as cs
    b_step, b_frame = bounds(st)
    rows = []
    for temp in (0.0, 0.8):
        draws = st.draws(4)
        t = [cs.time_ms(lambda i, lib=lib: st.frame(lib, draws[i % 4], temp),
                        REPS) for _, lib in turns]
        rows.append({"kernel": "K14c dep_frame_step", "temp": temp,
                     "turns": [label for label, _ in turns], "ms": t,
                     "bound_ms": b_frame[temp]})
        shown = ", ".join(f"{label} {v:.4f}" for (label, _), v in
                          zip(turns, t))
        print(f"  {what} K14c frame, temp {temp:g}: {shown} ms; bound "
              f"{b_frame[temp]:.4f} ms  [{cs.CARD}]", flush=True)
    cases = [c for c in st.step_cases()
             if c[0].startswith("linear_out q4_0, cap 8") and
             c[0].endswith("h f32")]
    t = []
    for _, lib in turns:
        rings = [(c[4].clone(), c[5].clone()) for c in cases]
        t.append(cs.time_ms(
            lambda i, lib=lib: st.step(lib, cases[i % len(cases)],
                                       *rings[i % len(cases)]), REPS))
    rows.append({"kernel": "K14a dep_full_step", "turns":
                 [label for label, _ in turns], "ms": t, "bound_ms": b_step})
    shown = ", ".join(f"{label} {v:.4f}" for (label, _), v in zip(turns, t))
    print(f"  {what} K14a step (cb 0-7 in turn): {shown} ms per call; bound "
          f"{b_step:.4f} ms  [{cs.CARD}]", flush=True)
    return rows


def read_stamps(lib, n):
    from moshi_tpu_torch.kernels import build
    read = build._LIBS[lib].mt_read_stamps
    read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p]
    read.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * n)()
    count, grid = ctypes.c_int(), ctypes.c_int()
    if read(buf, n, ctypes.byref(count), ctypes.byref(grid)):
        fail(f"{lib}: reading the stamps failed")
    if count.value != n:
        fail(f"{lib}: {count.value} stamps, expected {n}")
    return torch.tensor(list(buf), dtype=torch.float64), grid.value


def split(st, lib, call, names):
    """Mean ms per stage name over STAMP_REPS calls of ``call``, the time
    from the start to the last sync, and the grid."""
    import chip_smoke as cs
    n = len(names) + 1
    call()
    per = {k: 0.0 for k in dict.fromkeys(names)}
    total = 0.0
    grid = 0
    for _ in range(STAMP_REPS):
        cs._FLUSH.zero_()
        call()
        torch.cuda.synchronize()
        t, grid = read_stamps(lib, n)
        d = (t[1:] - t[:-1]) / 1e6
        for name, v in zip(names, d.tolist()):
            per[name] += v / STAMP_REPS
        total += float(t[-1] - t[0]) / 1e6 / STAMP_REPS
    return per, total, grid


def stage_split(st, libs):
    """Phase 4: per stage ms of each stamped library: K14c per frame at
    temp 0 and 0.8, K14a per call (cb 7, a full ring)."""
    import chip_smoke as cs
    if cs._FLUSH is None:
        cs._FLUSH = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    out = {}
    fnames = frame_stage_names(st.dep_q, st.nl)
    snames = step_stage_names(st.nl)
    case = [c for c in st.step_cases()
            if c[0] == "linear_out q4_0, cap 8, cb 7, h f32"][0]
    draw = st.draws(1)[0]
    for label, lib in libs:
        for temp in (0.0, 0.8):
            per, total, grid = split(st, lib,
                                     lambda: st.frame(lib, draw, temp),
                                     fnames)
            key = f"{label} K14c temp {temp:g}"
            out[key] = {"stages_ms": per, "start_to_last_sync_ms": total,
                        "grid_blocks": grid, "syncs": len(fnames)}
            print(f"  {key:22s}: " + ", ".join(
                f"{s} {v:.4f}" for s, v in per.items())
                + f"; start to last sync {total:.4f} ms; {len(fnames)} "
                f"syncs of {grid} blocks  [{cs.CARD}]", flush=True)
        rings = (case[4].clone(), case[5].clone())
        per, total, grid = split(st, lib, lambda: st.step(lib, case, *rings),
                                 snames)
        key = f"{label} K14a cb 7"
        out[key] = {"stages_ms": per, "start_to_last_sync_ms": total,
                    "grid_blocks": grid, "syncs": len(snames)}
        print(f"  {key:22s}: " + ", ".join(
            f"{s} {v:.4f}" for s, v in per.items())
            + f"; start to last sync {total:.4f} ms; {len(snames)} syncs "
            f"of {grid} blocks  [{cs.CARD}]", flush=True)
    return out


_SYNC_SRC = r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
// the grid group's sync, as the kernels take it
__global__ void cg_syncs(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}
// the grid group's scheme written out, without what its sync adds around
// it: a counter whose top bit flips once every block has arrived (block 0
// adds 2^31 - (blocks - 1), the others 1), added to with release order
// and read with acquire order by each block's first thread.  Measured as
// the alternative to the grid group's sync; the kernels do not take it.
__global__ void counter_syncs(int n, unsigned* word) {
  for (int i = 0; i < n; ++i) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned add =
          blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
      unsigned old, cur;
      asm volatile("atom.add.release.gpu.u32 %0, [%1], %2;"
                   : "=r"(old) : "l"(word), "r"(add) : "memory");
      while (true) {
        asm volatile("ld.acquire.gpu.u32 %0, [%1];"
                     : "=r"(cur) : "l"(word) : "memory");
        if ((old ^ cur) & 0x80000000u) break;
      }
    }
    __syncthreads();
  }
}
extern "C" int mt_syncs(int counter, int blocks, int n, void* word,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!counter) {
    void* args[] = {&n};
    return (int)cudaLaunchCooperativeKernel((const void*)cg_syncs,
                                            dim3(blocks), dim3(256), args, 0,
                                            st);
  }
  void* args[] = {&n, &word};
  return (int)cudaLaunchCooperativeKernel((const void*)counter_syncs,
                                          dim3(blocks), dim3(256), args, 0,
                                          st);
}
"""


def sync_only(grids, syncs):
    """Phase 4: ``syncs`` grid syncs alone, 256 threads a block: the grid
    group's sync at each build's grid, and the counter barrier written out
    at this build's."""
    import subprocess
    import chip_smoke as cs
    from moshi_tpu_torch.kernels import build
    src = temporal_ab.AB_DIR / "dep_syncs.cu"
    so = src.with_suffix(".so")
    src.write_text(_SYNC_SRC)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        fail(f"nvcc dep_syncs.cu:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(so)).mt_syncs
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    word = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = {}
    cases = [(label, blocks, False) for label, blocks in grids.items()]
    cases.append(("this", grids["this"], True))
    for label, blocks, counter in cases:
        def run(i, blocks=blocks, counter=counter):
            err = fn(int(counter), blocks, syncs, ctypes.c_void_p(
                word.data_ptr()), ctypes.c_void_p(
                    torch.cuda.current_stream().cuda_stream))
            if err:
                fail(f"grid syncs: CUDA error {err}")

        t = cs.time_ms(run, REPS)
        kind = "a counter barrier" if counter else "the grid group's sync"
        out[f"{label} grid, {kind}"] = {"blocks": blocks, "syncs": syncs,
                                        "ms": t}
        print(f"  {syncs} syncs of {label}'s grid ({blocks} blocks x 256 "
              f"threads), {kind}, alone: {t:.4f} ms  [{cs.CARD}]",
              flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--out", default=None,
                    help="also write the numbers to this JSON file")
    ap.add_argument("--stages", action="store_true",
                    help="also split each build's time by stage")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="also time this tree's source with a constant set")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from moshi_tpu_torch.kernels import build
    cs.CARD = cs.smi_line()
    print(f"card: {cs.CARD}", flush=True)
    build.build_all()
    this_csrc = ROOT / "moshi_tpu_torch" / "csrc"
    other_csrc = args.other.resolve() / "moshi_tpu_torch" / "csrc"
    sets = dict(kv.split("=", 1) for kv in args.set)
    specs = [(OTHER, other_csrc, None)]
    if sets:
        specs.append((VARIANT, this_csrc,
                      lambda t: with_constants(t, sets)))
    if args.stages:
        specs += [("dep_step_other_stamped", other_csrc, stamped),
                  ("dep_step_this_stamped", this_csrc, stamped)]
    logs = {"this": build.BUILD_LOG.get(THIS, "")}
    logs.update(temporal_ab.build_libs(specs, source=SOURCE))
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    st = Setup()
    from moshi_tpu_torch.nn import depformer as dp
    report = {"card": cs.CARD, "grid_this": {
        "K14c": dp.grid_blocks(st.dd, st.hidden, frame=True),
        "K14a": dp.grid_blocks(st.dd, st.hidden, frame=False)}}
    print(f"this build's grid: {report['grid_this']} blocks", flush=True)
    print("1. bit identity, other against this", flush=True)
    report["identical"] = compare(st, OTHER, THIS, "other/this")
    print(f"   {report['identical']} outputs compared", flush=True)
    print("2. device time in turns (other, this, this, other)", flush=True)
    report["times"] = timings(st, (("other", OTHER), ("this", THIS),
                                   ("this", THIS), ("other", OTHER)),
                              "other/this")
    if sets:
        print(f"3. this tree with {sets}", flush=True)
        report["variant_identical"] = compare(st, THIS, VARIANT,
                                              "this/variant")
        report["variant"] = {"sets": sets, "times": timings(
            st, (("this", THIS), ("variant", VARIANT), ("variant", VARIANT),
                 ("this", THIS)), "this/variant")}
    if args.stages:
        print("4. where the time goes: stages (block 0's %globaltimer "
              "after each grid sync)", flush=True)
        report["stages"] = stage_split(
            st, (("other", "dep_step_other_stamped"),
                 ("this", "dep_step_this_stamped")))
        grids = {label: report["stages"][f"{label} K14c temp 0.8"]
                 ["grid_blocks"] for label in ("other", "this")}
        report["grid_syncs"] = sync_only(
            grids, len(frame_stage_names(st.dep_q, st.nl)))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps({"ok": True, "identical": report["identical"]}))


if __name__ == "__main__":
    main()
