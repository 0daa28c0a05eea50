#!/usr/bin/env python3
"""K13, the temporal megakernel (``moshi_tpu_torch/csrc/temporal_step.cu``),
against the same source in another checkout, on one card: bit identity,
device time in turns, and where each build's time goes, stage by stage.

    python3 temporal_ab.py OTHER [--out F] [--stages] [--set NAME=VALUE ...]

OTHER is the root of another checkout of this repository, for example
``mkdir -p build/other && git archive <commit> | tar -x -C build/other``.
Its ``csrc/`` (``temporal_step.cu`` with its own headers) is copied into
``build/ab/`` and built with this tree's nvcc flags, and called through
this tree's launcher (``nn/temporal.py`` ``_launch``), as this tree's
build is.  On the synthesized 7B q4_k weights (``runtime/synth.py``,
seed 0, as ``chip_smoke.py`` makes them):

1. on rings fresh (offset 0), a third full (cap // 3), full (cap) and
   wrapped (cap + 7), at 2 and 32 layers, bf16 and fp8 (random rows in
   the first cap slots), ``DRAWS`` draws of h each: ``h_out``, ``k_new``
   and ``v_new`` of the two builds must be equal bit for bit, and a
   second call of this build must repeat the first's bits;
2. the 32-layer step on a fresh and on a full ring, bf16 and fp8, timed
   in turns (other, this, this, other; CUDA events, L2 flushed before
   each launch, as ``chip_smoke.time_ms``) beside its bound
   (``chip_smoke.k13_bound``), with this build's grid;
3. ``--set NAME=VALUE``: this tree's source with ``constexpr int NAME``
   set to VALUE (one build with all of them), timed in turns with this
   build (this, variant, variant, this) after checking its bits against
   this build's on every case of 1;
4. ``--stages``: where the time goes.  Each build is copied once more
   with a stamp of ``%globaltimer`` by block 0 at the kernel's start and
   after every grid sync (nothing else changes), and the 32-layer step
   on a fresh and on a full ring gives each stage's time per frame (the
   mean of ``STAMP_REPS`` calls, L2 flushed before each); and a kernel
   that only syncs this build's grid 192 times (K13's six syncs per
   layer at 32 layers) is timed.

Exits 1 at the first disagreement.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
AB_DIR = ROOT / "build" / "ab"
REPS = 20
DRAWS = 2
STAMP_REPS = 5
SYNCS = 192
STAGES = ("S1 rms1, qkv", "S2 rope, seed, scores", "S3 chunks p, p.v",
          "S4 fold, out_proj", "S5 residual, rms2, GLU", "S6 linear_out")
OTHER, VARIANT = "temporal_step_other", "temporal_step_variant"

_STAMP_DECL = """
__device__ unsigned long long mt_stamps[4096];
__device__ __forceinline__ void mt_stamp(int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && i < 4096) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    mt_stamps[i] = t;
  }
}
"""
_STAMP_READ = """
extern "C" int mt_read_stamps(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, mt_stamps,
                                   sizeof(unsigned long long) * n);
}
"""
_SYNC_SRC = """
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
__global__ void grid_syncs(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) {
    __threadfence();
    grid.sync();
  }
}
extern "C" int mt_grid_syncs(int blocks, int threads, int n, void* stream) {
  void* args[] = {&n};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)grid_syncs, dim3(blocks), dim3(threads), args, 0,
      static_cast<cudaStream_t>(stream));
}
"""


def fail(msg: str):
    print(f"temporal_ab: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def stamped(text: str) -> str:
    """``temporal_step.cu`` with block 0's stamps at the kernel's start
    and after every grid sync."""
    text = text.replace("namespace cg = cooperative_groups;",
                        "namespace cg = cooperative_groups;\n" + _STAMP_DECL,
                        1)
    start = "cg::grid_group grid = cg::this_grid();"
    if text.count(start) != 1 or "grid.sync();" not in text:
        fail("temporal_step.cu: no grid to stamp")
    text = text.replace(start, start + "\n  int mt_si = 0;\n  mt_stamp(mt_si++);")
    text = text.replace("grid.sync();", "grid.sync();\n    mt_stamp(mt_si++);")
    return text + _STAMP_READ


def with_constants(text: str, sets: dict) -> str:
    """``temporal_step.cu`` with each ``constexpr int NAME = ...;`` set."""
    for name, value in sets.items():
        pat = re.compile(rf"(constexpr int {name} = )[^;]+;")
        if len(pat.findall(text)) != 1:
            fail(f"temporal_step.cu has no single constexpr int {name}")
        text = pat.sub(rf"\g<1>{value};", text)
    return text


def build_libs(specs, source="temporal_step.cu"):
    """Build each (name, csrc dir, transform of ``source``'s text or None)
    as a copy under build/ab/ (one nvcc each, all together), and register
    it with the loader.  Returns nvcc's logs by name."""
    from moshi_tpu_torch.kernels import build
    AB_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, csrc, transform in specs:
        src_dir = AB_DIR / name
        if src_dir.exists():
            shutil.rmtree(src_dir)
        shutil.copytree(csrc, src_dir)
        src = src_dir / source
        if transform is not None:
            src.write_text(transform(src.read_text()))
        out = AB_DIR / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
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


def build_syncs():
    """The grid-sync kernel, built into build/ab/; its ctypes entry."""
    from moshi_tpu_torch.kernels import build
    AB_DIR.mkdir(parents=True, exist_ok=True)
    src, out = AB_DIR / "grid_syncs.cu", AB_DIR / "grid_syncs.so"
    src.write_text(_SYNC_SRC)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        fail(f"nvcc grid_syncs.cu:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(out)).mt_grid_syncs
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class Setup:
    """The 7B's K13 operands: weights by depth, rings by (depth, fp8,
    offset), the rope angles by offset."""

    def __init__(self):
        import chip_smoke as cs
        from moshi_tpu_torch.models.lm import LMConfig
        from moshi_tpu_torch.nn import temporal as tm
        from moshi_tpu_torch.runtime.synth import synth_lm_params
        self.cfg = LMConfig(delays=cs._7B_DELAYS)
        tc = self.cfg.transformer
        self.tc = tc
        self.dd, self.hidden, self.cap = tc.dim, tc.hidden_dim, tc.mha.cap
        self.cap_pad = tm.plan_stages(self.dd, self.hidden, self.cap)[5]
        self.params = synth_lm_params(self.cfg, "q4_k", device="cuda",
                                      seed=0)
        self.gen = torch.Generator(device="cuda").manual_seed(1)
        self._w, self._rings = {}, {}

    def weights(self, depth):
        import chip_smoke as cs
        if depth not in self._w:
            w = cs._k13_weights(self.params, depth)
            self._w[depth] = {n: (v.with_eff_scales()
                                  if n not in ("n1", "n2") else v)
                              for n, v in w.items()}
        return self._w[depth]

    def rings(self, depth, fp8, offset):
        """Random rows in the first cap slots where the offset has written
        any (zeros past them), at the given depth (a slice of the
        32-layer rings)."""
        import chip_smoke as cs
        key = (fp8, offset > 0)
        if key not in self._rings:
            shape = (self.tc.num_layers, self.cap_pad, self.dd)
            if offset == 0:
                kc = torch.zeros(shape, dtype=torch.float8_e4m3fn if fp8
                                 else torch.bfloat16, device="cuda")
                self._rings[key] = (kc, torch.zeros_like(kc))
            elif fp8:
                self._rings[key] = tuple(
                    cs._fp8_flat_ring(shape, self.cap, self.gen)
                    for _ in range(2))
            else:
                kc = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
                vc = torch.zeros_like(kc)
                kc[:, :self.cap].normal_(generator=self.gen)
                vc[:, :self.cap].normal_(generator=self.gen)
                self._rings[key] = (kc, vc)
        kc, vc = self._rings[key]
        return kc[:depth], vc[:depth]

    def call(self, lib, depth, fp8, offset, h):
        from moshi_tpu_torch.nn import temporal as tm
        from moshi_tpu_torch.nn.rope import rope_angles
        kc, vc = self.rings(depth, fp8, offset)
        pos = torch.tensor([offset], dtype=torch.int32, device="cuda")
        cos_sin = rope_angles(pos, self.tc.mha.head_dim,
                              self.tc.rope_max_period)
        return tm._launch(h, kc, vc, pos, cos_sin, self.weights(depth),
                          cap=self.cap, context=self.tc.context,
                          heads=self.tc.num_heads, hidden=self.hidden,
                          nlayers=depth, lib_name=lib)

    def offsets(self):
        return (("fresh", 0), ("a third", self.cap // 3), ("full", self.cap),
                ("wrapped", self.cap + 7))


def bits(t):
    return t.contiguous().view(torch.uint8)


def compare(st, first, second, label):
    """Phase 1 for two libraries.  Returns the outputs compared."""
    n = 0
    for depth in (2, st.tc.num_layers):
        for fp8 in (False, True):
            for name, off in st.offsets():
                for d in range(DRAWS):
                    h = torch.randn((1, st.dd), generator=st.gen,
                                    device="cuda")
                    a = st.call(first, depth, fp8, off, h)
                    b1 = st.call(second, depth, fp8, off, h)
                    b2 = st.call(second, depth, fp8, off, h)
                    torch.cuda.synchronize()
                    what = (f"{label}: {depth} layers, "
                            f"{'fp8' if fp8 else 'bf16'} ring {name} "
                            f"(offset {off}) draw {d}")
                    for i, out in enumerate(("h_out", "k_new", "v_new")):
                        if not torch.equal(bits(a[i]), bits(b1[i])):
                            bad = int((a[i].float() != b1[i].float()).sum())
                            fail(f"{what}: {out} differs ({bad} of "
                                 f"{a[i].numel()} elements)")
                        if not torch.equal(bits(b1[i]), bits(b2[i])):
                            fail(f"{what}: {out} of a second call differs")
                        n += a[i].numel()
                print(f"  {label}: {depth:2d} layers, "
                      f"{'fp8 ' if fp8 else 'bf16'} ring {name:8s} "
                      f"(offset {off:4d}): h_out, k_new, v_new "
                      f"bit-identical", flush=True)
    return n


def timings(st, turns, what):
    """Phase 2 (or 3): the 32-layer step, fresh and full, bf16 and fp8, in
    ``turns`` ((label, library), ...)."""
    import chip_smoke as cs
    from moshi_tpu_torch.nn import temporal as tm
    rows = []
    depth = st.tc.num_layers
    hd = st.tc.mha.head_dim
    for fp8 in (False, True):
        for name, off in (("fresh", 0), ("full", st.cap)):
            hs = [torch.randn((1, st.dd), generator=st.gen, device="cuda")
                  for _ in range(4)]
            t = []
            for _, lib in turns:
                t.append(cs.time_ms(
                    lambda i, lib=lib: st.call(lib, depth, fp8, off,
                                               hs[i % 4]), REPS))
            valid = min(st.cap - 1, st.tc.context - 1) if off else 0
            b_ms, b_by, nbytes = cs.k13_bound(st.weights(depth), depth,
                                              valid, st.dd, st.hidden, hd,
                                              1 if fp8 else 2)
            blocks = tm.grid_blocks(st.dd, st.hidden, st.cap, fp8)
            ring = "fp8" if fp8 else "bf16"
            rows.append({"ring": ring, "state": name, "offset": off,
                         "turns": [label for label, _ in turns], "ms": t,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "bytes": nbytes, "blocks_this": blocks})
            shown = ", ".join(f"{label} {v:.3f}"
                              for (label, _), v in zip(turns, t))
            print(f"  {what} {ring:4s} ring {name:5s}: {shown} ms; bound "
                  f"{b_ms:.3f} ms; this build's grid {blocks} blocks  "
                  f"[{cs.CARD}]", flush=True)
    return rows


def stage_split(st, libs):
    """Phase 4: per stage ms per frame of each stamped library, 32 layers,
    fresh and full, bf16 and fp8."""
    import chip_smoke as cs
    depth = st.tc.num_layers
    n = 1 + 6 * depth
    out = {}
    if cs._FLUSH is None:
        cs._FLUSH = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    for label, lib in libs:
        from moshi_tpu_torch.kernels import build
        read = build._LIBS[lib].mt_read_stamps
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        read.restype = ctypes.c_int
        for fp8 in (False, True):
            for name, off in (("fresh", 0), ("full", st.cap)):
                h = torch.randn((1, st.dd), generator=st.gen, device="cuda")
                st.call(lib, depth, fp8, off, h)
                per = torch.zeros(6, dtype=torch.float64)
                total = 0.0
                for _ in range(STAMP_REPS):
                    cs._FLUSH.zero_()
                    st.call(lib, depth, fp8, off, h)
                    torch.cuda.synchronize()
                    buf = (ctypes.c_ulonglong * n)()
                    if read(buf, n):
                        fail(f"{label}: reading the stamps failed")
                    t = torch.tensor(list(buf), dtype=torch.float64)
                    d = (t[1:] - t[:-1]).reshape(depth, 6)
                    per += d.sum(0) / 1e6
                    total += float(t[-1] - t[0]) / 1e6
                per /= STAMP_REPS
                total /= STAMP_REPS
                ring = "fp8" if fp8 else "bf16"
                key = f"{label} {ring} {name}"
                out[key] = {"stages_ms": dict(zip(STAGES, per.tolist())),
                            "start_to_last_sync_ms": total}
                print(f"  {key:22s}: " + ", ".join(
                    f"{s.split()[0]} {v:.3f}" for s, v in
                    zip(STAGES, per.tolist())) + f"; start to last sync "
                    f"{total:.3f} ms  [{cs.CARD}]", flush=True)
    return out


def sync_only(st):
    """Phase 4: SYNCS grid syncs of this build's grid, alone."""
    import chip_smoke as cs
    from moshi_tpu_torch.kernels import build
    from moshi_tpu_torch.nn import temporal as tm
    fn = build_syncs()
    blocks = tm.grid_blocks(st.dd, st.hidden, st.cap)

    def run(i):
        err = fn(blocks, 256, SYNCS,
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            fail(f"grid_syncs: CUDA error {err}")

    t = cs.time_ms(run, REPS)
    print(f"  {SYNCS} grid syncs of {blocks} blocks x 256 threads alone: "
          f"{t:.3f} ms  [{cs.CARD}]", flush=True)
    return {"blocks": blocks, "syncs": SYNCS, "ms": t}


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
        specs += [("temporal_step_other_stamped", other_csrc, stamped),
                  ("temporal_step_this_stamped", this_csrc, stamped)]
    logs = {"this": build.BUILD_LOG.get("temporal_step", "")}
    logs.update(build_libs(specs))
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    st = Setup()
    report = {"card": cs.CARD}
    print("1. bit identity, other against this", flush=True)
    report["identical"] = compare(st, OTHER, "temporal_step", "other/this")
    print("2. device time in turns (other, this, this, other)", flush=True)
    report["times"] = timings(st, (("other", OTHER),
                                   ("this", "temporal_step"),
                                   ("this", "temporal_step"),
                                   ("other", OTHER)), "other/this")
    if sets:
        print(f"3. this tree with {sets}", flush=True)
        report["variant_identical"] = compare(st, "temporal_step", VARIANT,
                                              "this/variant")
        report["variant"] = {"sets": sets, "times": timings(
            st, (("this", "temporal_step"), ("variant", VARIANT),
                 ("variant", VARIANT), ("this", "temporal_step")),
            "this/variant")}
    if args.stages:
        print("4. where the time goes: stages per frame (block 0's "
              "%globaltimer after each grid sync)", flush=True)
        report["stages"] = stage_split(
            st, (("other", "temporal_step_other_stamped"),
                 ("this", "temporal_step_this_stamped")))
        report["grid_syncs"] = sync_only(st)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps({"ok": True, "identical": report["identical"]}))


if __name__ == "__main__":
    main()
