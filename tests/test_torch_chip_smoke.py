"""chip_smoke.py's phases on the CPU at a tiny size.

The script runs on the card, where each wrapper launches its CUDA kernel
and counts the launch.  Here every wrapper runs its plain version, which
is made to count as its kernel would, so that the script's control flow,
its kernel table and its per-frame launch counts (which it asserts on the
card) are checked against the port's real dispatch.
"""

import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from moshi_tpu_torch.kernels import build
from moshi_tpu_torch.models import lm
from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
from moshi_tpu_torch.nn import decode_attention, ring
from moshi_tpu_torch.nn.seanet import SEANetConfig
from moshi_tpu_torch.quant import fused, matmul, matmul_int8
from moshi_tpu_torch.runtime.synth import synth_lm_params, synth_mimi_params

_LMConfig = lm.LMConfig      # the 7B defaults, before the fixture's patch
_SMALL = dict(dim=256, num_heads=4, num_layers=2, hidden_dim=512, context=32,
              card=256, text_card=512, depformer_dim=256, depformer_heads=4,
              depformer_layers=2, depformer_hidden=576, depformer_low_rank=32)
# a small Mimi whose codebooks match the small LM's card and n_q
_SMALL_MIMI = dict(n_q=16, total_codebooks=16, dim=32, codebook_dim=16,
                   codebook_size=256, transformer_layers=2,
                   transformer_heads=4, transformer_context=16,
                   transformer_hidden=64,
                   seanet=SEANetConfig(dimension=32, n_filters=4,
                                       ratios=(4, 3, 2, 2)))


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "DEV", "cpu")

    def host_time_ms(fn, reps):
        fn(0)
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        return (time.perf_counter() - t0) / reps * 1e3

    monkeypatch.setattr(mod, "time_ms", host_time_ms)
    monkeypatch.setattr(lm, "LMConfig",
                        lambda **kw: _LMConfig(**{**_SMALL, **kw}))
    monkeypatch.setattr(mod, "FRAMES", 10)
    # each plain version counts where its kernel would (the int8 matvec
    # is two launches)
    for module, fn_name, kernel, n in (
            (matmul_int8, "int8_matvec_plain", "int8_matvec", 2),
            (matmul, "dequant_matvec_plain", "dequant_matvec", 1),
            (decode_attention, "decode_attention_plain", "decode_attention",
             1),
            (ring, "ring_write_plain", "ring_write", 1),
            (fused, "attn_ffn_fused_plain", "attn_ffn_fused", 1)):
        plain = getattr(module, fn_name)

        def counted(*a, _plain=plain, _kernel=kernel, _n=n, **kw):
            build.COUNTS[_kernel] += _n
            return _plain(*a, **kw)

        monkeypatch.setattr(module, fn_name, counted)
    return mod


def test_chip_smoke_phases_on_cpu(smoke, monkeypatch):
    # at this size the "full depth" comparison runs the same 2 layers as
    # the 2-layer one, so it takes the 2-layer limit
    monkeypatch.setitem(smoke.TOL, "frame_32l", smoke.TOL["frame_2l"])
    monkeypatch.setitem(smoke.TOL, "frame_32l_dep", smoke.TOL["frame_2l_dep"])
    cfg = lm.LMConfig(delays=smoke._7B_DELAYS)
    params = synth_lm_params(cfg, "q4_k", device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    rows = smoke.check_matvecs(params, cfg, gen)
    rows += smoke.check_attention(cfg, gen)
    rows += smoke.check_fused(params, cfg, gen)
    assert {r["kernel"] for r in rows} == set(smoke._SOURCES)
    # the controls sit above the limits at this size too
    for r in rows:
        if r["kernel"] != "ring_write":
            assert r["control_rel_err"] > r["tol_rel"] >= r["max_rel_err"]
    # at this size K3's control moves no int8 rounding in the fused form
    # (logits 1.1e-5 from the CPU); the card holds it at the 7B geometry
    frame_controls = smoke._frame_controls
    monkeypatch.setattr(smoke, "_frame_controls", lambda form: [
        c for c in frame_controls(form)
        if form == "0" or not c[0].startswith("K3")])
    for form in ("1", "0"):
        two = smoke.compare_two_layers(form)
        assert all(r["tokens_agree"] == r["tokens_total"]
                   for r in two["readings"])
        assert len(two["controls"]) == 2
    smoke.compare_full_depth(cfg, params)
    # run_7b and run_sts assert the launches over their frames against
    # per_frame_launches: here, against the plain versions' calls
    fresh = smoke.run_7b(cfg, params, "fresh session",
                         lm.init_gen_state(cfg, 1, device="cpu"), 1.0)
    full = smoke.run_7b(cfg, params, "full ring",
                        smoke.long_session_state(cfg, gen), 1.0)
    unfused = smoke.run_7b(cfg, params, "unfused",
                           lm.init_gen_state(cfg, 1, device="cpu"), 1.0,
                           fused=False)
    for run in (fresh, full):
        assert run["launches_per_frame"] == smoke.per_frame_launches(cfg)
    assert unfused["launches_per_frame"] == \
        smoke.per_frame_launches(cfg, fused=False)
    mimi = MimiModel(MimiConfig(**_SMALL_MIMI))
    mparams = synth_mimi_params(mimi.cfg, device="cpu", seed=1)
    got = smoke.compare_mimi(mimi, mparams)
    assert got["codes_equal"] == got["codes_decided"] >= smoke.MIMI_FRAMES
    sts = smoke.run_sts(cfg, params, mimi, mparams, 1.0)
    assert sts["launches_per_frame"] == smoke.per_frame_launches(cfg)
    assert set(sts["split_ms_per_frame"]) == {"encode", "lm", "decode"}
    table = smoke.kernel_table(rows, sts["launches_per_frame"])
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for entry in table:
        assert set(entry) == keys
        assert entry["route"] == "cuda" and entry["launches"] > 0
        assert (Path(__file__).resolve().parents[1]
                / entry["source"]).is_file()


def test_per_frame_launches_match_7b_counts(smoke):
    """The 7B frame's counts.  Fused (the default): K1 122 calls of two
    launches each, K5 80, K2 48, K3 80, K4 1.  Unfused: K1 282 calls."""
    cfg = _LMConfig(delays=smoke._7B_DELAYS)
    assert smoke.per_frame_launches(cfg) == {
        "int8_matvec": 2 * 122, "attn_ffn_fused": 80, "dequant_matvec": 48,
        "decode_attention": 80, "ring_write": 1}
    assert smoke.per_frame_launches(cfg, fused=False) == {
        "int8_matvec": 2 * 282, "dequant_matvec": 48, "decode_attention": 80,
        "ring_write": 1}


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(root / "chip_smoke.py")],
                         cwd=str(root), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
    # and alone in a directory, without the port beside it
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((root / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
