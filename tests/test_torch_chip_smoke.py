"""chip_smoke.py's phases on the CPU at a tiny size.

The script runs on the card, where each wrapper launches its CUDA kernel
and counts the launch.  Here every wrapper runs its plain version, which
is made to count as its kernel would, so that the script's control flow,
its kernel table and its per-frame launch counts (which it asserts on the
card) are checked against the port's real dispatch.
"""

import dataclasses
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from moshi_tpu_torch.kernels import build
from moshi_tpu_torch.models import lm
from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
from moshi_tpu_torch.nn import decode_attention, depformer, ring, temporal
from moshi_tpu_torch.nn.seanet import SEANetConfig
from moshi_tpu_torch.quant import fused, matmul, matmul_int8
from moshi_tpu_torch.quant.formats import i8_storage
from moshi_tpu_torch.runtime.synth import synth_lm_params, synth_mimi_params

_LMConfig = lm.LMConfig      # the 7B defaults, before the fixture's patch
_SMALL = dict(dim=256, num_heads=4, num_layers=2, hidden_dim=512, context=32,
              card=256, text_card=512, depformer_dim=256, depformer_heads=4,
              depformer_layers=2, depformer_hidden=576, depformer_low_rank=32)
_SMALL_STT = dict(dim=256, num_heads=4, hidden_dim=512, context=48, card=256,
                  n_q=16, text_card=512, delays=(0,) * 17)
# a small Mimi whose codebooks match the small LMs' card and n_q
_SMALL_MIMI = dict(n_q=16, total_codebooks=16, dim=32, codebook_dim=16,
                   codebook_size=256, transformer_layers=2,
                   transformer_heads=4, transformer_context=16,
                   transformer_hidden=64,
                   seanet=SEANetConfig(dimension=32, n_filters=4,
                                       ratios=(4, 3, 2, 2)))
# a small TTS class: cross-attention on (from the TTS config), dep_q = n_q
_SMALL_TTS = dict(dim=256, num_heads=4, hidden_dim=512, context=24, card=256,
                  n_q=4, dep_q=4, text_card=512, delays=(0, 0, 2, 2, 2),
                  depformer_dim=256, depformer_heads=4, depformer_layers=2,
                  depformer_hidden=576, depformer_low_rank=32,
                  depformer_schedule=(), delay_steps=3)
# a small Mimi whose codebooks match the small TTS class's card and n_q
_SMALL_MIMI_TTS = dict(_SMALL_MIMI, n_q=4, total_codebooks=4)
# a small LM that reaches K10 and K12 as the 7B does under their knobs:
# temporal hd 128 over a 48-slot ring (K10's chunk 24, K3's 16), and a
# temporal linear_out of K = 5120 (q4_k, 160 blocks: two segments)
_SMALL_MXU = dict(_SMALL, num_heads=2, hidden_dim=5120, context=48)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these tiny CPU ops lose far more to thread hand-offs
    than they gain, most of all beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_time_ms(fn, reps):
    """``time_ms`` on the host clock (no card to time)."""
    fn(0)
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    return (time.perf_counter() - t0) / reps * 1e3


def count_plain_versions(patch):
    """Install the counting plain versions through ``patch(module, name,
    value)`` (``monkeypatch.setattr``, or ``setattr`` in a rank process of
    the phase 13 rehearsal)."""
    # each plain version counts where its kernel would (the int8 matvec
    # and K12 are one launch a call; K3, K4, K9, K11 and K13 count their
    # fp8 forms where the ring argument is fp8, K1 and K5 their i8 forms
    # where a weight argument holds unpacked int8 storage); a plain
    # version called by another (K7's by K8's) is not a launch of its own
    depth = [0]
    weight_args = {"int8_matvec_plain": (1,), "attn_ffn_fused_plain": (2, 3)}
    for module, fn_name, kernel, n, ring_arg in (
            (matmul_int8, "int8_matvec_plain", "int8_matvec", 1, None),
            (matmul, "dequant_matvec_plain", "dequant_matvec", 1, None),
            (matmul, "qmatmul_plain", "qmatmul", 1, None),
            (matmul, "glu_matvec_plain", "glu_matvec", 1, None),
            (matmul, "glu_matmul_plain", "glu_matmul", 1, None),
            (decode_attention, "decode_attention_plain", "decode_attention",
             1, 1),
            (decode_attention, "decode_attention4_plain",
             "decode_attention4", 1, 1),
            (ring, "ring_write_plain", "ring_write", 1, 0),
            (ring, "ring_write4_plain", "ring_write4", 1, 0),
            (ring, "ring_write_kv_plain", "ring_write4", 1, 0),
            (fused, "attn_ffn_fused_plain", "attn_ffn_fused", 1, None),
            (temporal, "temporal_full_step_plain", "temporal_full_step", 1,
             1),
            (depformer, "dep_full_step_plain", "dep_full_step", 1, None),
            (depformer, "dep_frame_step_plain", "dep_frame_step", 1, None),
            (decode_attention, "decode_attention_mxu_plain",
             "decode_attention_mxu", 1, None),
            (matmul_int8, "int8_matvec_kseg_plain", "int8_kseg", 1, None),
            (matmul_int8, "int8_matvec_split_plain", "int8_split", 1,
             None)):
        plain = getattr(module, fn_name)

        def counted(*a, _plain=plain, _kernel=kernel, _n=n, _ring=ring_arg,
                    _weights=weight_args.get(fn_name, ()), **kw):
            if not depth[0]:
                fp8 = (_ring is not None
                       and a[_ring].dtype == torch.float8_e4m3fn)
                i8 = any(i8_storage(a[i]) for i in _weights)
                build.COUNTS[_kernel + ("_fp8" if fp8 else "")
                             + ("_i8" if i8 else "")] += _n
            depth[0] += 1
            try:
                return _plain(*a, **kw)
            finally:
                depth[0] -= 1

        patch(module, fn_name, counted)


@pytest.fixture
def smoke(monkeypatch):
    mod = _load_smoke()
    monkeypatch.setattr(mod, "DEV", "cpu")
    monkeypatch.setattr(mod, "time_ms", host_time_ms)
    monkeypatch.setattr(mod, "FRAMES", 10)
    # a small STT of the stt-1b config's kind (dense, dep_q 0, its extra
    # heads, delays and audio delay), whose n_q and card fit the small Mimi
    stt_1b = mod.stt_config()

    def small_stt(num_layers=0):
        return dataclasses.replace(
            stt_1b, **{**_SMALL_STT, "num_layers": num_layers or 2})

    monkeypatch.setattr(mod, "stt_config", small_stt)
    monkeypatch.setattr(lm, "LMConfig",
                        lambda **kw: _LMConfig(**{**_SMALL, **kw}))
    count_plain_versions(monkeypatch.setattr)
    return mod


def test_chip_smoke_phases_on_cpu(smoke, monkeypatch):
    # at this size the "full depth" comparison runs the same 2 layers as
    # the 2-layer one, so it takes the 2-layer limit
    monkeypatch.setitem(smoke.TOL, "frame_32l", smoke.TOL["frame_2l"])
    monkeypatch.setitem(smoke.TOL, "frame_32l_dep", smoke.TOL["frame_2l_dep"])
    # the STT frames here are CPU against CPU (no error), and the controls
    # move them less than at the stt-1b's width: K9's read >= 4.5e-5
    # (transformer_out) and 1.8e-7 (VAD) at this size
    for key in ("stt_frame_2l", "stt_frame_16l"):
        monkeypatch.setitem(smoke.TOL, key, 2e-5)
    monkeypatch.setitem(smoke.TOL, "stt_vad", 1e-7)
    cfg = lm.LMConfig(delays=smoke._7B_DELAYS)
    params = synth_lm_params(cfg, "q4_k", device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    rows = smoke.check_matvecs(params, cfg, gen)
    rows += smoke.check_attention(cfg, gen)
    rows += smoke.check_fused(params, cfg, gen)
    # a "pp" microbatch (one session at one row) runs phase 3's temporal
    # K1, K5 and K3 rows: over a rank's two microbatches of half the
    # layers, their calls are the launches it counts
    smoke.pp_stage_calls(rows)
    pp = smoke.par_launches(cfg, params, "pp")
    for name, n in (("int8_matvec", pp["int8_matvec"]),
                    ("attn_ffn_fused", pp["attn_ffn_fused"]),
                    ("decode_attention", cfg.num_layers)):
        assert sum(r.get("calls_per_pp_frame", 0) for r in rows
                   if r["kernel"] == name) == n, name
    # the batched kernels: K2, K6 and K8 at B = 8 (K6 and K8 also at 12
    # rows), K3 and K4 with 8 session ages
    pool_rows = smoke.check_pool_matvecs(params, cfg, gen, smoke.POOL_B)
    pool_rows += smoke.check_pool_attention(cfg, gen, smoke.POOL_B)
    assert {r["kernel"] for r in pool_rows} == {
        "dequant_matvec", "qmatmul", "glu_matvec", "decode_attention",
        "ring_write"}
    assert all(r["calls_per_frame"] == 0 and r["calls_per_tick"] > 0
               for r in pool_rows)
    rows += pool_rows
    scfg = smoke.stt_config()
    sparams = synth_lm_params(scfg, None, device="cpu", seed=0)
    stt_rows, dense = smoke.check_stt_kernels(scfg, sparams, gen)
    assert len(dense["weights"]) == 5
    rows += stt_rows
    # K11 (the pair and the one-ring entry) and K4 on every ring case
    checked = smoke.check_ring_writes(scfg, cfg, torch.Generator()
                                      .manual_seed(3), smoke.POOL_B)
    assert checked == {"ring_write4": 2 * 2 * 2 * (7 + 3) * 2,
                       "ring_write": 2 * 2 * (7 + 3)}
    # K7 (the TTS pool's GLU) at the temporal GLU's shape of this config
    rows += smoke.check_k7(params, cfg, gen, smoke.POOL_B)
    # K8 at the TTS pool's depformer GLU (test_chip_smoke_dequant_phases_on_cpu
    # runs the TTS pool's other products)
    tts = dataclasses.replace(smoke.tts_config(), **_SMALL_TTS,
                              num_layers=2)
    tparams = synth_lm_params(tts, "q4_k", device="cpu", seed=0)
    rows += smoke.check_pool_matvecs(
        tparams, tts, gen, smoke.POOL_B,
        cases=[c for c in smoke.tts_pool_matvec_cases(tparams, tts)
               if c[1] == "glu_matvec"], calls_key="calls_per_tts_tick")
    # K13, K14a and K14c (their controls are held at the 7B's widths by
    # the card; test_chip_smoke_mega_phases_on_cpu rehearses them)
    with monkeypatch.context() as m:
        m.setattr(smoke, "check_limit", lambda *a: None)
        rows += smoke.check_megakernels(params, cfg, torch.Generator()
                                        .manual_seed(20))
    # K10 and K12 on a config whose linear_out qualifies for K12
    # (test_chip_smoke_mxu_phases_on_cpu rehearses their paths)
    mcfg = lm.LMConfig(delays=smoke._7B_DELAYS, hidden_dim=5120)
    mparams_lm = synth_lm_params(mcfg, "q4_k", device="cpu", seed=0)
    rows += smoke.check_mxu_kernels(mparams_lm, mcfg, gen)
    # K3, K4, K9 and K11 on fp8 rings (test_chip_smoke_fp8_phases_on_cpu
    # rehearses their paths)
    # at this size K3's control on the B = 8 fp8 ring reads 0.97 on the
    # flip rule, within it (the card's, at the 7B's width, break it: the
    # rule's own test is test_flip_rule_tells_a_flip_from_a_fault)
    with monkeypatch.context() as m:
        m.setattr(smoke, "check_rule", lambda *a: None)
        fp8_rows = smoke.check_fp8_kernels(cfg, scfg, gen, smoke.POOL_B)
    assert [r["kernel"] for r in fp8_rows] == [
        "ring_write_fp8"] * 2 + ["decode_attention_fp8"] * 2 + [
        "decode_attention4_fp8"] * 3 + ["ring_write4_fp8"]
    assert all(r["saturating_control"] > 0 for r in fp8_rows
               if r["kernel"].startswith("ring_write"))
    # K3 on fp8 rings equals its bf16 instance on the rings widened (here
    # both are the plain version: bit for bit)
    assert all(r["bf16_instance_rel_err"] == 0.0 for r in fp8_rows
               if r["kernel"] == "decode_attention_fp8")
    rows += fp8_rows
    # K1 and K5 on i8 weights, K13 on fp8 flat rings
    # (test_chip_smoke_phase10_on_cpu rehearses their paths)
    from moshi_tpu_torch.quant.formats import i8_storage_tree
    rows += smoke.check_i8_kernels(params, i8_storage_tree(params), cfg, gen)
    with monkeypatch.context() as m:
        m.setattr(smoke, "check_limit", lambda *a: None)
        rows += smoke.check_k13_fp8(params, cfg, torch.Generator()
                                    .manual_seed(21))
    assert {r["kernel"] for r in rows} == set(smoke._SOURCES)
    # the controls sit above the limits at this size too
    for r in rows:
        if r["kernel"] in ("temporal_full_step", "temporal_full_step_fp8",
                           "dep_full_step", "dep_frame_step"):
            assert r["max_rel_err"] == 0.0
        elif r["kernel"] == "decode_attention_mxu":
            assert r["control_rel_err"] > r["tol_rel"] >= r["rms_rel_err"]
        elif not r["kernel"].startswith("ring_write"):
            assert r["control_rel_err"] > r["tol_rel"] >= r["max_rel_err"]
        if r["kernel"].startswith("decode_attention") and "rule" in r:
            assert r["rule"] == 0.0 and r["control_rule"] > 0
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
    pool_two = smoke.compare_pool_two_layers(smoke.POOL_B)
    assert len(pool_two["readings"]) == smoke.SEEDS_POOL
    assert all(r["tokens_agree"] == r["tokens_total"] > 0
               for r in pool_two["readings"])
    assert set(pool_two["controls"]) == {
        "K3 p in f32", "dequant activations in f32"}
    got = smoke.compare_stt(scfg, sparams)
    assert len(got["two_layer"]) == smoke.SEEDS_2L
    assert set(got["two_layer_controls"]) == {
        "K9 p in f32", "dense products rounded to bf16"}
    assert set(got["full_depth"]["controls"]) == {
        "dense products rounded to bf16"}
    # run_lm and run_sts assert the launches over their frames against
    # per_frame_launches: here, against the plain versions' calls
    fresh = smoke.run_lm(cfg, params, "fresh session",
                         lm.init_gen_state(cfg, 1, device="cpu"), 1.0)
    full = smoke.run_lm(cfg, params, "full ring",
                        smoke.long_session_state(cfg, gen), 1.0)
    unfused = smoke.run_lm(cfg, params, "unfused",
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
    for label, state in (
            ("fresh session", lm.init_gen_state(scfg, 1, device="cpu")),
            ("full ring", smoke.long_session_state(scfg, gen))):
        run = smoke.run_lm(scfg, sparams, label, state,
                           smoke.stt_floor_ms(scfg, sparams, 8.0),
                           per_frame=smoke.stt_launches(scfg), model="stt")
        assert run["launches_per_frame"] == smoke.stt_launches(scfg)
    stt = smoke.run_stt(scfg, sparams, mimi, mparams, 1.0)
    assert stt["launches_per_frame"] == smoke.stt_launches(scfg) == {
        "decode_attention4": 2, "ring_write4": 2}
    assert set(stt["split_ms_per_frame"]) == {"encode", "lm"}
    smoke.profile_stt(scfg, sparams, mimi, mparams)
    # the batched path: the pool run asserts its launches per tick against
    # pool_launches, here against the plain versions' calls
    pool_report, pool, pool_audio = smoke.run_pool(cfg, params, mimi,
                                                   mparams, smoke.POOL_B)
    assert pool_report["launches_per_tick"] == smoke.pool_launches(
        cfg, params) == {"qmatmul": 2, "glu_matvec": 2 + 2 * 8,
                         "dequant_matvec": 3 * 2 + 3 * 16 + 8,
                         "decode_attention": 2 + 16, "ring_write": 1}
    assert pool.active == smoke.POOL_B and "r3" in pool._by_session
    smoke.profile_pool(pool, pool_audio)
    # the TTS paths' launches, whose runs test_chip_smoke_tts_phases_on_cpu
    # rehearses
    table = smoke.kernel_table(rows, {
        "sts": sts["launches_per_frame"], "stt": stt["launches_per_frame"],
        "pool": pool_report["launches_per_tick"],
        "tts": smoke.tts_launches(tts),
        "tts_pool": smoke.tts_pool_launches(tts),
        "sts_mega": smoke.mega_launches(cfg),
        "dep_mega": smoke.dep_mega_launches(cfg),
        "sts_mxu": smoke.mxu_launches(mcfg),
        "lm_split": smoke.mxu_launches(mcfg, "lm_split"),
        "sts_fp8": smoke.fp8_launches(sts["launches_per_frame"], 2),
        "pool_fp8": smoke.fp8_launches(pool_report["launches_per_tick"], 2),
        "stt_fp8": smoke.fp8_launches(stt["launches_per_frame"], 0),
        "sts_i8": smoke.i8_launches(sts["launches_per_frame"]),
        "sts_mega_fp8": smoke.mega_fp8_launches(cfg),
        # the scans and the session run the frames' LM work
        # (test_chip_smoke_scan_and_session_phases_on_cpu asserts them)
        "sts_scan": sts["launches_per_frame"],
        "stt_scan": stt["launches_per_frame"],
        "session": sts["launches_per_frame"],
        # the 7B frame from a loaded tree, and the TTS class with the
        # demuxed stream (test_chip_smoke_load_and_tts_demux_phases_on_cpu
        # asserts them)
        "load": sts["launches_per_frame"],
        "tts_demux": smoke.tts_demux_launches(tts)})
    keys = {"name", "route", "source", "replaces", "path", "paths",
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms"}
    assert [e["name"] for e in table] == list(smoke._SOURCES)
    assert len(table) == 23
    for entry in table:
        assert set(entry) == keys
        assert entry["route"] == "cuda" and entry["launches"] > 0
        assert entry["path"] == smoke._SOURCES[entry["name"]][2]
        assert (Path(__file__).resolve().parents[1]
                / entry["source"]).is_file()
    assert {e["name"]: e["path"] for e in table
            if e["path"] == "pool"} == {"qmatmul": "pool",
                                        "glu_matvec": "pool"}
    assert {e["name"]: e["path"] for e in table
            if e["path"].endswith(("fp8", "i8"))} == {
        "decode_attention_fp8": "sts_fp8", "ring_write_fp8": "sts_fp8",
        "decode_attention4_fp8": "stt_fp8", "ring_write4_fp8": "stt_fp8",
        "int8_matvec_i8": "sts_i8", "attn_ffn_fused_i8": "sts_i8",
        "temporal_full_step_fp8": "sts_mega_fp8"}
    paths = {e["name"]: e["paths"] for e in table}
    assert paths["glu_matmul"] == {"tts_pool": 2}
    assert paths["glu_matvec"] == {"pool": 2 + 2 * 8, "tts_pool": 2 * 4,
                                   "pool_fp8": 2 + 2 * 8}
    assert paths["int8_matvec"] == {
        "sts": sts["launches_per_frame"]["int8_matvec"], "tts": 26,
        "load": sts["launches_per_frame"]["int8_matvec"], "tts_demux": 30,
        "sts_scan": sts["launches_per_frame"]["int8_matvec"],
        "session": sts["launches_per_frame"]["int8_matvec"],
        "sts_mega": 2, "dep_mega": 2 * 2 + 1 + 2 * 8,
        "sts_mxu": sts["launches_per_frame"]["int8_matvec"] - 2,
        "lm_split": sts["launches_per_frame"]["int8_matvec"] - 2,
        "sts_fp8": sts["launches_per_frame"]["int8_matvec"],
        "sts_mega_fp8": 2}
    # on i8 weights every K1 and K5 launch takes its i8 form; the
    # depformer's packed q4_0 linear_out stays on K2
    assert paths["int8_matvec_i8"] == {
        "sts_i8": sts["launches_per_frame"]["int8_matvec"]}
    assert paths["attn_ffn_fused_i8"] == {
        "sts_i8": sts["launches_per_frame"]["attn_ffn_fused"]}
    assert paths["dequant_matvec"]["sts_i8"] == 16
    assert paths["temporal_full_step_fp8"] == {"sts_mega_fp8": 1}
    # the temporal stack's K3 and K4 take their fp8 forms, the
    # depformer's K3 stays bf16; the STT's K9 and K11 all move
    assert paths["decode_attention_fp8"] == {"sts_fp8": 2, "pool_fp8": 2}
    assert paths["ring_write_fp8"] == {"sts_fp8": 1, "pool_fp8": 1}
    assert paths["decode_attention4_fp8"] == {"stt_fp8": 2}
    assert paths["ring_write4_fp8"] == {"stt_fp8": 2}
    assert paths["decode_attention"]["sts_fp8"] == 16
    assert paths["decode_attention_mxu"] == {"sts_mxu": 2 + 16,
                                             "lm_split": 2 + 16}
    assert paths["int8_kseg"] == {"sts_mxu": 2}
    assert paths["int8_split"] == {"lm_split": 2}
    assert paths["temporal_full_step"] == {"sts_mega": 1}
    assert paths["dep_frame_step"] == {"sts_mega": 1, "sts_mega_fp8": 1}
    assert paths["dep_full_step"] == {"dep_mega": 8}
    assert paths["decode_attention4"] == {"stt": 2, "tts": 2,
                                          "tts_pool": 2, "stt_scan": 2,
                                          "tts_demux": 2}
    for name in ("attn_ffn_fused", "dequant_matvec", "decode_attention",
                 "ring_write"):
        assert "load" in paths[name] and (
            "tts_demux" in paths[name]) == (name != "ring_write"), name
    assert set(paths["qmatmul"]) == {"pool", "tts_pool", "pool_fp8"}
    # per-path sums of the measured rows: K2 and K3 also at the pool tick
    sums = smoke.path_sums(rows)
    assert set(sums["decode_attention"]) == {"sts", "pool", "pp"}
    assert set(sums["dequant_matvec"]) == {"sts", "pool", "sts_mxu",
                                           "lm_split"}
    assert set(sums["glu_matmul"]) == {"tts_pool"}
    assert set(sums["glu_matvec"]) == {"pool", "tts_pool"}
    # K1, K2, K4 and K5 also run on the knob paths; K3 does not
    assert set(sums["int8_matvec"]) >= {"sts", "sts_mxu", "lm_split"}
    assert set(sums["decode_attention_mxu"]) == {"sts_mxu", "lm_split"}
    assert sums["glu_matmul"]["tts_pool"]["ms"] == next(
        e["ms"] for e in table if e["name"] == "glu_matmul")
    assert set(sums["decode_attention_fp8"]) == {"sts_fp8", "pool_fp8"}
    assert set(sums["ring_write4_fp8"]) == {"stt_fp8"}
    assert set(sums["int8_matvec_i8"]) == set(sums["attn_ffn_fused_i8"]) \
        == {"sts_i8"}
    assert set(sums["temporal_full_step_fp8"]) == {"sts_mega_fp8"}


def test_stt_config_is_the_stt_1b_class():
    """The STT phases' configuration: the stt-1b-class config, built as the
    tools build it, and its per-frame launches (K9 once and K11 once per
    layer, its k and v rings in one launch)."""
    mod = _load_smoke()
    cfg = mod.stt_config()
    assert (cfg.dim, cfg.num_layers, cfg.num_heads, cfg.hidden_dim) == \
        (2048, 16, 16, 8448)
    assert (cfg.context, cfg.n_q, cfg.dep_q, cfg.text_card) == \
        (750, 32, 0, 8000)
    assert (cfg.extra_heads_num, cfg.extra_heads_dim, cfg.delay_steps) == \
        (4, 6, 6)
    assert mod.stt_config(2).num_layers == 2
    assert mod.stt_launches(cfg) == {"decode_attention4": 16,
                                     "ring_write4": 16}
    assert [o for _, o in mod.stt_ring_states(750)] == [93, 500, 787]


_ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4, {}>(int)"


@pytest.mark.parametrize("design", ["one launch", "no rope",
                                    "helpers before", "helpers, no rope",
                                    "helpers before rope",
                                    "cast before rope", "two launches",
                                    "cast after"])
def test_ring_write_sequence_check(design, monkeypatch):
    """``check_ring_write_sequence`` on a profile's launch order: a layer
    whose ring write follows its rope's kernels (or its product, with no
    rope) and precedes K9's query cast passes; slot arithmetic or a row
    cast anywhere between the projection and the ring write (after the
    rope or before it), k and v in two launches (with the helpers between
    them), or a second copy before K9 fails."""
    mod = _load_smoke()

    def fail(msg):
        raise AssertionError(msg)

    monkeypatch.setattr(mod, "fail", fail)
    mul = _ELEMENTWISE.format("BinaryFunctor<float, float, float, Mul>")
    copy = _ELEMENTWISE.format("direct_copy_kernel_cuda(...)::lambda")
    rem = _ELEMENTWISE.format("remainder_kernel_cuda(...)::lambda")
    cast = _ELEMENTWISE.format("bfloat16_copy_kernel_cuda(...)::lambda")
    k11 = "void (anonymous namespace)::ring_write_kernel<int, float, bf16>"
    k9 = "void (anonymous namespace)::split_kernel<128, false, bf16>"
    gemm = "nvjet_tst_64x8_64x16_4x1_v_bz_TNN"
    rope = [mul, mul, copy, copy]
    layer = {"one launch": [gemm, *rope, k11, cast, k9],
             "no rope": [gemm, k11, cast, k9],
             "helpers before": [gemm, *rope, rem, cast, copy, k11, cast, k9],
             "helpers, no rope": [gemm, rem, cast, k11, cast, k9],
             "helpers before rope": [gemm, rem, cast, *rope, k11, cast, k9],
             "cast before rope": [gemm, cast, *rope, k11, cast, k9],
             "two launches": [gemm, *rope, rem, cast, copy, k11, rem, cast,
                              copy, k11, cast, k9],
             "cast after": [gemm, *rope, k11, cast, cast, k9]}[design]
    per_frame = 2 if design == "two launches" else 1
    names = (layer + [gemm, mul]) * 3
    if design in ("one launch", "no rope"):
        window = mod.check_ring_write_sequence("frame", names, 3, 1, rope)
        assert window == {"projection": gemm,
                          "before": rope if design == "one launch" else [],
                          "after": [cast]}
        with pytest.raises(AssertionError, match="ring-write launches"):
            mod.check_ring_write_sequence("frame", names, 2, 1, rope)
    else:
        with pytest.raises(AssertionError, match="around a ring write"):
            mod.check_ring_write_sequence("frame", names, 3 * per_frame, 1,
                                          rope)


def test_glu_norm_holds_staged_activations(smoke, monkeypatch):
    """K7's and K8's check with the norm fused (``GluNorm``): the staged
    activations read back through K6's identity are the plain norm's bf16
    rounding on the CPU; a kernel that computes the plain GLU on its own
    staged activations passes where they differ from the plain norm's
    only at a tie, and fails where one differs away from a tie or by more
    than one bf16 step."""
    from moshi_tpu_torch.quant.formats import rms_pre_norm
    from moshi_tpu_torch.runtime.synth import synth_quant_tensor
    gen = torch.Generator().manual_seed(5)
    qt = synth_quant_tensor("q4_k", (), 64, 256, gen, "cpu")
    x = torch.randn((8, 256), generator=gen).to(torch.bfloat16)
    alpha = (1 + 0.1 * torch.randn(256, generator=gen)).to(torch.bfloat16)
    xn = rms_pre_norm(x, alpha)
    xb = xn.to(torch.bfloat16).float()
    assert torch.equal(smoke.staged_activations(x, alpha), xb)
    assert smoke.norm_flips(xb, xn) == (0, True, 0.0)
    # the other bf16 neighbour of one element, on the far side of xn
    bits = xb.to(torch.bfloat16).view(torch.int16).clone()
    step = torch.where((xn[0, 3] > xb[0, 3]) == (xn[0, 3] > 0), 1, -1)
    other = bits.clone()
    other[0, 3] += step
    other = other.view(torch.bfloat16).float()
    n, adjacent, tie = smoke.norm_flips(other, xn)
    assert (n, adjacent) == (1, True) and 0 < tie < 2 ** -8
    far = bits.clone()
    far[0, 3] += 2 * step
    assert smoke.norm_flips(far.view(torch.bfloat16).float(), xn)[1] is False

    failures = []
    monkeypatch.setattr(smoke, "fail", failures.append)
    for staged, bad in ((xb, False), (other, True)):
        monkeypatch.setattr(smoke, "staged_activations",
                            lambda x, a, staged=staged: staged)
        held = smoke.GluNorm()
        for j in range(smoke.DRAWS):
            held.add(smoke.glu_on(staged, xn, qt, 0), x, qt, 0, alpha, j)
        assert held.rel == 0.0 and min(held.ctls) > smoke.TOL["glu_matvec"]
        held.hold("test")
        # this element lies farther from its boundary than a tie
        assert bool(failures) == bad
        assert held.flips == (smoke.DRAWS if bad else 0)


@pytest.mark.parametrize("cap,hd", [(750, 128), (48, 64)])
def test_k9_boundary_case_holds_the_chunking(cap, hd):
    """On ``k9_boundary_case``'s ring every K9 control, K3's chunking
    included, reads far above K9's limit (the card's sound readings on
    random rings stay <= 8.8e-5)."""
    from moshi_tpu_torch.nn import decode_attention as da
    mod = _load_smoke()
    mod.DEV = "cpu"
    gen = torch.Generator().manual_seed(3)
    off, qs, kc, vc = mod.k9_boundary_case(cap, 4, hd, gen)
    offset = torch.tensor([off], dtype=torch.int32)

    def run_plain(d, **kw):
        kw.setdefault("context", cap)
        return da.decode_attention4_plain(qs[d], kc, vc, offset, cap=cap,
                                          **kw)

    controls = mod._k9_controls(da, run_plain, off, cap, cap, True)
    assert all(on for _, on, _ in controls)
    tol = mod.TOL["decode_attention4"]
    for d in range(mod.DRAWS):
        ref = run_plain(d)
        for name, _, fn in controls:
            assert mod.rel_err(fn(d), ref) > 5 * tol, (name, d)
    with pytest.raises(ValueError):
        mod.k9_boundary_case(256, 4, hd, gen)


def test_per_frame_launches_match_7b_counts(smoke):
    """The 7B frame's counts.  Fused (the default): K1 122 calls of one
    launch each, K5 80, K2 48, K3 80, K4 1.  Unfused: K1 282 calls."""
    cfg = _LMConfig(delays=smoke._7B_DELAYS)
    assert smoke.per_frame_launches(cfg) == {
        "int8_matvec": 122, "attn_ffn_fused": 80, "dequant_matvec": 48,
        "decode_attention": 80, "ring_write": 1}
    assert smoke.per_frame_launches(cfg, fused=False) == {
        "int8_matvec": 282, "dequant_matvec": 48, "decode_attention": 80,
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



def test_chip_smoke_tts_phases_on_cpu(smoke, monkeypatch):
    """The TTS phases at a tiny size: K1 at 2 and 8 rows, K7, K9 and K11
    at B = 8; the card-against-CPU comparisons (here CPU against CPU, so
    they read no error and the controls are only logged); the TTS frame
    in q4_k and bf16 and the TTS pool with their launch counts asserted
    against the plain versions' calls; and the profiles."""
    tts = smoke.tts_config()
    assert (tts.dim, tts.num_layers, tts.hidden_dim, tts.context) == \
        (2048, 16, 8448, 500)
    assert tts.cross_attention and (tts.n_q, tts.dep_q) == (32, 32)
    assert smoke.tts_pool_launches(tts) == {
        "qmatmul": 50, "glu_matmul": 16, "decode_attention4": 16,
        "ring_write4": 16, "dequant_matvec": 416, "decode_attention": 128,
        "glu_matvec": 128}

    def small_tts(num_layers=0):
        return dataclasses.replace(
            tts, **{**_SMALL_TTS, "num_layers": num_layers or 2})

    monkeypatch.setattr(smoke, "tts_config", small_tts)
    for name, value in (("FRAMES_TTS_2L", 2), ("SEEDS_TTS", 1),
                        ("TTS_POOL_TICKS_2L", 2), ("TTS_FRAMES", 3),
                        ("TTS_BF16_FRAMES", 2), ("TTS_POOL_TICKS", 30)):
        monkeypatch.setattr(smoke, name, value)
    # CPU against CPU: the comparisons read zero and the controls cannot
    # be told apart from the limits at this size; they are logged here
    monkeypatch.setattr(smoke, "fail", lambda msg: print("would fail:", msg))
    cfg = smoke.tts_config()
    params = synth_lm_params(cfg, "q4_k", device="cpu", seed=0)
    gen = torch.Generator().manual_seed(2)
    rows = smoke.check_k1_rows(params, cfg, gen)
    rows += smoke.check_k7(params, cfg, gen, smoke.POOL_B)
    rows += smoke.check_tts_ring_kernels(cfg, gen, smoke.POOL_B)
    assert {r["kernel"] for r in rows} == {
        "int8_matvec", "glu_matmul", "decode_attention4", "ring_write4"}
    for r in rows:
        if "control_rel_err" in r:
            assert r["control_rel_err"] > r["tol_rel"] >= r["max_rel_err"]
    assert all(r["rows_equal_one_row"][0] == r["rows_equal_one_row"][1]
               for r in rows if "rows_equal_one_row" in r)
    mimi = MimiModel(MimiConfig(**_SMALL_MIMI_TTS))
    mparams = synth_mimi_params(mimi.cfg, device="cpu", seed=1)
    two = smoke.compare_tts_two_layers()
    assert two["readings"][0]["tokens_agree"] == \
        two["readings"][0]["tokens_total"] > 0
    assert set(two["controls"]) == {"K1 bf16 partials", "K3 p in f32",
                                    "K5 h_mid in bf16"}
    pool_two = smoke.compare_tts_pool_two_layers(mimi, mparams,
                                                 smoke.POOL_B)
    assert pool_two["transformer_out"] == pool_two["logits"] == 0.0
    assert pool_two["tokens_agree"] == pool_two["tokens_total"] > 0
    full = smoke.compare_tts_full_depth(cfg, params)
    assert full["passes"]
    tts_run = smoke.run_tts(cfg, params, mimi, mparams, 1.0)
    assert tts_run["launches_per_frame"] == smoke.tts_launches(cfg) == {
        "int8_matvec": 12 + 2 + 8 + 4, "attn_ffn_fused": 8,
        "dequant_matvec": 8, "decode_attention": 8, "decode_attention4": 2,
        "ring_write4": 2}
    dense = synth_lm_params(cfg, None, device="cpu", seed=0)
    bf16_run = smoke.run_tts(cfg, dense, mimi, mparams, 1.0, bf16=True)
    assert bf16_run["launches_per_frame"] == smoke.tts_launches(cfg, True) \
        == {"ring_write4": 2 + 8, "decode_attention4": 2 + 8}
    smoke.profile_tts(cfg, dense, mimi, mparams, bf16=True)
    pool_report, pool = smoke.run_tts_pool(cfg, params, mimi, mparams,
                                           smoke.POOL_B)
    assert pool_report["launches_per_tick"] == smoke.tts_pool_launches(cfg)
    assert pool_report["launches_per_tick"]["glu_matmul"] == 2
    assert any(e[1] == "attach" for e in pool_report["events"])
    smoke.profile_tts(cfg, params, mimi, mparams)
    smoke.profile_tts_pool(pool)
    floor = smoke.tts_floor_ms(cfg, params, 4.0)
    assert 0 < floor < smoke.tts_floor_ms(cfg, params, 4.0, batch=8) * 8


def test_chip_smoke_dequant_phases_on_cpu(smoke, monkeypatch):
    """The dequantization probe (one-hot rows through K6 and K2 against
    every scale; here every exponent with a few mantissas) and K2, K6 and
    K8 at the TTS pool's products: the cases follow the pool's launches
    per tick, and their rows give the TTS pool's sums for the three
    kernels."""
    monkeypatch.setattr(smoke, "PROBE_K", 64)
    monkeypatch.setattr(smoke, "PROBE_FULL", False)
    build.COUNTS.clear()
    probe = smoke.check_dequant_probe()
    assert set(probe) == {"q4_k", "q4_0", "q8_0"}
    assert build.COUNTS == {"qmatmul": 3, "dequant_matvec": 3}
    for fmt, out in probe.items():
        per = 8 if fmt == "q8_0" else 1
        assert out["qmatmul"]["rows"] * 2 >= out["scales"] * per
        assert out["qmatmul"]["exact"] == out["dequant_matvec"]["exact"] \
            == out["qmatmul"]["rows"] * 64
    tts = dataclasses.replace(smoke.tts_config(), **_SMALL_TTS,
                              num_layers=2)
    params = synth_lm_params(tts, "q4_k", device="cpu", seed=0)
    cases = smoke.tts_pool_matvec_cases(params, tts)
    launches = smoke.tts_pool_launches(tts)
    for kernel in ("qmatmul", "dequant_matvec", "glu_matvec"):
        assert sum(c[-1] for c in cases if c[1] == kernel) == \
            launches[kernel]
    rows = smoke.check_tts_pool_matvecs(params, tts, smoke.POOL_B)
    assert len(rows) == len(cases) == 10
    assert [r["shape"] for r in rows] == [
        c[0] for c in cases if c[1] != "glu_matvec"] + [
        "depformer linear_in (GLU)"]
    assert all(r["calls_per_tick"] == 0 and r["calls_per_tts_tick"] > 0
               for r in rows)
    sums = smoke.path_sums(rows)
    assert set(sums["qmatmul"]) == set(sums["dequant_matvec"]) == set(
        sums["glu_matvec"]) == {"tts_pool"}


def test_chip_smoke_mega_phases_on_cpu(smoke, monkeypatch):
    """The megakernel paths at a tiny size: K13, K14a and K14c against
    their plain versions, the 2-layer comparisons under
    MOSHI_TPU_MEGAKERNEL=all (sts_mega) and =dep at a card that is not a
    multiple of 128 (dep_mega, with its launches asserted), the LM frame
    fresh and on a full flat ring and the STS frame under =all with their
    launches asserted against the plain versions' calls, and the profiles.
    CPU against CPU, the comparisons read no error; the controls are
    held on the card, and here only logged."""
    import os
    failures = []
    monkeypatch.setattr(smoke, "fail", failures.append)
    monkeypatch.delenv("MOSHI_TPU_MEGAKERNEL", raising=False)
    cfg = lm.LMConfig(delays=smoke._7B_DELAYS)
    params = synth_lm_params(cfg, "q4_k", device="cpu", seed=0)
    rows = smoke.check_megakernels(params, cfg,
                                   torch.Generator().manual_seed(1))
    assert [r["kernel"] for r in rows] == [
        "temporal_full_step"] * 3 + ["dep_full_step"] + ["dep_frame_step"] * 2
    assert all(r["max_rel_err"] == 0.0 and r["control_rel_err"] > 0
               for r in rows)
    assert [r.get("calls_per_mega_frame") for r in rows] == [
        0, 1, 0, None, 0, 1]
    assert rows[3]["calls_per_dep_mega_frame"] == cfg.dep_q == 8
    assert all(r["tokens_agree"] == r["tokens_decided"] > 0
               for r in rows[4:])
    two = smoke.compare_mega_two_layers()
    assert len(two["readings"]) == 2 * smoke.SEEDS_MEGA
    assert all(r["transformer_out"] == 0.0 and r["dep_logits"] == 0.0
               and r["tokens_agree"] == r["tokens_total"] > 0
               for r in two["readings"])
    assert set(two["controls"]) == {"weights in f32", "K13 p in f32",
                                    "K14 p*v rounded"}
    dep = smoke.compare_dep_mega_two_layers()
    dcfg = lm.LMConfig(delays=smoke._7B_DELAYS, num_layers=2,
                       card=smoke.MEGA_K14A_CARD)
    assert dep["launches_per_frame"] == smoke.dep_mega_launches(dcfg) == {
        "int8_matvec": 4 + 1 + 16, "attn_ffn_fused": 2,
        "decode_attention": 2, "ring_write": 1, "dep_full_step": 8}
    assert dep["tokens_agree"] == dep["tokens_total"] > 0
    with smoke.megakernel("all"):
        fresh = smoke.run_lm(cfg, params, "fresh, megakernels",
                             lm.init_gen_state(cfg, 1, device="cpu",
                                               params=params), 1.0,
                             per_frame=smoke.mega_launches(cfg))
        full = smoke.run_lm(
            cfg, params, "full ring, megakernels", smoke.flat_long_session(
                cfg, lm.init_gen_state(cfg, 1, device="cpu", params=params),
                torch.Generator().manual_seed(2)), 1.0,
            per_frame=smoke.mega_launches(cfg))
        for run in (fresh, full):
            assert run["launches_per_frame"] == smoke.mega_launches(cfg) == {
                "temporal_full_step": 1, "dep_frame_step": 1,
                "int8_matvec": 2}
        mimi = MimiModel(MimiConfig(**_SMALL_MIMI))
        mparams = synth_mimi_params(mimi.cfg, device="cpu", seed=1)
        sts = smoke.run_sts(cfg, params, mimi, mparams, 1.0, mega=True)
        assert sts["launches_per_frame"] == smoke.mega_launches(cfg)
        smoke.profile_frames(cfg, params, mega=True)
        smoke.profile_sts(cfg, params, mimi, mparams, mega=True)
    assert "MOSHI_TPU_MEGAKERNEL" not in os.environ
    # CPU against CPU the controls may read within a limit set for the
    # 7B's widths; nothing else may fail
    bad = [f for f in failures if "cannot tell that rounding apart" not in f]
    assert not bad, bad


def test_chip_smoke_mxu_phases_on_cpu(smoke, monkeypatch):
    """The knob paths at a tiny size (``_SMALL_MXU``): K10 and K12 against
    their plain versions, the 2-layer comparisons under "sts_mxu" and
    "lm_split", the LM frame under both, fresh and on a full ring, and
    the STS frame under "sts_mxu" with their launches asserted against
    the plain versions' calls, and the profile; the knobs are restored
    after each.  CPU against CPU, the comparisons read no error; the
    controls are held on the card, and here only logged."""
    import os
    failures = []
    monkeypatch.setattr(smoke, "fail", failures.append)
    monkeypatch.setattr(lm, "LMConfig",
                        lambda **kw: _LMConfig(**{**_SMALL_MXU, **kw}))
    knobs = ("MOSHI_TPU_ATTN_MXU", "MOSHI_TPU_KSEG",
             "MOSHI_TPU_SPLIT_SPREAD")
    for name in knobs:
        monkeypatch.delenv(name, raising=False)
    cfg = lm.LMConfig(delays=smoke._7B_DELAYS)
    params = synth_lm_params(cfg, "q4_k", device="cpu", seed=0)
    rows = smoke.check_mxu_kernels(params, cfg,
                                   torch.Generator().manual_seed(1))
    assert [r["kernel"] for r in rows] == \
        ["decode_attention_mxu"] * 6 + ["int8_kseg", "int8_split"]
    assert [r["calls_per_mxu_frame"] for r in rows[:6]] == [
        2, 0, 0, 2 * 8, 0, 0]
    assert [r["chunk"] for r in rows[:6]] == [24, 24, 24, 8, 24, 8]
    assert all(r["max_rel_err"] == 0.0 for r in rows)
    assert set(rows[0]["controls"]) == {"K3", "p.v in f32",
                                        "scale after the sum", "K3's chunk"}
    assert set(rows[3]["controls"]) == {"K3", "p.v in f32"}   # hd 64
    assert rows[6]["segments"] == 2
    assert rows[6]["calls_per_mxu_frame"] == rows[7][
        "calls_per_split_frame"] == 2
    two = smoke.compare_mxu_two_layers()
    assert len(two["readings"]) == 2 * smoke.SEEDS_2L + 1
    assert all(r["transformer_out"] == 0.0 and r["dep_logits"] == 0.0
               and r["tokens_agree"] == r["tokens_total"] > 0
               for r in two["readings"])
    assert set(two["controls"]) == {
        "K10 p.v in f32", "K10 scale after the sum", "K3 in K10's place",
        "K1 bf16 partials"}
    assert smoke.mxu_launches(cfg) == {
        "int8_matvec": 2 + 1 + 1 + 16 + 8, "int8_kseg": 2,
        "attn_ffn_fused": 2 + 16, "dequant_matvec": 16,
        "decode_attention_mxu": 2 + 16, "ring_write": 1}
    for path in ("sts_mxu", "lm_split"):
        with smoke.knobs(path):
            for label, state in (
                    ("fresh", lm.init_gen_state(cfg, 1, device="cpu")),
                    ("full ring", smoke.long_session_state(
                        cfg, torch.Generator().manual_seed(2)))):
                run = smoke.run_lm(cfg, params, f"{label}, {path}", state,
                                   1.0, per_frame=smoke.mxu_launches(
                                       cfg, path))
                assert run["launches_per_frame"] == \
                    smoke.mxu_launches(cfg, path)
    assert not any(k in os.environ for k in knobs)
    mimi = MimiModel(MimiConfig(**_SMALL_MIMI))
    mparams = synth_mimi_params(mimi.cfg, device="cpu", seed=1)
    with smoke.knobs("sts_mxu"):
        sts = smoke.run_sts(cfg, params, mimi, mparams, 1.0,
                            per_frame=smoke.mxu_launches(cfg),
                            label="STS frame, sts_mxu")
        assert sts["launches_per_frame"] == smoke.mxu_launches(cfg)
        smoke.profile_frames(cfg, params, label="sts_mxu")
    assert not any(k in os.environ for k in knobs)
    # CPU against CPU the controls may read within a limit set for the
    # 7B's widths; nothing else may fail
    bad = [f for f in failures if "cannot tell that rounding apart" not in f]
    assert not bad, bad


def test_chip_smoke_workspace_phase_on_cpu(smoke, monkeypatch):
    """Phase 3 (workspace) at a tiny size (``_SMALL_MXU``: K3's chunk 16
    and K10's 24 on the 48-slot ring, the depformer's 8-slot ring one
    chunk): each case's two calls agree, its row gives the call's grid,
    and the knobs are restored.  On the CPU the wrappers run their plain
    versions, so no workspace exists; the card holds its sync region."""
    import os
    failures = []
    monkeypatch.setattr(smoke, "fail", failures.append)
    monkeypatch.setattr(lm, "LMConfig",
                        lambda **kw: _LMConfig(**{**_SMALL_MXU, **kw}))
    monkeypatch.delenv("MOSHI_TPU_ATTN_MXU", raising=False)
    monkeypatch.setattr(decode_attention, "_WORKSPACE", {})
    cfg = lm.LMConfig(delays=smoke._7B_DELAYS)
    rows = smoke.check_attention_workspace(
        cfg, torch.Generator().manual_seed(3), smoke.POOL_B)
    assert not failures
    assert [r["chunks"] for r in rows] == [3, 2, 1, 3, 3, 2, 3, 3, 1]
    assert [r["blocks_per_call"] for r in rows] == [
        6, 32, 4, 48, 6, 4, 48, 6, 4]
    assert all((r["sync_bytes"] == 0) == (r["chunks"] == 1) for r in rows)
    assert "MOSHI_TPU_ATTN_MXU" not in os.environ
    assert decode_attention._WORKSPACE == {}


def test_chip_smoke_fp8_phases_on_cpu(smoke, monkeypatch):
    """The fp8 paths at a tiny size: the card-against-CPU comparisons on
    fp8 rings (2 layers across the ring's wrap, at B = 8, the full depth,
    the STT), the LM frame on a full fp8 ring, the STS frame, the pool and
    the STT frame with their launches asserted against the plain
    versions' calls, and the memory readings.  CPU against CPU, the
    frames read no error and the rings no flip; the controls are held on
    the card, and here only logged."""
    failures = []
    monkeypatch.setattr(smoke, "fail", failures.append)
    for name, value in (("SEEDS_FP8", 1), ("FRAMES_32L_FP8", 1)):
        monkeypatch.setattr(smoke, name, value)
    full = _LMConfig(delays=smoke._7B_DELAYS)
    assert smoke.fp8_launches(smoke.per_frame_launches(full), 32) == {
        "int8_matvec": 122, "attn_ffn_fused": 80, "dequant_matvec": 48,
        "decode_attention": 48, "decode_attention_fp8": 32,
        "ring_write_fp8": 1}
    cfg = lm.LMConfig(delays=smoke._7B_DELAYS)
    params = synth_lm_params(cfg, "q4_k", device="cpu", seed=0)
    scfg = smoke.stt_config()
    sparams = synth_lm_params(scfg, None, device="cpu", seed=0)
    got = smoke.compare_fp8(cfg, params, scfg, smoke.POOL_B)
    checks = got["two_layer"] + got["stt_two_layer"] + [
        got["pool_two_layer"], got["full_depth"]]
    for r in checks:
        assert r["transformer_out"] == 0.0 and r["logits"] == 0.0
        assert r["tokens_agree"] == r["tokens_total"] > 0
        rings = r["rings"]
        assert rings["flips"] == rings["stray"] == 0 and rings["rule_holds"]
        assert rings["written"] > 0 and rings["control_shift"] > 0
    # the rows-through-bf16 control flips some of the written elements
    # (about 0.4% of them: none in the smallest check at this size)
    assert sum(r["rings"]["control_flip_share"] for r in checks) > 0
    assert set(got["two_layer"][0]["controls"]) == {"K1 bf16 partials"}
    assert set(got["full_depth"]["controls"]) == {"K1 bf16 partials"}
    assert set(got["pool_two_layer"]["controls"]) == {"K3 p in f32"}
    assert set(got["stt_two_layer"][0]["controls"]) == {"K9 p in f32"}
    # the 2-layer sessions wrap the ring: half of the frames before it
    assert smoke.FRAMES_FP8 // 2 < smoke.FRAMES_FP8
    fcfg = smoke.fp8_config(cfg)
    per_frame = smoke.fp8_launches(smoke.per_frame_launches(fcfg), 2)
    run = smoke.run_lm(fcfg, params, "full ring, fp8 rings",
                       smoke.long_session_state(
                           fcfg, torch.Generator().manual_seed(3)),
                       1.0, per_frame=per_frame)
    assert run["launches_per_frame"] == per_frame
    mimi = MimiModel(MimiConfig(**_SMALL_MIMI))
    mparams = synth_mimi_params(mimi.cfg, device="cpu", seed=1)
    sts = smoke.run_sts(fcfg, params, mimi, mparams, 1.0,
                        per_frame=per_frame, label="STS frame, fp8 rings")
    assert sts["launches_per_frame"] == per_frame
    per_tick = smoke.fp8_launches(smoke.pool_launches(fcfg, params), 2)
    pool_fp8, pool, _ = smoke.run_pool(fcfg, params, mimi, mparams,
                                       smoke.POOL_B, per_tick=per_tick,
                                       label="SessionPool, fp8 rings")
    assert pool_fp8["launches_per_tick"] == per_tick
    assert pool.state["lm"]["transformer"]["k"].dtype == \
        torch.float8_e4m3fn
    mem = smoke.fp8_memory(cfg, 1, dict(pool_fp8, kv_transient=1.0),
                           pool_fp8)
    assert mem["bf16"]["kv_bytes_per_session"] == \
        2 * mem["fp8"]["kv_bytes_per_session"]
    sfcfg = smoke.fp8_config(scfg)
    stt = smoke.run_stt(sfcfg, sparams, mimi, mparams, 1.0,
                        per_frame=smoke.fp8_launches(
                            smoke.stt_launches(sfcfg), 0),
                        label="STT frame, fp8 rings")
    assert stt["launches_per_frame"] == {"decode_attention4_fp8": 2,
                                         "ring_write4_fp8": 2}
    smoke.profile_stt(sfcfg, sparams, mimi, mparams,
                      label="STT frame, fp8 rings")
    # CPU against CPU the controls may read within a limit set for the
    # 7B's widths; nothing else may fail
    bad = [f for f in failures if "cannot tell that rounding apart" not in f]
    assert not bad, bad


@pytest.mark.parametrize("kernel", ["K3", "K9"])
def test_flip_rule_tells_a_flip_from_a_fault(kernel):
    """K3's and K9's rule (``flip_score``): one head moved by as much as
    the limit plus one flipped probability passes; two heads moved so
    break it; so do the control (p in f32) and a planted fault (a slot
    dropped from the window)."""
    from moshi_tpu_torch.nn import decode_attention as da
    mod = _load_smoke()
    mod.DEV = "cpu"
    gen = torch.Generator().manual_seed(4)
    cap, h, hd = 256, 8, 64
    bf = torch.bfloat16
    k = torch.randn((1, cap, h, hd), generator=gen).to(bf)
    v = torch.randn((1, cap, h, hd), generator=gen).to(bf)
    q, ck, cv = (torch.randn((1, h, hd), generator=gen).to(bf)
                 for _ in range(3))
    if kernel == "K3":
        tol = mod.TOL["decode_attention"]
        off = torch.tensor([cap + 5], dtype=torch.int32)

        def run(context=cap):
            return da.decode_attention_plain(q, k, v, ck, cv, off, cap=cap,
                                             context=context,
                                             chunk=da.chunk_for(cap))
        bound = mod.flip_bound(q, k, v, off, cap=cap, context=cap, cur_k=ck)
    else:
        tol = mod.TOL["decode_attention4"]
        off = torch.tensor([cap + 5], dtype=torch.int32)

        def run(context=cap):
            return da.decode_attention4_plain(q, k, v, off, cap=cap,
                                              context=context)
        bound = mod.flip_bound(q, k, v, off, cap=cap, context=cap)
    ref = run()
    scale = float(ref.abs().max())
    assert bound.shape == (1, h) and bool((bound > 0).all())
    assert mod.flip_score(ref, ref, bound, tol) == 0.0
    one, two = ref.clone(), ref.clone()
    move = 0.99 * (tol * scale + bound[0])
    one[0, 3] += move[3]
    two[0, 3] += move[3]
    two[0, 5] += move[5]
    assert mod.flip_score(one, ref, bound, tol) <= 1.0
    assert mod.flip_score(two, ref, bound, tol) > 1.0
    with mod.swapped(da, "_bf16_round", lambda t: t):
        assert mod.flip_score(run(), ref, bound, tol) > 1.0
    assert mod.flip_score(run(cap - 40), ref, bound, tol) > 1.0
    failures = []
    mod.fail = failures.append
    mod.check_rule("rule", "decode_attention", 0.9, 1.5)
    assert not failures
    mod.check_rule("rule", "decode_attention", 1.1, 1.5)
    mod.check_rule("rule", "decode_attention", 0.9, 0.95)
    assert len(failures) == 2 and "cannot tell" in failures[1]


def test_chip_smoke_phase10_on_cpu(smoke, monkeypatch):
    """Phase 10 at a tiny size: K1 and K5 on i8 weights against their
    plain versions and, bit for bit, the packed weights' (K1 also on a
    synthesized q4_0 weight), the frames on i8 against packed weights at
    temp 0 and sampled, the LM and STS frames on i8 weights with their
    launches asserted (K1 and K5 in their i8 forms, K2 for the depformer's
    packed q4_0 linear_out); K13 on fp8 flat rings against its plain
    version, its bf16 instance on the rings widened and its row probe, the
    2-layer megakernel frames on fp8 rings card against CPU with the flip
    rule on the rings, and the LM and STS frames under
    MOSHI_TPU_MEGAKERNEL=all on fp8 rings with their launches asserted.
    CPU against CPU, the frames read no error and the rings no flip; the
    controls are held on the card, and here only logged."""
    import os
    from moshi_tpu_torch.quant.formats import i8_storage_tree
    failures = []
    monkeypatch.setattr(smoke, "fail", failures.append)
    monkeypatch.delenv("MOSHI_TPU_MEGAKERNEL", raising=False)
    monkeypatch.setattr(smoke, "FRAMES_I8", 2)
    cfg = lm.LMConfig(delays=smoke._7B_DELAYS)
    params = synth_lm_params(cfg, "q4_k", device="cpu", seed=0)
    iparams = i8_storage_tree(params)
    gen = torch.Generator().manual_seed(1)
    rows = smoke.check_i8_kernels(params, iparams, cfg, gen)
    assert [r["kernel"] for r in rows] == \
        ["int8_matvec_i8"] * 7 + ["attn_ffn_fused_i8"] * 2
    assert [r["calls_per_i8_frame"] for r in rows] == [
        2, 2, 1, 1, 2 * 8, 8, 0, 2, 2 * 8]
    assert rows[6]["fmt"] == "q4_0" and rows[6]["control_rel_err"] > 0
    assert all(r["equals_packed"] for r in rows if r["calls_per_i8_frame"])
    assert all(r["max_rel_err"] == 0.0 for r in rows)
    frames = smoke.compare_i8_frames(cfg, params, iparams, gen)
    assert frames["bit_for_bit"] and frames["sampled_tokens_equal"]
    per_i8 = smoke.i8_launches(smoke.per_frame_launches(cfg))
    assert per_i8 == {"int8_matvec_i8": 2 * 2 + 1 + 1 + 16 + 8,
                      "attn_ffn_fused_i8": 2 + 16, "dequant_matvec": 16,
                      "decode_attention": 2 + 16, "ring_write": 1}
    run = smoke.run_lm(cfg, iparams, "fresh session, i8 weights",
                       lm.init_gen_state(cfg, 1, device="cpu"), 1.0,
                       per_frame=per_i8)
    assert run["launches_per_frame"] == per_i8
    mimi = MimiModel(MimiConfig(**_SMALL_MIMI))
    mparams = synth_mimi_params(mimi.cfg, device="cpu", seed=1)
    sts = smoke.run_sts(cfg, iparams, mimi, mparams, 1.0, per_frame=per_i8,
                        label="STS frame, i8 weights")
    assert sts["launches_per_frame"] == per_i8
    assert sts["digests"] == smoke.run_sts(cfg, params, mimi, mparams,
                                           1.0)["digests"]
    with monkeypatch.context() as m:
        m.setattr(smoke, "check_limit", lambda *a: None)
        k13 = smoke.check_k13_fp8(params, cfg,
                                  torch.Generator().manual_seed(2))
    assert [r["kernel"] for r in k13] == ["temporal_full_step_fp8"] * 3
    assert [r["calls_per_mega_fp8_frame"] for r in k13] == [0, 1, 0]
    assert all(r["max_rel_err"] == 0.0 and r["bf16_instance_equal"]
               and r["rows_e4m3_steps"] == 0 for r in k13)
    assert k13[-1]["probe_nan"] > 0 and \
        k13[-1]["probe_saturating_control"] > 0
    two = smoke.compare_mega_fp8_two_layers()
    assert two["transformer_out"] == 0.0 and two["logits"] == 0.0
    assert two["tokens_agree"] == two["tokens_total"] > 0
    assert two["rings"]["flips"] == two["rings"]["stray"] == 0
    assert two["rings"]["rule_holds"] and two["rings"]["written"] > 0
    fcfg = smoke.fp8_config(cfg)
    assert smoke.mega_fp8_launches(cfg) == {
        "temporal_full_step_fp8": 1, "dep_frame_step": 1, "int8_matvec": 2}
    with smoke.megakernel("all"):
        run = smoke.run_lm(fcfg, params, "fresh, megakernels, fp8 rings",
                           lm.init_gen_state(fcfg, 1, device="cpu",
                                             params=params), 1.0,
                           per_frame=smoke.mega_fp8_launches(cfg))
        assert run["launches_per_frame"] == smoke.mega_fp8_launches(cfg)
        sts = smoke.run_sts(fcfg, params, mimi, mparams, 1.0, mega=True,
                            per_frame=smoke.mega_fp8_launches(cfg),
                            label="STS frame, megakernels, fp8 rings")
        assert sts["launches_per_frame"] == smoke.mega_fp8_launches(cfg)
    assert "MOSHI_TPU_MEGAKERNEL" not in os.environ
    # CPU against CPU the controls may read within a limit set for the
    # 7B's widths; nothing else may fail
    bad = [f for f in failures if "cannot tell that rounding apart" not in f]
    assert not bad, bad


def test_chip_smoke_k9_workspace_phase_on_cpu(smoke, monkeypatch):
    """Phase 3 (workspace) for K9 at a tiny size (the small STT's 48-slot
    ring and the small TTS class's 24-slot ring, one chunk each): each
    case's two calls agree and its row gives the call's grid.  On the CPU
    the wrapper runs its plain version, so no workspace exists."""
    failures = []
    monkeypatch.setattr(smoke, "fail", failures.append)
    monkeypatch.setattr(decode_attention, "_WORKSPACE", {})
    scfg = dataclasses.replace(smoke.stt_config(), **_SMALL_STT,
                               num_layers=2)
    tcfg = dataclasses.replace(smoke.tts_config(), **_SMALL_TTS,
                               num_layers=2)
    rows = smoke.check_k9_workspace(scfg, tcfg,
                                    torch.Generator().manual_seed(3),
                                    smoke.POOL_B)
    assert not failures
    assert len(rows) == 8
    sh, th = (c.transformer.mha.num_heads for c in (scfg, tcfg))
    assert [r["blocks_per_call"] for r in rows] == [
        sh, smoke.POOL_B * th, sh, sh, th, smoke.POOL_B * th, sh, sh]
    assert all(r["chunks"] == 1 and r["sync_bytes"] == 0 for r in rows)
    assert decode_attention._WORKSPACE == {}


def test_chip_smoke_scan_and_session_phases_on_cpu(smoke, monkeypatch):
    """The offline scans and the streaming sessions at a tiny size (a Mimi
    of context 16: an 8-frame chunk, so that 10 frames take two calls):
    the STS and STT scans in turns with their launches asserted against
    the plain versions' calls and their frame loops (the LM phase bit for
    bit), the profiles, the 2-layer scans (CPU against CPU), the
    mid-stream scan, LMGenerator on the STS LM and with the machine on the
    TTS class (against TTSPipeline.step), MimiStreamer; and the kernel
    table's new paths."""
    failures = []
    monkeypatch.setattr(smoke, "fail", failures.append)
    for name, value in (("SCAN_FRAMES", 10), ("SCAN_FRAMES_2L", 2),
                        ("SCAN_MID_FRAMES", 6), ("SCAN_PROFILE_FRAMES", 3),
                        ("SESSION_FRAMES", 5), ("TTS_SESSION_FRAMES", 5),
                        ("STREAMER_FRAMES", 3)):
        monkeypatch.setattr(smoke, name, value)
    tts = smoke.tts_config()

    def small_tts(num_layers=0):
        return dataclasses.replace(
            tts, **{**_SMALL_TTS, "num_layers": num_layers or 2})

    monkeypatch.setattr(smoke, "tts_config", small_tts)
    cfg = lm.LMConfig(delays=smoke._7B_DELAYS)
    params = synth_lm_params(cfg, "q4_k", device="cpu", seed=0)
    scfg = smoke.stt_config()
    sparams = synth_lm_params(scfg, None, device="cpu", seed=0)
    mimi = MimiModel(MimiConfig(**_SMALL_MIMI))
    mparams = synth_mimi_params(mimi.cfg, device="cpu", seed=1)
    held, sts = smoke.run_sts_scan(cfg, params, mimi, mparams, 1.0)
    assert sts["launches_per_frame"] == smoke.per_frame_launches(cfg)
    assert sts["lm_bit_equal"] and len(sts["ms_per_frame_turns"]) == 2
    assert set(sts["split_ms_per_frame"]) == {"encode", "lm", "decode"}
    assert sts["chunk"] == 8 and sts["codes"]["decided"] > 0
    assert set(sts["codes"]["controls"]) == set(
        sts["control_audio_rel_err"]) == {n for n, _ in smoke._MIMI_CONTROLS}
    prof = smoke.profile_scan(held, mparams, params)
    assert set(prof["per_frame"]) == {"offline_encode", "offline_decode",
                                      "streaming", "lm_phase"}
    mid = smoke.run_scan_mid_stream(cfg, params, mimi, mparams)
    assert mid["bit_equal"] and mid["grown"] == [16 + 2 * 8] * 2
    assert mid["caps"] == [16, 16]
    stt = smoke.run_stt_scan(scfg, sparams, mimi, mparams, 1.0)
    assert stt["launches_per_frame"] == smoke.stt_launches(scfg)
    assert stt["lm_bit_equal"]
    two = smoke.compare_scan_two_layers(mimi, mparams, mimi)
    for side in ("sts", "stt"):
        assert two[side]["passes"]
        assert two[side]["tokens_agree"] == two[side]["tokens_total"] > 0
        assert two[side]["codes_equal"] == two[side]["codes_decided"] > 0
    assert two["sts"]["audio_rel_err"] == 0.0
    session = smoke.run_session(cfg, params)
    assert session["frames_equal"] == 5
    assert session["launches_per_frame"] == smoke.per_frame_launches(cfg)
    tcfg = smoke.tts_config()
    tparams = synth_lm_params(tcfg, "q4_k", device="cpu", seed=0)
    tmimi = MimiModel(MimiConfig(**_SMALL_MIMI_TTS))
    tts_session = smoke.run_tts_session(
        tcfg, tparams, tmimi, synth_mimi_params(tmimi.cfg, device="cpu",
                                                seed=1))
    assert tts_session["frames_equal"] == 5
    assert tts_session["lead_in"] == 3
    streamer = smoke.check_mimi_streamer(mimi, mparams, cfg.runtime_dep_q)
    assert streamer["frames_equal"] == 3
    # CPU against CPU the 2-layer scans read no error, so their controls
    # (held on the card at full width) fail here; nothing else may
    print("\n".join(failures))
    assert all("control" in f for f in failures), failures


def test_chip_smoke_load_and_tts_demux_phases_on_cpu(smoke, monkeypatch):
    """Phase 8's new paths at a tiny size: "load" (the q4_k tree through
    GGUF, every leaf equal, the frames of both trees bit for bit with the
    frame's launches; the Mimi round trip; quantize on load with the
    native quantizer against numpy, ties and all) and "tts_demux" (the TTS
    class with the demuxed stream and depformer RoPE: 2 layers CPU
    against CPU, whose controls must still move the readings, and the
    frame with its launches asserted: the TTS frame's and K1 4 more)."""
    failures = []
    monkeypatch.setattr(smoke, "fail", failures.append)
    tts = smoke.tts_config()

    def small_tts(num_layers=0):
        return dataclasses.replace(
            tts, **{**_SMALL_TTS, "num_layers": num_layers or 2})

    monkeypatch.setattr(smoke, "tts_config", small_tts)
    monkeypatch.setattr(smoke, "TTS_DEMUX_FRAMES", 2)
    cfg = lm.LMConfig(delays=smoke._7B_DELAYS)
    params = synth_lm_params(cfg, "q4_k", device="cpu", seed=0)
    mimi = MimiModel(MimiConfig(**_SMALL_MIMI))
    mparams = synth_mimi_params(mimi.cfg, device="cpu", seed=1)
    load = smoke.run_load(cfg, params, mimi, mparams)
    assert load["launches_per_frame"] == smoke.per_frame_launches(cfg)
    assert load["frames_equal"] and load["tensors"] > 50
    assert load["mimi"]["frame_equal"]
    q = load["quantize_on_load"]
    assert q["values"] == 2 * 2 * (3 * 256 * 256 + 256 * 256
                                   + 2 * 512 * 256 + 256 * 512)
    assert q["ties"] > 0 and q["values_differ"] > 0
    assert q["q4_k_mean_rel"] < 0.02
    # the 7B synthetic scales are f16 values: the check finds none off
    assert smoke.scales_f16_exact(params)[1] == 0
    tcfg = smoke.tts_demux_config()
    assert tcfg.demux_second_stream and tcfg.depformer.rope_max_period
    assert smoke.tts_second_ahead() == 2
    tmimi = MimiModel(MimiConfig(**_SMALL_MIMI_TTS))
    tmparams = synth_mimi_params(tmimi.cfg, device="cpu", seed=1)
    two = smoke.compare_tts_demux_two_layers(tmimi, tmparams)
    assert two["depformer_form"] == "stacked"
    assert two["transformer_out"] == two["logits"] == 0.0
    assert two["tokens_agree"] == two["tokens_total"] > 0
    assert any(t >= tcfg.text_card + 1 for t in two["machine_text"])
    for name, c in two["controls"].items():
        moved = max(c["transformer_out"], c["logits"], c["dep_logits"])
        assert moved > 0, name
    run = smoke.run_tts_demux(tmimi, tmparams)
    assert run["depformer_form"] == "stacked"
    assert run["launches_per_frame"] == smoke.tts_demux_launches(tcfg) == {
        "int8_matvec": 12 + 2 + 8 + 4 + 4, "attn_ffn_fused": 8,
        "dequant_matvec": 8, "decode_attention": 8, "decode_attention4": 2,
        "ring_write4": 2}
    # CPU against CPU the comparison reads no error, so its controls
    # (held on the card at full width) fail here; nothing else may
    print("\n".join(failures))
    assert all("control" in f for f in failures), failures



@pytest.mark.parametrize("fmt", ["q4_k", "q4_0", "q8_0", "q4_k i8"])
def test_reused_plain_weights_keep_the_bits(fmt):
    """The comparisons' memo of the CPU plain versions' weight operands:
    K1 (with its GLU and norm, and its control), K12's lanes and the
    dequant product give the same bits from a kept operand as from a
    fresh one, in every format and storage, and a weight changed in place
    (values and scales) is formed anew."""
    mod = _load_smoke()
    from moshi_tpu_torch.quant.formats import quantize
    gen = np.random.default_rng(7)
    base = fmt.split()[0]
    o, k = 96, 8192
    flat = quantize(gen.standard_normal((2 * o, k)).astype(np.float32)
                    * 0.02, base, native=False, device="cpu")
    w = flat._map(lambda a: a.reshape((2, o) + tuple(a.shape[1:])),
                  shape=(o, k))             # two stacked layers
    if fmt.endswith("i8"):
        w = w.with_i8_storage()
    x = torch.from_numpy(gen.standard_normal((3, k)).astype(np.float32))
    alpha = torch.from_numpy(
        gen.standard_normal((2, k)).astype(np.float32)).abs()

    def outputs():
        out = []
        for layer in (0, 1):
            if base == "q4_k" or w.unpacked:
                out.append(matmul_int8.int8_matvec_plain(
                    x, w, layer, alpha[layer], glu=True))
                out.append(mod.int8_control(x[:1], w, layer))
            if base == "q4_k" and not w.unpacked:
                out.append(matmul_int8.int8_matvec_kseg_plain(x[:1], w,
                                                              layer))
            if not w.unpacked or base == "q8_0":
                out.append(matmul.dequant_matvec_plain(x, w, layer,
                                                       alpha[layer]))
        return out

    fresh = outputs()
    with mod.reused_plain_weights():
        for _ in range(2):      # formed, then kept
            assert all(torch.equal(a, b) for a, b in zip(outputs(), fresh))
        (w.d if w.es is None else w.es).mul_(2.0)
        w.q.view(-1)[:k] ^= 1 if w.unpacked else 0x11
        edited = outputs()
    assert all(torch.equal(a, b) for a, b in zip(edited, outputs()))
    assert not any(torch.equal(a, b) for a, b in zip(edited, fresh))


# a small PersonaPlex: the config's 16 codebooks, 16 depformer steps run at
# 8, ring of 8 and card of 2048 (PROMPT_TOKENS needs codes up to 2008), the
# small LMs' widths
_SMALL_PP = dict(_SMALL, card=2048, hidden_dim=512)


def test_chip_smoke_personaplex_and_capture_phases_on_cpu(smoke,
                                                          monkeypatch):
    """Phase 11 at a tiny size, CPU against CPU: "personaplex" (2 layers
    primed from a voice file and a prompt, rings, cache and offset, then
    frames with phase 4's controls; the full run's priming and frames with
    their launches asserted, per priming frame the temporal stack alone)
    and "capture" (names, order, first_divergence, the unfused launches
    while recording, replay on both sides, SEANet replay, the planted
    fault named)."""
    from moshi_tpu_torch.config import load_config
    failures = []
    monkeypatch.setattr(smoke, "fail", failures.append)
    full = _LMConfig.from_moshi_config(load_config(
        str(smoke.PERSONAPLEX_CONFIG)))
    assert (full.personaplex, full.runtime_dep_q, full.hidden_dim,
            full.depformer.mha.cap, full.cache_len) == (True, 8, 16896, 8, 4)

    def small_pp(num_layers=0):
        return dataclasses.replace(
            full, **{**_SMALL_PP, "num_layers": num_layers or 2})

    monkeypatch.setattr(smoke, "personaplex_config", small_pp)
    monkeypatch.setattr(smoke, "PP_PRIME", (5, 2, 3))
    monkeypatch.setattr(smoke, "PP_FRAMES", 3)
    mimi = MimiModel(MimiConfig(**{**_SMALL_MIMI, "codebook_size": 2048}))
    mparams = synth_mimi_params(mimi.cfg, device="cpu", seed=1)
    cfg = small_pp()
    frame, prime = smoke.personaplex_launches(cfg)
    assert prime == {"int8_matvec": 4, "attn_ffn_fused": 2,
                     "decode_attention": 2, "ring_write": 1}
    assert frame == {"int8_matvec": 4 + 2 + 16 + 8, "attn_ffn_fused": 18,
                     "dequant_matvec": 16, "decode_attention": 18,
                     "ring_write": 1}
    two = smoke.compare_personaplex_two_layers()
    assert two["prime_frames"] == 4 + 2 * 2 + 3
    assert two["rings_held"] == {"k": True, "v": True}
    assert two["cache_equal"] and two["ring_rel_err"] == 0.0
    assert two["transformer_out"] == two["logits"] == 0.0
    assert two["tokens_agree"] == two["tokens_total"] > 0
    assert set(two["controls"]) == {"K1 bf16 partials", "K5 h_mid in bf16"}
    assert two["split_gaps"] == [] and two["least_gap"] > 0
    run = smoke.run_personaplex(mimi, mparams)
    assert run["prime_frames"] == 5 + 2 * 2 + 3
    assert run["per_step_weights_are_views"]
    assert run["prime"]["embedding"]["frames"] == 5
    assert run["prime"]["forced"]["frames"] == 7
    assert run["launches_per_frame"] == frame
    assert run["timer"]["frames"] == 3
    assert set(run["timer"]) == {"frames", "fps", "p50_ms", "p95_ms",
                                 "p99_ms", "over_budget", "realtime"}
    cap = smoke.check_capture(mimi, mparams)
    assert cap["launches_per_frame"] == smoke.per_frame_launches(
        lm.LMConfig(delays=smoke._7B_DELAYS, num_layers=2), fused=False)
    assert "attn_ffn_fused" not in cap["launches"]
    assert cap["order_equal"] and cap["tokens_held"]
    assert cap["taps_compared"] == cap["taps"]
    assert cap["first_divergence"] is None
    assert cap["largest_tap_err"] == 0.0
    assert cap["planted"][:2] == ("lm/temporal/qkv", 1)
    for side in ("card kernels", "CPU plain versions"):
        assert cap["replay"][side]["first_fail"] is None
        assert cap["replay"][side]["ops"] == 5 * 2
        assert set(cap["replay"][side]["largest"]) == {
            "qkv", "attn", "attn_out(o_proj)", "glu", "ffn+res"}
    assert cap["seanet_ops"] == len(mimi.encoder.modules)
    # the per-step weights of a general schedule are a gather, and the
    # check tells them apart
    general = dataclasses.replace(cfg, depformer_schedule=(
        (1, 0) + tuple(range(2, 16))))
    params = synth_lm_params(cfg, "q4_k", device="cpu", seed=0)
    assert smoke.shares_storage(
        lm._per_step_weights(cfg, params["depformer"]), params["depformer"])
    assert not smoke.shares_storage(
        lm._per_step_weights(general, params["depformer"]),
        params["depformer"])
    # CPU against CPU the comparison reads no error, so its controls (held
    # on the card at full width) may pass here; nothing else may fail
    print("\n".join(failures))
    assert all("control" in f for f in failures), failures


def test_split_gaps_name_the_cpu_gap_where_the_choices_differ(smoke):
    """``split_gaps`` reads the CPU's top-1/top-2 gap at each text or
    depformer token where the card chose another token, and the least gap
    over every token."""
    text = torch.tensor([[0.0, 4.0, 3.0]])                # gap 1/4
    dep = torch.tensor([[[8.0, 0.0, 7.9], [0.0, 2.0, -8.0]]])
    cpu = [{"logits": text, "dep_logits": dep}]
    same = [{"text": torch.tensor([1]), "dep_tokens": torch.tensor([[0, 1]])}]
    splits, least = smoke.split_gaps(same, cpu)
    assert splits == [] and least == pytest.approx(0.1 / 8)
    near = [{"text": torch.tensor([1]), "dep_tokens": torch.tensor([[2, 1]])}]
    splits, _ = smoke.split_gaps(near, cpu)
    assert splits == [pytest.approx(0.1 / 8)]
    far = [{"text": torch.tensor([2]), "dep_tokens": torch.tensor([[0, 1]])}]
    assert smoke.split_gaps(far, cpu)[0] == [pytest.approx(0.25)]
    no_dep = [{"logits": text, "dep_logits": None}]
    assert smoke.split_gaps(far, no_dep)[0] == [pytest.approx(0.25)]


def _small_config_file(path, src, **over):
    """A config file: ``src``'s keys with ``over`` written over them."""
    import json
    doc = json.loads(Path(src).read_text()) if src else {}
    doc.update(over)
    path.write_text(json.dumps(doc))
    return path


def test_chip_smoke_tools_phase_on_cpu(smoke, monkeypatch, tmp_path):
    """Phase 12 at a tiny size, the tools run on the CPU through their
    ``main(argv)``: the tool files (GGUF, SentencePiece model, wav,
    config), mimi-encode/decode against ``MimiStreamer`` bit for bit,
    moshi-sts against ``STSPipeline`` bit for bit with its launches,
    moshi-stt per frame and ``--scan``, moshi-tts with the device FSM and
    ``--scan`` (lead-in frames counted apart), personaplex's priming;
    the config files are small ones of the same kinds, Mimi a small one
    with the real 1920-sample frame (tools build ``MimiConfig(n_q=...)``)
    and a codebook of the LMs' card."""
    from moshi_tpu_torch.config import load_config
    from moshi_tpu_torch.models import mimi as mimi_mod
    failures = []
    monkeypatch.setattr(smoke, "fail", failures.append)
    # the tools build their LMConfig from the files: the real class
    monkeypatch.setattr(lm, "LMConfig", _LMConfig)
    # the STT input (27 frames) within one window of Mimi's transformer,
    # as the stt-1b class's 46 frames are within the real Mimi's 250
    # positions: a ring of context slots that wraps at T = 2 drops a key
    # of the window, which the offline scan keeps
    small_mimi = dict(_SMALL_MIMI, codebook_size=2048, transformer_context=64,
                      seanet=SEANetConfig(dimension=32, n_filters=4,
                                          ratios=(8, 6, 5, 4)))
    monkeypatch.setattr(mimi_mod, "MimiConfig",
                        lambda **kw: MimiConfig(**{**small_mimi, **kw}))
    width = dict(dim=256, num_heads=4, num_layers=2, hidden_scale=2.0,
                 card=2048, text_card=512)
    dep = dict(depformer_dim=256, depformer_num_heads=4,
               depformer_num_layers=2, depformer_dim_feedforward=576,
               depformer_low_rank_embeddings=32)
    root = Path(smoke.__file__).resolve().parent
    files = {
        "stt": _small_config_file(
            tmp_path / "stt.json", smoke.STT_CONFIG, **width, context=48,
            n_q=16, delays=[0] * 17),
        "tts": _small_config_file(
            tmp_path / "tts.json", smoke.TOOL_CONFIGS["tts"], **width,
            **dep, context=24, n_q=4, dep_q=4, delays=[0, 0, 2, 2, 2],
            tts_config={"audio_delay": 0.24, "second_stream_ahead": 2}),
        "personaplex": _small_config_file(
            tmp_path / "pp.json", root / "configs" / "personaplex-config.json",
            **width, **dep, context=48),
    }
    monkeypatch.setattr(smoke, "TOOL_CONFIGS", files)

    def from_file(kind, audio_delay=0.0, cross=False):
        mc = load_config(str(files[kind]))
        mc.cross_attention = cross
        return lambda num_layers=0: _LMConfig.from_moshi_config(
            mc, audio_delay=audio_delay)

    monkeypatch.setattr(smoke, "stt_config", from_file("stt", 0.5))
    monkeypatch.setattr(smoke, "tts_config", from_file("tts", 0.24, True))
    monkeypatch.setattr(smoke, "personaplex_config",
                        from_file("personaplex"))
    for name, value in (("TOOL_WAV_FRAMES", 6), ("TOOL_TTS_FRAMES", 8),
                        ("TOOL_PP_EMB", 3), ("TOOL_PP_FRAMES", 2)):
        monkeypatch.setattr(smoke, name, value)
    cfg = _LMConfig(**{**_SMALL, "card": 2048}, delays=smoke._7B_DELAYS)
    params = synth_lm_params(cfg, "q4_k", device="cpu", seed=0)
    mimi = MimiModel(MimiConfig(**small_mimi))
    mparams = synth_mimi_params(mimi.cfg, device="cpu", seed=1)
    out = smoke.run_tools(cfg, params, mimi, mparams)
    print("\n".join(failures))
    assert failures == []
    assert out["mimi"]["codes_equal"] and out["mimi"]["wav_equal"]
    assert out["mimi"]["frames"] == 6
    sts = out["sts"]
    assert sts["frames"] == 6 and sts["tokens_equal"]
    assert sts["audio_equal"] and sts["wav_equal"]
    assert sts["launches_per_frame"] == smoke.per_frame_launches(cfg)
    assert sts["bench_frames_per_s"] > 0
    stt = out["stt"]
    n = stt["frames"]["frames"]
    assert n == 13 + 6 + 8 and stt["scan"]["frames"] == 2 * n
    assert stt["transcripts_equal"]
    assert stt["frames"]["launches_per_frame"] == {
        "decode_attention4": 2, "ring_write4": 2}
    tts = out["tts"]
    assert tts["audio_equal"]
    assert (tts["device"]["frames"], tts["device"]["lead_in_frames"]) == \
        (5, 3)
    # the scan's warm-up adds one frame of each kind
    assert (tts["scan"]["frames"], tts["scan"]["lead_in_frames"]) == (6, 4)
    tcfg = smoke.tts_config()
    assert tts["device"]["launches_per_frame"] == smoke.tts_launches(tcfg)
    pp = out["personaplex"]
    assert pp["primed_frames"] == 3 + 2 * 6 + 4 and pp["frames"] == 2
    assert pp["launches_per_frame"] == smoke.personaplex_launches(
        smoke.personaplex_config())[0]
    # the kernel table takes the tools' paths
    launches = {"sts_tool": sts["launches_per_frame"],
                "stt_tool": stt["frames"]["launches_per_frame"],
                "tts_tool": tts["device"]["launches_per_frame"],
                "personaplex_tool": pp["launches_per_frame"]}
    assert all(launches.values())



# a small LM whose TP shards route as the 7B's do (every column shard a
# 256-wide int8 product, the depformer's q4_0 linear_out on the dequant
# matvec), at the 7B's 16 codebooks
_SMALL_PAR = dict(dim=512, num_heads=4, num_layers=2, hidden_dim=512,
                  context=32, card=256, text_card=512, depformer_dim=512,
                  depformer_heads=4, depformer_layers=2,
                  depformer_hidden=640, depformer_low_rank=32)


def _cpu_rank(rank, world, init, queue):
    """A rank process of the phase 13 rehearsal: chip_smoke.py on the CPU
    at ``_SMALL_PAR``, its plain versions counting as kernels, through
    ``multihost.initialize`` (gloo, a file store) and ``build_mesh``;
    puts (rank, ``par_rank``'s result, the failures it reported, an
    error) on ``queue``."""
    failures = []
    try:
        torch.set_num_threads(1)
        mod = _load_smoke()
        mod.DEV = "cpu"
        mod.time_ms = host_time_ms
        mod.fail = failures.append
        # at this size K3's control (p in f32) stays within the 2-layer
        # limit, as it does in test_chip_smoke_phases_on_cpu's fused form;
        # the card holds it at the 7B's width
        controls = mod._frame_controls
        mod._frame_controls = lambda form: [
            c for c in controls(form) if not c[0].startswith("K3")]
        # at this size the "32-layer" TP and TP x PP checks run the same
        # 2 layers as the 2-layer one, CPU against CPU, so they take the
        # 2-layer limits (their fault control reads 8.5e-3 in the logits,
        # under tp_32l's 1.2e-2; the card holds it at the 7B's depth)
        mod.TOL["tp_32l"] = mod.TOL["frame_2l"]
        mod.TOL["tp_32l_dep"] = mod.TOL["frame_2l_dep"]
        lm.LMConfig = lambda **kw: _LMConfig(**{**_SMALL_PAR, **kw})
        count_plain_versions(setattr)
        from moshi_tpu_torch.parallel import mesh as pmesh
        from moshi_tpu_torch.parallel import multihost
        multihost.initialize(init, num_processes=world, process_id=rank,
                             backend="gloo")
        res = mod.par_rank(rank, lambda names, sizes, tag: pmesh.build_mesh(
            names, sizes))
        queue.put((rank, res, failures, None))
    except BaseException:          # noqa: BLE001 - reported to the test
        import traceback
        queue.put((rank, None, failures, traceback.format_exc()))


def test_chip_smoke_parallel_phase_on_cpu(smoke, monkeypatch, tmp_path):
    """Phase 13 at a tiny size, its four ranks processes on the CPU (spawned
    as on the card, joined over a file store in ``tmp_path``): K1-K4 at
    rank 0's TP shard shapes against their plain versions; per path and
    rank the launch counts and collectives the script asserts
    (``par_launches``, ``par_collectives``), the tokens equal on every
    rank, the TP 2-layer check's controls apart from it, the 32-layer TP
    and the TP x PP frames' fault control (a partial dropped) beyond their
    limits and both controls further from the single-rank frame than the
    sound frames, PP's microbatches bit for bit their
    B = 1 frames and its frames bit for bit the row-wise single-rank
    frames, EP bit for bit; the kernel table takes the four paths, and
    the shard rows the "tp", "pp" and "tp_pp" frames' calls."""
    import multiprocessing as mp
    failures = []
    monkeypatch.setattr(smoke, "fail", failures.append)
    monkeypatch.setattr(lm, "LMConfig",
                        lambda **kw: _LMConfig(**{**_SMALL_PAR, **kw}))

    def spawned(world):
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        init = f"file://{tmp_path}/store"
        procs = [ctx.Process(target=_cpu_rank, args=(r, world, init, q))
                 for r in range(world)]
        for p in procs:
            p.start()
        res = {}
        try:
            for _ in range(world):
                rank, got, failed, err = q.get(timeout=300)
                assert err is None, f"rank {rank}:\n{err}"
                failures.extend(failed)
                res[rank] = got
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
        return res

    monkeypatch.setattr(smoke, "launch_ranks", spawned)
    cfg = lm.LMConfig(delays=smoke._7B_DELAYS)
    params = synth_lm_params(cfg, "q4_k", device="cpu", seed=0)
    report, rows, launches = smoke.run_parallel(params, cfg)
    print("\n".join(map(str, failures)))
    assert failures == []
    paths = report["paths"]
    assert {p: v["ranks"] for p, v in paths.items()} == {
        "tp": [0, 1], "pp": [0, 1], "tp_pp": [0, 1, 2, 3], "ep": [0, 1]}
    for path, v in paths.items():
        ecfg = (dataclasses.replace(cfg, num_layers=2) if path == "ep"
                else cfg)
        for r, res in v["per_rank"].items():
            timed = res["timed"]
            assert timed["launches_per_frame"] == smoke.par_launches(
                ecfg, params, path), (path, r)
            assert timed["collectives_per_frame"] == \
                smoke.par_collectives(ecfg, path), (path, r)
        assert launches[path] == v["per_rank"][0]["timed"][
            "launches_per_frame"]
    tp0 = paths["tp"]["per_rank"][0]
    assert tp0["two_layer"]["passes"] and tp0["full_depth"]["passes"]
    assert set(tp0["controls"]) == {"K1 bf16 partials"}
    assert not any(c["passes"] for c in tp0["controls"].values())
    for full, ctls in ((tp0["full_depth"], tp0["full_depth_controls"]),
                       (paths["tp_pp"]["per_rank"][0]["against_rowwise"],
                        paths["tp_pp"]["per_rank"][0]["controls"])):
        assert full["passes"] and not ctls["a partial dropped"]["passes"]
        for ctl in ctls.values():
            assert ctl["logits"] > full["logits"]
            assert ctl["dep_logits"] > full["dep_logits"]
    assert paths["pp"]["per_rank"][1]["b1_bit_equal"]
    assert paths["pp"]["per_rank"][1]["rowwise_bit_equal"]
    assert paths["ep"]["per_rank"][0]["bit_equal"]
    # the shard rows count only the parallel frames' calls
    assert rows and all(r.get("calls_per_frame", 0) == 0 for r in rows)
    sums = smoke.path_sums(rows)
    assert set(sums["int8_matvec"]) == {"tp", "tp_pp"}
    assert set(sums["decode_attention"]) == {"tp", "tp_pp", "pp"}
    assert set(sums["ring_write"]) == {"tp", "tp_pp", "pp"}
    for name in ("qmatmul", "dequant_matvec", "glu_matvec"):
        assert {"pp", "tp_pp"} <= set(sums[name]), name
    # per rank and frame, the calls the rows give each kernel are the
    # launches the path counted (phase 3's temporal rows, which give "pp"
    # its K1, K5 and temporal K3 calls, are not run here)
    for path in ("tp", "tp_pp"):
        for name, n in launches[path].items():
            key = smoke._CALLS[path]
            assert sum(r.get(key, 0) for r in rows
                       if r["kernel"] == name) == n, (path, name)
    for name in ("qmatmul", "dequant_matvec", "glu_matvec", "ring_write"):
        assert sum(r.get("calls_per_pp_frame", 0) for r in rows
                   if r["kernel"] == name) == launches["pp"][name], name
