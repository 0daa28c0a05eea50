"""K1's, K5's and K12's measurement tool on the CPU: ``int8_ab.py``'s
shape list holds every K1 and K5 call of the STS, TTS and ``sts_mxu``
frames and K12's of the ``sts_mxu`` and ``lm_split`` frames, its stage
stamps find their anchors in this tree's sources and in those of the
build before one launch a call (8467c74), and its build of another tree
raises without a toolchain instead of falling back."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from moshi_tpu_torch.models import lm

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
import int8_ab  # noqa: E402

CSRC = ROOT / "moshi_tpu_torch" / "csrc"
BEFORE = "8467c74"       # the last build with a prep launch before K1's
FILES = ("common.cuh", "int8_dot.cuh", "int8_matvec.cu", "attn_ffn_fused.cu",
         "split_matvec.cu")


def _cfgs():
    return (lm.LMConfig(delays=chip_smoke._7B_DELAYS),
            chip_smoke.tts_config())


def _calls(shapes, path):
    return sum(s[-1].get(path, 0) for s in shapes)


@pytest.mark.parametrize("path", ["sts", "sts_mxu", "tts"])
def test_shape_list_holds_every_k1_and_k5_call(path):
    sts, tts = _cfgs()
    counts = {"sts": chip_smoke.per_frame_launches(sts),
              "sts_mxu": chip_smoke.mxu_launches(sts),
              "tts": chip_smoke.tts_launches(tts)}[path]
    assert _calls(int8_ab.K1_SHAPES, path) == counts["int8_matvec"]
    assert _calls(int8_ab.K5_SHAPES, path) == counts["attn_ffn_fused"]


@pytest.mark.parametrize("form,path,count", [
    ("kseg", "sts_mxu", "int8_kseg"), ("split", "lm_split", "int8_split")])
def test_k12_shape_holds_every_k12_call(form, path, count):
    """K12's row is the 7B temporal linear_out, with the calls its knob
    path makes a frame, one launch each."""
    sts, _ = _cfgs()
    _, o, k = int8_ab.K12_SHAPE
    assert (o, k) == (sts.dim, sts.transformer.hidden_dim)
    assert int8_ab.K12_CALLS[form] == {
        path: chip_smoke.mxu_launches(sts, path)[count]}
    assert int8_ab.K12_FORMS[form] in ("K12k", "K12s")


def test_shape_list_has_the_models_widths():
    """Each listed product is a weight of the 7B or of the TTS class: its
    (rows, K) from the configurations' widths."""
    sts, tts = _cfgs()
    expect, glus = set(), set()
    for cfg in (sts, tts):
        d, dd = cfg.dim, cfg.depformer.dim
        hidden = cfg.transformer.hidden_dim
        nq = cfg.runtime_dep_q if cfg is tts else cfg.dep_q
        expect |= {(3 * d, d), (d, d), (d, hidden), (cfg.text_card, d),
                   (nq * dd, d), (3 * dd, dd), (cfg.card, dd)}
        glus.add((2 * hidden, d))
    for name, o, k, _, glu, _, _, _ in int8_ab.K1_SHAPES:
        assert (o, k) in (glus if glu else expect), name
    assert {(k, h) for _, k, h, _, _ in int8_ab.K5_SHAPES} == {
        (sts.dim, sts.transformer.hidden_dim),
        (sts.depformer.dim, sts.depformer.hidden_dim),
        (tts.depformer.dim, tts.depformer.hidden_dim)}


def test_per_frame_sums_each_row_by_its_calls():
    rows = [{"kernel": "K1", "calls": {"sts": 2, "tts": 1}, "turns": ["a"],
             "ms": [1.0], "ms_clean_flush": [0.5], "ms_stream": [0.25],
             "library_ms": 3.0, "bound_ms": 0.5},
            {"kernel": "K1", "calls": {"sts": 1}, "turns": ["a"],
             "ms": [2.0], "ms_clean_flush": [1.5], "ms_stream": [1.0],
             "library_ms": 1.0, "bound_ms": 0.25}]
    sums = int8_ab.per_frame(rows)
    assert sums[("K1", "sts")]["ms"] == [4.0]
    assert sums[("K1", "sts")]["ms_clean_flush"] == [2.5]
    assert sums[("K1", "sts")]["ms_stream"] == [1.5]
    assert sums[("K1", "sts")]["calls"] == 3
    assert sums[("K1", "sts")]["bound_ms"] == 1.25
    assert sums[("K1", "tts")]["library_ms"] == 3.0


def _check_stamps(files, forms):
    for source, (label, points) in forms.items():
        form = int8_ab.stamp_form(source, files)
        assert form is not None and form[0] == label, source
        out = int8_ab.stamped(source, files)
        n = sum(out[f].count("mt_stamp(") - files[f].count("mt_stamp(")
                for f in files if f != "common.cuh")
        assert n == points, source
        assert "mt_read_stamps" in out[f"{source}.cu"]
        assert "%globaltimer" in out["common.cuh"]
        # each stage reads points the form stamps
        stamped_points = {p for _, a, piece, _ in form[1]
                          for p in range(8) if f"mt_stamp({p}," in piece}
        for _, (pa, _), (pb, _) in form[2]:
            assert {pa, pb} <= stamped_points


def test_stamps_find_their_anchors_in_this_tree():
    files = int8_ab.csrc_files(CSRC)
    _check_stamps(files, {"int8_matvec": ("one launch", 3),
                          "attn_ffn_fused": ("cooperative, marked stages",
                                             6),
                          "split_matvec": ("one launch", 3)})
    assert not int8_ab.k1_takes_scratch(CSRC)
    assert not int8_ab.k12_takes_scratch(CSRC)


def test_stamps_find_their_anchors_in_the_build_before(tmp_path):
    files = {}
    for f in FILES:
        out = subprocess.run(["git", "show", f"{BEFORE}:moshi_tpu_torch/csrc/"
                              f"{f}"], cwd=str(ROOT), capture_output=True,
                             text=True)
        if out.returncode:
            pytest.skip(f"{BEFORE} is not in this checkout's history")
        files[f] = out.stdout
    _check_stamps(files, {"int8_matvec": ("prep launch, then matvec", 4),
                          "attn_ffn_fused": ("cooperative, stages 1-5", 6),
                          "split_matvec": ("prep launch, then split matvec",
                                           4)})
    for f, text in files.items():
        (tmp_path / f).write_text(text)
    assert int8_ab.k1_takes_scratch(tmp_path)
    assert int8_ab.k12_takes_scratch(tmp_path)


def test_other_build_raises_without_a_toolchain():
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present: the build would run")
    with pytest.raises(RuntimeError, match="nvcc"):
        int8_ab.build_libs([("int8_matvec_probe", CSRC, "int8_matvec",
                             False)])
