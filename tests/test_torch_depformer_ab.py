"""K14's measurement tools on the CPU: ``depformer_ab.py``'s text transforms
of ``csrc/dep_step.cu`` (the stage stamps and the tuning constants) still
find what they change in the source, the stage names follow the kernels'
grid syncs, and K14's grid query raises without a toolchain instead of
falling back."""

import re
import shutil
import sys
from pathlib import Path

import pytest

from moshi_tpu_torch.nn import depformer

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import depformer_ab  # noqa: E402

SOURCE = (ROOT / "moshi_tpu_torch" / "csrc" / "dep_step.cu").read_text()
TUNING = ("R_QKV", "R_OUT", "R_GLU", "R_LOUT", "R_LOGITS",
          "BLOCKS_SM", "KV_SLOTS", "ROW_U")


def test_stamps_follow_each_kernel_start_and_every_grid_sync():
    """Both kernels (K14a's and K14c's) open a grid and get a start stamp;
    every grid sync in the source gets a stamp after it, and no sync sits
    alone under an if (its stamp would run either way)."""
    starts = SOURCE.count(depformer_ab._START)
    syncs = SOURCE.count("grid.sync();")
    assert starts == 2 and syncs >= 1
    text = depformer_ab.stamped(SOURCE)
    assert text.count("mt_stamp(true);") == starts
    assert text.count("mt_stamp(false);") == syncs
    assert "mt_read_stamps" in text and "%globaltimer" in text
    assert not re.search(r"\bif \([^\n]*\) grid\.sync\(\);", SOURCE)


def test_stage_names_count_the_grid_syncs():
    """At the 7B depformer (8 steps, 6 layers): 215 syncs a K14c frame, 24
    a K14a step, each interval named by its stage."""
    names = depformer_ab.frame_stage_names(8, 6)
    assert len(names) == 215
    assert set(names) == set(depformer_ab.FRAME_STAGES)
    assert names.count("embedding") == 7 and names.count("sampler") == 8
    assert depformer_ab.step_stage_names(6) == list(
        depformer_ab.LAYER_STAGES) * 6


@pytest.mark.parametrize("name", TUNING)
def test_each_tuning_constant_can_be_set(name):
    text = depformer_ab.with_constants(SOURCE, {name: 3})
    assert f"constexpr int {name} = 3;" in text
    assert text.count("constexpr int") == SOURCE.count("constexpr int")


def test_tuning_list_is_complete():
    """Every constexpr int between the tuning comment and the Args struct
    is in TUNING, so each can be set."""
    block = SOURCE[SOURCE.index("// Tuning"):SOURCE.index("struct Args")]
    assert set(re.findall(r"constexpr int (\w+) =", block)) == set(TUNING)


def test_k14_grid_query_raises_without_a_toolchain():
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present: the build would run")
    with pytest.raises(RuntimeError, match="nvcc"):
        depformer.grid_blocks(1024, 4224)
