"""K13's measurement tools on the CPU: ``temporal_ab.py``'s text transforms
of ``csrc/temporal_step.cu`` (the stage stamps and the tuning constants)
still find what they change in the source, and K13's grid query raises
without a toolchain instead of falling back."""

import shutil
import sys
from pathlib import Path

import pytest

from moshi_tpu_torch.nn import temporal

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import temporal_ab  # noqa: E402

SOURCE = (ROOT / "moshi_tpu_torch" / "csrc" / "temporal_step.cu").read_text()
TUNING = ("R_QKV", "R_OUT", "R_GLU", "R_LOUT", "MIN_BLOCKS", "ROW_U",
          "FOLD_U", "KEY_U")


def test_stamps_follow_the_start_and_every_grid_sync():
    """Six grid syncs a layer (the stage split's six stages), each
    followed by a stamp, and one at the kernel's start."""
    assert SOURCE.count("grid.sync();") == len(temporal_ab.STAGES) == 6
    text = temporal_ab.stamped(SOURCE)
    assert text.count("mt_stamp(mt_si++);") == 7
    assert "mt_read_stamps" in text and "%globaltimer" in text


@pytest.mark.parametrize("name", TUNING)
def test_each_tuning_constant_can_be_set(name):
    text = temporal_ab.with_constants(SOURCE, {name: 3})
    assert f"constexpr int {name} = 3;" in text
    assert text.count("constexpr int") == SOURCE.count("constexpr int")


def test_k13_grid_query_raises_without_a_toolchain():
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present: the build would run")
    with pytest.raises(RuntimeError, match="nvcc"):
        temporal.grid_blocks(4096, 11264, 3000)
