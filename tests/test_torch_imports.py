"""The port stands alone: no module of ``moshi_tpu_torch`` (nor the chip
smoke script) imports JAX or the JAX package, importing every port module
loads neither, and an entry point asked for the card without one raises
instead of running on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

_ROOT = Path(__file__).resolve().parents[1]
_PKG = _ROOT / "moshi_tpu_torch"
_FORBIDDEN = ("jax", "jaxlib", "moshi_tpu")


def _port_sources():
    """The port's modules and the root scripts that run it on the card
    (the smoke run and the A/B and scan harnesses)."""
    return sorted(_PKG.rglob("*.py")) + [
        _ROOT / name for name in ("chip_smoke.py", "attn_ab.py",
                                  "dequant_ab.py", "temporal_ab.py",
                                  "depformer_ab.py", "int8_ab.py",
                                  "k3_seed_scan.py")]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in _FORBIDDEN


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(_ROOT)))
def test_no_jax_import_in_source(path):
    bad = [n for n in _imported_roots(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(_ROOT)} imports {bad}"


_PROBE = r"""
import importlib, pkgutil, sys
before = {m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'moshi_tpu')}
import moshi_tpu_torch
names = ['moshi_tpu_torch']
for info in pkgutil.walk_packages(moshi_tpu_torch.__path__, 'moshi_tpu_torch.'):
    names.append(info.name)
for name in names:
    importlib.import_module(name)
after = {m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'moshi_tpu')}
print(len(names))
print(sorted(after - before))
"""


def test_importing_every_port_module_loads_no_jax():
    """In a fresh interpreter (the environment may preload JAX at start;
    only modules that appear after the port's imports count)."""
    env = dict(os.environ, PYTHONPATH=str(_ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(_ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    count, new = out.stdout.strip().splitlines()[-2:]
    assert int(count) >= 25, count
    assert new == "[]", f"importing the port loaded {new}"


def test_entry_points_refuse_a_missing_card():
    from moshi_tpu_torch.models.lm import LMConfig, init_gen_state
    from moshi_tpu_torch.runtime.convert import params_from_numpy
    from moshi_tpu_torch.runtime.synth import synth_lm_params
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = LMConfig(dim=64, num_heads=2, num_layers=1, hidden_dim=64,
                   context=8, card=32, n_q=2, dep_q=1, text_card=32,
                   depformer_dim=64, depformer_heads=2, depformer_layers=1,
                   depformer_hidden=64, depformer_low_rank=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_gen_state(cfg, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        synth_lm_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": [0.0]})
    # and the CPU is used only when asked for
    state = init_gen_state(cfg, 1, device="cpu")
    assert state["transformer"]["k"].device.type == "cpu"


def test_serving_modules_are_covered_and_refuse_a_missing_card():
    """The batched-serving modules are among the sources checked above,
    import through the package's lazy API without JAX, and size nothing
    without a card."""
    names = {p.relative_to(_ROOT).as_posix() for p in _port_sources()}
    assert {"moshi_tpu_torch/runtime/serving.py",
            "moshi_tpu_torch/runtime/memory.py"} <= names
    env = dict(os.environ, PYTHONPATH=str(_ROOT))
    probe = ("import sys\n"
             "f = lambda: {k for k in sys.modules if k.split('.')[0] in "
             "('jax', 'jaxlib', 'moshi_tpu')}\n"
             "before = f()\n"
             "import moshi_tpu_torch as m\n"
             "m.SessionPool, m.auto_slots\n"
             "print(sorted(f() - before))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=str(_ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    from moshi_tpu_torch.runtime import memory
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        memory.hbm_bytes()
    with pytest.raises(ValueError, match="CUDA"):
        memory.hbm_bytes("cpu")


def test_mimi_and_pipeline_entry_points_refuse_a_missing_card():
    from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
    from moshi_tpu_torch.nn.seanet import SEANetConfig
    from moshi_tpu_torch.runtime.pipeline import STSPipeline, STTPipeline
    from moshi_tpu_torch.runtime.synth import synth_mimi_params
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    mcfg = MimiConfig(n_q=2, total_codebooks=4, dim=16, codebook_dim=8,
                      codebook_size=16, transformer_layers=1,
                      transformer_heads=2, transformer_context=4,
                      transformer_hidden=16,
                      seanet=SEANetConfig(dimension=16, n_filters=2,
                                          ratios=(2, 2)))
    mimi = MimiModel(mcfg)
    for make in (lambda: mimi.init_encode_state(1),
                 lambda: mimi.init_decode_state(1),
                 lambda: synth_mimi_params(mcfg),
                 lambda: STSPipeline(mimi, _tiny_lm()),
                 lambda: STTPipeline(mimi, _tiny_lm())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    for pipe in (STSPipeline(mimi, _tiny_lm(), device="cpu"),
                 STTPipeline(mimi, _tiny_lm(), device="cpu")):
        state = pipe.init_state(1)
        assert state["enc"]["transformer"]["k"].device.type == "cpu"
    params = synth_mimi_params(mcfg, device="cpu")
    assert params["decoder"]["model.0"]["weight"].dtype == torch.bfloat16


def _tiny_lm():
    from moshi_tpu_torch.models.lm import LMConfig
    return LMConfig(dim=64, num_heads=2, num_layers=1, hidden_dim=64,
                    context=8, card=16, n_q=2, dep_q=1, text_card=32,
                    depformer_dim=64, depformer_heads=2, depformer_layers=1,
                    depformer_hidden=64, depformer_low_rank=8)


def test_tts_modules_are_covered_and_refuse_a_missing_card():
    """The TTS modules (the tokenizer, the host and device state machines,
    the TTS model) are among the sources checked above and import through
    the package's lazy API without JAX; the TTS entry points ask for the
    card by default."""
    names = {p.relative_to(_ROOT).as_posix() for p in _port_sources()}
    assert {"moshi_tpu_torch/tokenizer.py",
            "moshi_tpu_torch/models/state_machine.py",
            "moshi_tpu_torch/models/device_machine.py",
            "moshi_tpu_torch/models/tts.py"} <= names
    env = dict(os.environ, PYTHONPATH=str(_ROOT))
    probe = ("import sys\n"
             "f = lambda: {k for k in sys.modules if k.split('.')[0] in "
             "('jax', 'jaxlib', 'moshi_tpu')}\n"
             "before = f()\n"
             "import moshi_tpu_torch as m\n"
             "m.TTSPipeline, m.TTSSessionPool, m.TTSModel\n"
             "import moshi_tpu_torch.tokenizer, "
             "moshi_tpu_torch.models.device_machine\n"
             "print(sorted(f() - before))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=str(_ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
    from moshi_tpu_torch.nn.seanet import SEANetConfig
    from moshi_tpu_torch.runtime.pipeline import TTSPipeline
    from moshi_tpu_torch.runtime.synth import synth_conditioners
    mimi = MimiModel(MimiConfig(
        n_q=2, total_codebooks=4, dim=16, codebook_dim=8, codebook_size=16,
        transformer_layers=1, transformer_heads=2, transformer_context=4,
        transformer_hidden=16,
        seanet=SEANetConfig(dimension=16, n_filters=2, ratios=(2, 2))))
    with pytest.raises(RuntimeError, match="CUDA"):
        TTSPipeline(mimi, _tiny_lm())
    with pytest.raises(RuntimeError, match="CUDA"):
        synth_conditioners(64)
    from moshi_tpu_torch.models.device_machine import (DeviceMachineConfig,
                                                       compile_script)
    with pytest.raises(RuntimeError, match="CUDA"):
        compile_script([[]], DeviceMachineConfig(card=33))
    state = TTSPipeline(mimi, _tiny_lm(), device="cpu").init_state(1)
    assert state["lm"]["transformer"]["k"].device.type == "cpu"


def test_megakernel_modules_and_sources_are_in_the_port():
    """The megakernel modules are port sources (held to no JAX import
    above, and imported by the probe), and their CUDA sources are built
    with the others."""
    from moshi_tpu_torch.kernels import build
    sources = _port_sources()
    for mod in ("nn/temporal.py", "nn/depformer.py"):
        assert _PKG / mod in sources
    for name in ("temporal_step", "dep_step"):
        assert name in build.SOURCES
        assert (build.CSRC / f"{name}.cu").is_file()


def test_knob_modules_are_covered_and_refuse_a_missing_card(monkeypatch):
    """K10's and K12's wrappers are among the sources checked above, their
    CUDA sources are built with the rest, and under their knobs an entry
    point asked for the card without one still raises."""
    from moshi_tpu_torch.kernels import build
    names = {p.relative_to(_ROOT).as_posix() for p in _port_sources()}
    assert {"moshi_tpu_torch/nn/decode_attention.py",
            "moshi_tpu_torch/quant/matmul_int8.py"} <= names
    assert "split_matvec" in build.SOURCES
    assert (_PKG / "csrc" / "split_matvec.cu").is_file()
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from moshi_tpu_torch.models.lm import LMConfig, init_gen_state
    for name in ("MOSHI_TPU_ATTN_MXU", "MOSHI_TPU_KSEG",
                 "MOSHI_TPU_SPLIT_SPREAD"):
        monkeypatch.setenv(name, "1")
    cfg = LMConfig(dim=64, num_heads=2, num_layers=1, hidden_dim=64,
                   context=8, card=32, n_q=2, dep_q=1, text_card=32,
                   depformer_dim=64, depformer_heads=2, depformer_layers=1,
                   depformer_hidden=64, depformer_low_rank=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_gen_state(cfg, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_gen_state(cfg, 1, device="cuda")


def test_scan_and_session_modules_are_covered_and_refuse_a_missing_card():
    """The streaming sessions (``runtime/session.py``) are among the sources
    checked above and import through the package's lazy API without JAX;
    their entry points, Mimi's ``init_params`` and the pipelines' offline
    scans ask for the card by default."""
    names = {p.relative_to(_ROOT).as_posix() for p in _port_sources()}
    assert {"moshi_tpu_torch/runtime/session.py",
            "moshi_tpu_torch/runtime/pipeline.py"} <= names
    env = dict(os.environ, PYTHONPATH=str(_ROOT))
    probe = ("import sys\n"
             "f = lambda: {k for k in sys.modules if k.split('.')[0] in "
             "('jax', 'jaxlib', 'moshi_tpu')}\n"
             "before = f()\n"
             "import moshi_tpu_torch as m\n"
             "m.LMGenerator, m.MimiStreamer, m.STSPipeline.scan_frames, "
             "m.STTPipeline.scan_frames\n"
             "print(sorted(f() - before))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=str(_ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
    from moshi_tpu_torch.nn.seanet import SEANetConfig
    from moshi_tpu_torch.runtime.session import LMGenerator, MimiStreamer
    mimi = MimiModel(MimiConfig(
        n_q=2, total_codebooks=4, dim=16, codebook_dim=8, codebook_size=16,
        transformer_layers=1, transformer_heads=2, transformer_context=4,
        transformer_hidden=16,
        seanet=SEANetConfig(dimension=16, n_filters=2, ratios=(2, 2))))
    for make in (lambda: LMGenerator(_tiny_lm(), {}),
                 lambda: MimiStreamer(mimi, {}),
                 lambda: mimi.init_params(torch.Generator())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    params = mimi.init_params(torch.Generator().manual_seed(0),
                              device="cpu")
    streamer = MimiStreamer(mimi, params, device="cpu")
    assert streamer.enc_state["transformer"]["k"].device.type == "cpu"
    assert streamer.encode(torch.zeros(1, 8).numpy()).shape == (1, 1, 2)


def test_loader_modules_are_covered_and_refuse_a_missing_card(tmp_path):
    """The modules that read and write weights (safetensors, GGUF, the
    quantized cache, the loader, the native quantizer) are among the
    sources checked above and load no JAX when imported; every entry
    point that puts weights somewhere asks for the card by default."""
    names = {p.relative_to(_ROOT).as_posix() for p in _port_sources()}
    mods = ("io/safetensors.py", "io/gguf.py", "runtime/cache.py",
            "runtime/loader.py", "native_quant.py")
    assert {f"moshi_tpu_torch/{m}" for m in mods} <= names
    env = dict(os.environ, PYTHONPATH=str(_ROOT))
    probe = ("import sys\n"
             "f = lambda: {k for k in sys.modules if k.split('.')[0] in "
             "('jax', 'jaxlib', 'moshi_tpu')}\n"
             "before = f()\n"
             "import moshi_tpu_torch.runtime.loader, moshi_tpu_torch.io.gguf, "
             "moshi_tpu_torch.io.safetensors, moshi_tpu_torch.runtime.cache, "
             "moshi_tpu_torch.native_quant\n"
             "print(sorted(f() - before))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=str(_ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    import numpy as np
    from moshi_tpu_torch.io.gguf import GGUFReader, GGUFWriter, ggml_to_quant
    from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
    from moshi_tpu_torch.models.tts import load_conditioners
    from moshi_tpu_torch.quant.formats import quantize
    from moshi_tpu_torch.quant.policy import quantize_tree
    from moshi_tpu_torch.runtime.cache import load_quantized
    from moshi_tpu_torch.runtime.loader import (load_lm_params,
                                                load_mimi_params)
    w = np.random.default_rng(0).normal(size=(256, 256)).astype(np.float32)
    qt = quantize(w, "q8_0", device="cpu")
    path = str(tmp_path / "t.gguf")
    writer = GGUFWriter()
    writer.add_tensor("w", qt)
    writer.write(path)
    reader = GGUFReader(path)
    missing = str(tmp_path / "missing.safetensors")
    for make in (lambda: load_lm_params(missing, _tiny_lm()),
                 lambda: load_mimi_params(missing, MimiModel(MimiConfig())),
                 lambda: load_quantized(missing),
                 lambda: load_conditioners(missing),
                 lambda: quantize(w, "q4_k"),
                 lambda: quantize_tree({"w": w}, "q8_0"),
                 lambda: reader.get_quant("w"),
                 lambda: ggml_to_quant(8, reader.raw("w"), (256, 256))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert reader.get_quant("w", "cpu").q.device.type == "cpu"
    reader.close()
