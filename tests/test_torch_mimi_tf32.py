"""Mimi's convolutions run in full f32 whatever the caller set: inside
``MimiModel.encode_step`` and ``decode_step`` every ``F.conv1d`` and
``F.conv_transpose1d`` sees ``torch.backends.cudnn.allow_tf32`` False
(cuDNN's default, True, would run an f32 conv in TF32 on the card), and
the caller's setting is back after each step.  On the CPU the flag moves
no number, so each conv records the flag it ran under."""

import pytest
import torch
import torch.nn.functional as F

from moshi_tpu_torch.models.mimi import MimiConfig, MimiModel
from moshi_tpu_torch.nn import conv
from moshi_tpu_torch.nn.seanet import SEANetConfig
from moshi_tpu_torch.runtime.synth import synth_mimi_params

_SMALL_MIMI = dict(n_q=4, total_codebooks=4, dim=32, codebook_dim=16,
                   codebook_size=64, transformer_layers=2,
                   transformer_heads=4, transformer_context=16,
                   transformer_hidden=64,
                   seanet=SEANetConfig(dimension=32, n_filters=4,
                                       ratios=(4, 3, 2, 2)))


@pytest.fixture
def recorded(monkeypatch):
    """F.conv1d and F.conv_transpose1d wrapped: each call appends (name,
    allow_tf32 at the call) to the list returned."""
    calls = []
    for name in ("conv1d", "conv_transpose1d"):
        inner = getattr(F, name)

        def wrapped(*a, _inner=inner, _name=name, **kw):
            calls.append((_name, torch.backends.cudnn.allow_tf32))
            return _inner(*a, **kw)

        monkeypatch.setattr(F, name, wrapped)
    before = torch.backends.cudnn.allow_tf32
    yield calls
    torch.backends.cudnn.allow_tf32 = before


@pytest.mark.parametrize("caller", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mimi_steps_run_their_convs_without_tf32(recorded, caller, dtype):
    mimi = MimiModel(MimiConfig(**_SMALL_MIMI))
    params = synth_mimi_params(mimi.cfg, device="cpu", seed=0, dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    audio = (torch.randn((1, mimi.cfg.frame_samples), generator=gen)
             * 0.1).to(dtype)
    es = mimi.init_encode_state(1, dtype, "cpu")
    ds = mimi.init_decode_state(1, dtype, "cpu")
    torch.backends.cudnn.allow_tf32 = caller
    codes, es = mimi.encode_step(params, es, audio)
    assert torch.backends.cudnn.allow_tf32 is caller
    encode = list(recorded)
    wav, ds = mimi.decode_step(params, ds, codes)
    assert torch.backends.cudnn.allow_tf32 is caller
    decode = recorded[len(encode):]
    assert torch.isfinite(wav.float()).all()
    # the encoder's convs and the downsample; the upsample (transposed),
    # the decoder's convs and its transposed convs
    assert {name for name, _ in encode} == {"conv1d"}
    assert {name for name, _ in decode} == {"conv1d", "conv_transpose1d"}
    assert not any(flag for _, flag in recorded)


def test_full_f32_convs_restores_the_setting_on_error():
    torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(ValueError):
            with conv.full_f32_convs():
                assert torch.backends.cudnn.allow_tf32 is False
                raise ValueError("inside")
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = True
