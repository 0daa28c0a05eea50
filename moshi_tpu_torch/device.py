"""Device selection for the port's entry points.

Entry points default to the card.  There is no silent CPU path: asking for
``"cuda"`` without one raises, and the CPU (where every kernel wrapper runs
its plain PyTorch version) is used only when the caller names it.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "moshi_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev
