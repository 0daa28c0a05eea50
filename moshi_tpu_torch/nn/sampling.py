"""Token sampling: temperature + top-k + Gumbel-max draw.

Counterpart of ``moshi_tpu/nn/sampling.py``.  JAX draws its Gumbel noise
from a threefry key; the port takes an explicit ``torch.Generator``, or
the noise itself (``noise``), which lets a test feed both packages the
same draw.
"""

from __future__ import annotations

import torch


def gumbel(shape, generator=None, device=None) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_token(logits: torch.Tensor, temp: float, top_k: int,
                 generator=None, noise=None) -> torch.Tensor:
    """logits [..., V] -> token ids [...] (int64).  temp == 0 is greedy
    argmax; otherwise the top-k of logits/temp plus Gumbel noise over the
    k values, argmax.  ``noise`` [..., k] replaces the generator's draw."""
    if temp == 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = logits.float() / temp
    v = logits.shape[-1]
    k = min(int(top_k), v) if top_k > 0 else v
    vals, idx = torch.topk(scaled, k, dim=-1)
    if noise is None:
        noise = gumbel(vals.shape, generator, vals.device)
    choice = torch.argmax(vals + noise.to(vals.device), dim=-1)
    return torch.gather(idx, -1, choice[..., None])[..., 0]
