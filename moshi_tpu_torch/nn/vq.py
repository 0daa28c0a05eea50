"""Residual vector quantization (Mimi's discrete bottleneck).

Counterpart of ``moshi_tpu/nn/vq.py``: nearest-centroid encode as
argmax(2 x.e - |e|^2) in f32 (the first index wins a tie, as
``jnp.argmax``), decode as a row gather, the greedy residual chain, and
the split quantizer (a semantic chain of one codebook, then an acoustic
chain, each with 1x1 projections stored as linear weights [out, in]).
Codebooks of a chain are stacked [n_q, N, D]; codes are int64.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from moshi_tpu_torch.nn.layers import linear


def codebook_decode(embedding, codes):
    """embedding [N, D], codes [...] -> [..., D]."""
    return embedding[codes.long()]


def codebook_encode(embedding, x):
    """Nearest centroid ids [...] (int64) for x [..., D]."""
    e = embedding.float()
    scores = 2.0 * torch.matmul(x.float(), e.T) - torch.sum(e * e, dim=-1)
    return torch.argmax(scores, dim=-1)


def rvq_encode(embeddings, x, n_q=None):
    """embeddings [n_q, N, D], x [B, T, D] -> codes [B, T, n_q].  With
    ``n_q`` only the chain's first n_q codebooks run (the same codes the
    whole chain gives there)."""
    codes = []
    residual = x
    for emb in embeddings[:n_q]:
        idx = codebook_encode(emb, residual)
        residual = residual - codebook_decode(emb, idx).to(residual.dtype)
        codes.append(idx)
    return torch.stack(codes, dim=-1)


def rvq_decode(embeddings, codes):
    """embeddings [n_q, N, D], codes [B, T, n_q] -> [B, T, D] f32."""
    out = torch.zeros(codes.shape[:-1] + (embeddings.shape[-1],),
                      dtype=torch.float32, device=codes.device)
    for i in range(codes.shape[-1]):
        out = out + codebook_decode(embeddings[i], codes[..., i])
    return out


@dataclass(frozen=True)
class SplitRVQConfig:
    n_q: int                 # total codebooks
    n_q_semantic: int = 1
    dim: int = 512           # outer dim (SEANet/transformer side)
    codebook_dim: int = 256
    codebook_size: int = 2048


class SplitRVQ:
    """params = {rvq_first: {embeddings [1, N, Dc], input_proj,
    output_proj}, rvq_rest: {embeddings [n_q-1, N, Dc], ...}}."""

    def __init__(self, cfg: SplitRVQConfig):
        self.cfg = cfg

    def encode(self, params, x, n_q=None):
        """x [B, T, dim] -> codes [B, T, n_q] (semantic first; all
        codebooks unless ``n_q`` is given)."""
        c = self.cfg
        first, rest = params["rvq_first"], params["rvq_rest"]
        n_rest = None if n_q is None else n_q - c.n_q_semantic
        codes_first = rvq_encode(first["embeddings"],
                                 linear(first["input_proj"], x))
        codes_rest = rvq_encode(rest["embeddings"],
                                linear(rest["input_proj"], x), n_rest)
        return torch.cat([codes_first, codes_rest], dim=-1)[..., :n_q]

    def decode(self, params, codes):
        """codes [B, T, n_q] (n_q at most the total) -> [B, T, dim]."""
        c = self.cfg
        first, rest = params["rvq_first"], params["rvq_rest"]
        n_rest = codes.shape[-1] - c.n_q_semantic
        qs = rvq_decode(first["embeddings"], codes[..., :c.n_q_semantic])
        qa = rvq_decode(rest["embeddings"][:n_rest],
                        codes[..., c.n_q_semantic:])
        out = linear(first["output_proj"], qs.float())
        return out + linear(rest["output_proj"], qa.float())
