"""Streaming 1-D convolutions with explicit carry state.

Counterpart of ``moshi_tpu/nn/conv.py``, with the same layouts at the
public functions: activations [B, T, C], weights [O, I/g, K] (the
transposed conv's too), states {"prev": [B, carry, C_in]} and
{"partial": [B, tail, C_out]}.  Inside, each conv transposes to [B, C, T]
for ``F.conv1d`` / ``F.conv_transpose1d``.  The JAX package writes the
transposed conv as an lhs-dilated forward conv with the kernel flipped;
``F.conv_transpose1d`` is the transposed conv itself and takes the weight
[I, O/g, K] (``oiw_to_torch_convtr``), unflipped.  Compute runs in the
input's dtype (the weight is cast to it); carries keep the state's dtype.

On the card cuDNN runs an f32 conv in TF32 unless told otherwise
(``torch.backends.cudnn.allow_tf32`` is True by default), which keeps
about three decimal digits: ``full_f32_convs`` turns that off around a
block and gives the caller's setting back after it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_f32_convs():
    """cuDNN's TF32 off inside the block (f32 convs in full f32), the
    caller's setting restored after it.  One flag read and two writes: the
    Mimi steps take it once each, around all of their convs."""
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = before


def oiw_to_torch_convtr(w: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """[O, I/g, K] -> [I, O/g, K], the per-group transpose."""
    o, ig, k = w.shape
    og = o // groups
    return (w.reshape(groups, og, ig, k).permute(0, 2, 1, 3)
            .reshape(groups * ig, og, k))


def torch_convtr_weight_to_oiw(w: torch.Tensor,
                               groups: int = 1) -> torch.Tensor:
    """A checkpoint's ConvTranspose1d weight [I, O/g, K] -> the tree's
    [O, I/g, K] (the inverse of ``oiw_to_torch_convtr``)."""
    i, og, k = w.shape
    ig = i // groups
    return (w.reshape(groups, ig, og, k).permute(0, 2, 1, 3)
            .reshape(groups * og, ig, k).contiguous())


def _ncw(x):
    return x.transpose(1, 2)


@dataclass(frozen=True)
class StreamingConv1d:
    in_ch: int
    out_ch: int
    kernel: int
    stride: int = 1
    dilation: int = 1
    groups: int = 1
    bias: bool = True

    @property
    def k_eff(self) -> int:
        return self.dilation * (self.kernel - 1) + 1

    @property
    def carry(self) -> int:
        return max(self.k_eff - self.stride, 0)

    def init_state(self, batch: int, dtype, device):
        return {"prev": torch.zeros((batch, self.carry, self.in_ch),
                                    dtype=dtype, device=device)}

    def __call__(self, params, state, x):
        """x [B, T, C_in], T % stride == 0 -> (y [B, T/stride, C_out],
        new_state)."""
        t_in = x.shape[1]
        if t_in % self.stride or t_in < self.stride:
            raise ValueError(f"conv stream step needs T % {self.stride} == 0,"
                             f" got {t_in}")
        full = torch.cat([state["prev"].to(x.dtype), x], dim=1)
        y = _ncw(F.conv1d(_ncw(full), params["weight"].to(x.dtype),
                          stride=self.stride, dilation=self.dilation,
                          groups=self.groups))
        if params.get("bias") is not None:
            y = y + params["bias"].to(y.dtype)
        new_prev = full[:, full.shape[1] - self.carry:]
        return y, {"prev": new_prev.to(state["prev"].dtype)}


@dataclass(frozen=True)
class StatelessConv1d:
    """kernel <= stride (or 1x1 projections): no cross-call context."""
    in_ch: int
    out_ch: int
    kernel: int = 1
    stride: int = 1
    bias: bool = True

    def init_state(self, batch: int, dtype, device):
        return {}

    def __call__(self, params, state, x):
        y = _ncw(F.conv1d(_ncw(x), params["weight"].to(x.dtype),
                          stride=self.stride))
        if params.get("bias") is not None:
            y = y + params["bias"].to(y.dtype)
        return y, state


@dataclass(frozen=True)
class StreamingConvTranspose1d:
    in_ch: int
    out_ch: int
    kernel: int
    stride: int
    groups: int = 1
    bias: bool = True

    @property
    def tail(self) -> int:
        return self.kernel - self.stride

    def init_state(self, batch: int, dtype, device):
        return {"partial": torch.zeros((batch, self.tail, self.out_ch),
                                       dtype=dtype, device=device)}

    def __call__(self, params, state, x):
        """x [B, T, C_in] -> (y [B, T*stride, C_out], new_state): the
        overlap-add of the previous call's tail onto this call's head."""
        b, t, _ = x.shape
        s = self.stride
        if t * s < self.tail:
            raise ValueError("step too small for the overlap tail")
        w = oiw_to_torch_convtr(params["weight"].to(x.dtype), self.groups)
        y_full = _ncw(F.conv_transpose1d(_ncw(x), w, stride=s,
                                         groups=self.groups))
        emit = t * s                                  # y_full: (T-1)*s + k
        y = y_full[:, :emit]
        if self.tail:
            head = y[:, :self.tail] + state["partial"].to(y.dtype)
            y = torch.cat([head, y[:, self.tail:]], dim=1)
            new_partial = y_full[:, emit:].to(state["partial"].dtype)
        else:
            new_partial = state["partial"]
        if params.get("bias") is not None:
            y = y + params["bias"].to(y.dtype)
        return y, {"partial": new_partial}
