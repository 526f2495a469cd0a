"""The two precisions the reference computes its float32 products in.

``FP32`` is true float32 (TF32 off), the precision the configurations
state.  ``TF32`` is the control's: each factor rounded to TF32's 11
significant bits (10 stored), the products summed in float32, which is
what an H100's TF32 tensor cores compute, in the matrix products and in
the score map's convolutions (as cuDNN would run them).  The rounding is done here, by
elementwise arithmetic that ``torch.func.vmap`` batches, on any device, so
the control reads the same on the card and on the CPU, whatever cuBLAS
would pick.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


#: Veltkamp's splitter for float32 (24 significant bits) to 11: 2**13 + 1
_SPLIT = 8193.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its nearest value with 11 significant bits (TF32's), as
    float32, by Veltkamp's split (finite inputs below 2**115)."""
    t = x * _SPLIT
    return t - (t - x)


class Precision(NamedTuple):
    mm: Callable       # torch.matmul's contract
    bmm: Callable      # torch.bmm's contract
    mul: Callable      # a convolution's tap times its input, torch.mul's contract


def _tf32(fn: Callable) -> Callable:
    return lambda a, b: fn(round_tf32(a), round_tf32(b))


FP32 = Precision(torch.matmul, torch.bmm, torch.mul)
TF32 = Precision(_tf32(torch.matmul), _tf32(torch.bmm), _tf32(torch.mul))


def true_fp32() -> None:
    """Turn TF32 off for PyTorch's float32 products on the card, so that
    ``FP32`` is float32 there too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
