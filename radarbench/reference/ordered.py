"""Reductions whose order of adds depends only on the length of the axis.

A reduction kernel may split a row across threads by the shape of the
whole tensor and by the device, so the same row can sum to another last
bit on the card than on the CPU, or alone than in a batch.  Where a search
picks a minimum among values that can tie, or a stable top-k ranks them,
such a bit picks another answer.  The sums here are chains of elementwise
adds, which round alike on every device and for every batch.
"""

from __future__ import annotations

import torch


def halving_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by halving it with elementwise adds (zeros pad
    it to a power of two).  The order of the adds depends only on the
    length, so a batch of rows (``torch.func.vmap``) sums each row exactly
    as that row alone, and the card as the CPU."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]
