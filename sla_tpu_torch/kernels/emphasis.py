"""Pre/de-emphasis filters, plain PyTorch (counterpart of
sla_tpu/kernels/emphasis.py; reference src/SLAPredictor.c:1741-1813).

y_pre[n] = x[n] - ((x[n-1] * 31) >> 5)   non-recursive: vectorized
y_de[n]  = x[n] + ((y[n-1] * 31) >> 5)   recursive: a loop over samples

All arithmetic is int32 and wraps, as torch's int32 ops do. State is the
previous sample, one int32 per row, carried explicitly.
"""

from __future__ import annotations

import torch

from ..host.constants import PRE_EMPHASIS_SHIFT

_COEF = (1 << PRE_EMPHASIS_SHIFT) - 1  # 31


def pre_emphasis(data: torch.Tensor, prev: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """data: (B, N) int32; prev: (B,) int32 state. Returns (out, new_prev)."""
    shifted = torch.cat([prev[:, None], data[:, :-1]], dim=1)
    out = data - ((shifted * _COEF) >> PRE_EMPHASIS_SHIFT)
    new_prev = data[:, -1] if data.shape[1] else prev
    return out, new_prev


def de_emphasis(data: torch.Tensor, prev: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse filter; data: (B, N) int32, prev: (B,) int32 state."""
    coef = torch.tensor(_COEF, dtype=torch.int32, device=data.device)
    shift = torch.tensor(PRE_EMPHASIS_SHIFT, dtype=torch.int32, device=data.device)
    y = prev
    cols = []
    for x in data.t().unbind(0):
        y = x + ((y * coef) >> shift)
        cols.append(y)
    if not cols:
        return data.clone(), prev
    return torch.stack(cols, dim=1), y
