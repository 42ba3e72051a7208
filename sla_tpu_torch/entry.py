"""The flagship forward step on the card: the twin of
`__graft_entry__.entry()`.

`entry()` returns `(forward, args)`: the whole encode-side filter cascade
for known parameters (pre-emphasis -> PARCOR lattice -> long-term -> LMS,
`pipeline.encode_filters_fused`, one CUDA kernel) over a (blocks x
channels, L) batch, with the same shapes and the same `default_rng(0)`
draws as the JAX entry, so both forwards see the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .pipeline import encode_filters_fused

B, L, PARCOR_ORDER, NUM_TAPS, LMS_ORDER = 16, 4096, 16, 1, 8


def entry(device="cuda"):
    """(forward, (data, coef, pitch, ltm)): data and coef int32 tensors on
    `device`, pitch (B,) and Q31 ltm (B, T) int32 numpy, as
    encode_filters_fused takes them."""
    rng = np.random.default_rng(0)
    data = rng.integers(-(1 << 14), 1 << 14, (B, L), dtype=np.int32)
    coef = rng.integers(-(1 << 14), 1 << 14, (B, PARCOR_ORDER), dtype=np.int32)
    pitch = rng.integers(0, 256, (B,), dtype=np.int32)
    ltm = (rng.integers(-(1 << 14), 1 << 14, (B, NUM_TAPS), dtype=np.int64) << 16).astype(np.int32)

    def forward(data, coef, pitch, ltm):
        return encode_filters_fused(data, coef, pitch, ltm, PARCOR_ORDER, NUM_TAPS, LMS_ORDER)

    dev = torch.device(device)
    return forward, (torch.from_numpy(data).to(dev), torch.from_numpy(coef).to(dev), pitch, ltm)
