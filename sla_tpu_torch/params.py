"""Filter parameters and states carried from sla_tpu's layout to the port's.

Per-row filter parameters arrive as numpy, the way the encoder's analysis
and the decoder's block headers produce them: PARCOR coef (B, p), pitch
(B,) and long-term Q31 coefficients ltm (B, T). The kernels take coef as
is, and the long-term stage as md = pitch + T//2 where pitch > 0 (else 0)
and q15 = ltm >> 16 (sla_tpu/pipeline.py:220-221, :572-579):
`longterm_params`.

The state converters take sla_tpu's scan-twin states as numpy arrays and
return the port's, so a test can start both sides from the same non-zero
state: LmsState fields, the lattice backward state (B, p+1), and the
long-term (hist, processed).
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.lms import LmsState
from .kernels.longterm import MAX_DELAY


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)


def longterm_params(pitch, ltm, num_taps: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(md (B,), q15 (B, T)) int32 tensors on `device` from numpy pitch (B,)
    and Q31 ltm (B, >=T). Rejects a lag the kernels' history cannot hold
    (the decoder has already refused such pitches, decoder.py:339)."""
    pitch = np.asarray(pitch, dtype=np.int64)
    md = np.where(pitch > 0, pitch + num_taps // 2, 0) if num_taps > 0 else np.zeros_like(pitch)
    if md.size and int(md.max()) > MAX_DELAY:
        raise ValueError(f"long-term delay {int(md.max())} exceeds {MAX_DELAY}")
    q15 = np.asarray(ltm, dtype=np.int32)[:, :num_taps] >> 16
    return _tensor(md, device), _tensor(q15, device)


def lms_state(state, device=None) -> LmsState:
    """sla_tpu LmsState (five numpy-convertible arrays) -> the port's."""
    return LmsState(*(_tensor(np.asarray(s), device) for s in state))


def lattice_state(backward, device=None) -> torch.Tensor:
    """sla_tpu lattice backward state (B, p+1) -> the port's."""
    return _tensor(np.asarray(backward), device)


def longterm_state(state, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """sla_tpu long-term (hist (B, 258), processed (B,)) -> the port's."""
    hist, processed = state
    return _tensor(np.asarray(hist), device), _tensor(np.asarray(processed), device)
