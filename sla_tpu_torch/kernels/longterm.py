"""Long-term (pitch) prediction filter, plain PyTorch (counterpart of
sla_tpu/kernels/longterm.py; reference src/SLAPredictor.c:1031-1130).

With pitch period P and T taps (odd), max_delay = P + T//2. The encoder's
Q31 coefficients are Q15 values shifted left 16, so the reference's Q31
accumulation reduces exactly to

    pred[n] = int32((sum_j q15[j] * hist[n - (max_delay - j)] + 2^14) >> 15)

with q15 = coef >> 16, accumulated in int64 and wrapped to int32.

    predict:    out[n] = in[n] - pred[n],  hist = in
    synthesize: out[n] = in[n] + pred[n],  hist = out

The first max_delay samples pass through; pitch 0 is a passthrough. The
`*_q15` forms take the kernels' parameter layout: md (B,) int32, 0 for an
inactive row, and q15 (B, T) int32 (kernels/cuda_filters.py).
"""

from __future__ import annotations

import torch

from ..host.constants import LONGTERM_MAX_PERIOD

MAX_DELAY = LONGTERM_MAX_PERIOD + 2  # pitch <= 256, taps <= 5 -> delay <= 258


def max_delay(pitch: torch.Tensor, num_taps: int) -> torch.Tensor:
    """Per-row max_delay, 0 where the row has no long-term stage."""
    return torch.where(pitch > 0, pitch + num_taps // 2, 0).to(torch.int32)


def longterm_predict(
    data: torch.Tensor,
    pitch: torch.Tensor,
    coef: torch.Tensor,
    num_taps: int,
    processed: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """FIR residual, vectorized over samples.

    data: (B, N) int32; pitch: (B,) int32 (0 = passthrough); coef: (B, T)
    int32 Q31; processed: (B,) int32 samples already seen — only the
    warmup gate: the taps read THIS chunk alone, zero-filled before its
    start, as sla_tpu's longterm_predict does. Returns (residual, count).
    """
    out = longterm_predict_q15(
        data, max_delay(pitch, num_taps), coef[:, :num_taps] >> 16, processed
    )
    return out, processed + data.shape[1]


def longterm_predict_q15(
    data: torch.Tensor, md: torch.Tensor, q15: torch.Tensor,
    processed: torch.Tensor | None = None,
) -> torch.Tensor:
    B, N = data.shape
    if q15.shape[1] == 0 or N == 0:
        return data
    pad = torch.cat(
        [torch.zeros((B, MAX_DELAY), dtype=torch.int64, device=data.device),
         data.to(torch.int64)], dim=1,
    )
    n_idx = torch.arange(N, device=data.device)
    acc = torch.zeros((B, N), dtype=torch.int64, device=data.device)
    for j in range(q15.shape[1]):
        # in[n - (md - j)], zero before position 0; inactive rows (md 0) may
        # read ahead of n — clamped, and discarded by the gate below
        start = (MAX_DELAY - (md.to(torch.int64) - j)).clamp(0, MAX_DELAY)
        acc += q15[:, j : j + 1].to(torch.int64) * torch.gather(
            pad, 1, start[:, None] + n_idx
        )
    pred = ((acc + (1 << 14)) >> 15).to(torch.int32)
    pos = n_idx if processed is None else processed[:, None] + n_idx
    active = (md[:, None] > 0) & (pos >= md[:, None])
    return torch.where(active, data - pred, data)


def longterm_synthesize(
    residual: torch.Tensor,
    pitch: torch.Tensor,
    coef: torch.Tensor,
    num_taps: int,
    state: tuple[torch.Tensor, torch.Tensor],
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Recurrent synthesis. residual: (B, N) int32; state = (hist,
    processed): hist (B, MAX_DELAY) holds the last outputs, newest at
    index -1; processed (B,) int32."""
    return longterm_synthesize_q15(
        residual, max_delay(pitch, num_taps), coef[:, :num_taps] >> 16, state
    )


def longterm_synthesize_q15(
    residual: torch.Tensor, md: torch.Tensor, q15: torch.Tensor,
    state: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    B, N = residual.shape
    dev = residual.device
    if state is None:
        state = longterm_init_state(B, dev)
    hist, processed = state
    D = hist.shape[1]
    if N == 0 or B == 0:
        return residual, state
    if q15.shape[1] == 0:  # no taps: a passthrough that still fills the history
        tail = torch.cat([hist, residual], dim=1)[:, -D:]
        return residual, (tail, processed + N)
    # history then this call's outputs, one buffer: sample n sits at D + n,
    # and the D samples before it are the window buf[:, n : n + D]
    buf = torch.cat(
        [hist.to(torch.int64), torch.zeros((B, N), dtype=torch.int64, device=dev)],
        dim=1,
    )
    active = md > 0
    back = md.to(torch.int64)[:, None] - torch.arange(q15.shape[1], device=dev)
    # a tap at or ahead of n contributes 0 (sla_tpu drops it), and so does
    # every tap of an inactive row; both then read any valid slot
    live = active[:, None] & (back >= 1)
    q = torch.where(live, q15.to(torch.int64), 0)
    pos = D - torch.where(live, back, 1)  # window position of each tap
    # row r's stage starts at n = md - processed; from the last start on,
    # every row is gated by its q alone
    start = torch.where(active, md - processed, 0)
    n_gate = min(N, int(start.max()))
    half = torch.tensor(1 << 14, dtype=torch.int64, device=dev)
    shift = torch.tensor(15, dtype=torch.int64, device=dev)
    cols = []
    for n, r in enumerate(residual.t().unbind(0)):
        window = buf[:, n : n + D]
        pred = ((torch.sum(q * torch.gather(window, 1, pos), dim=1) + half) >> shift).to(torch.int32)
        if n < n_gate:
            pred = torch.where(n >= start, pred, 0)
        out = r + pred
        buf[:, D + n] = out
        cols.append(out)
    new_hist = buf[:, N:].to(torch.int32)
    return torch.stack(cols, dim=1), (new_hist, processed + N)


def longterm_init_state(batch: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.zeros((batch, MAX_DELAY), dtype=torch.int32, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device),
    )
