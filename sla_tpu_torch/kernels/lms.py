"""Sign-sign LMS adaptive predictor, plain PyTorch (counterpart of
sla_tpu/kernels/lms.py; reference src/SLAPredictor.c:1202-1463).

Order M, all arithmetic wrapping int32:

    pred[n] = (512 + sum_i fc[i]*xbuf[i] + sum_i ic[i]*pbuf[i]) >> 10
    residual[n] = x[n] - pred[n]
    step = sign(residual) * (bit_length(|residual|) >> 1)
    fc[i] += step * sign(xbuf[i]) ;  ic[i] += step * sign(pbuf[i])
    xbuf <- [x[n], xbuf[:-1]] ; pbuf <- [pred[n], pbuf[:-1]]

The first M samples after a reset pass through with no adaptation while the
buffers fill newest-first. Order 0 is a passthrough.

Torch has no clz: bit_length(|v|) is the exponent torch.frexp gives for the
float64 value, exact for every int32 (and 32 for INT32_MIN, whose int32
abs stays INT32_MIN — the uint32 magnitude 2^31 the reference uses).

The loop keeps both buffers as one history tensor, oldest first, so the
buffers at sample n are a window of it (xbuf[i] = history[n + M-1-i]) and
shifting them is one write; the coefficients are held reversed to match.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LmsState(NamedTuple):
    fir_coef: torch.Tensor  # (B, M) int32
    iir_coef: torch.Tensor  # (B, M) int32
    fir_buf: torch.Tensor  # (B, M) int32, newest at index 0
    iir_buf: torch.Tensor  # (B, M) int32
    processed: torch.Tensor  # (B,) int32


def lms_init_state(batch: int, num_coef: int, device=None) -> LmsState:
    z = torch.zeros((batch, num_coef), dtype=torch.int32, device=device)
    return LmsState(z, z, z, z, torch.zeros((batch,), dtype=torch.int32, device=device))


def _lms_loop(data: torch.Tensor, state: LmsState, num_coef: int, synthesize: bool):
    M = num_coef
    B, N = data.shape
    if M == 0 or N == 0 or B == 0:
        return data, state
    fc, ic, xb, pb, t = state
    dev = data.device

    def const(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    c512, c10, c1 = const(512), const(10), const(1)
    # hist[:, 0]: sample history, hist[:, 1]: prediction history
    hist = torch.empty((B, 2, M + N), dtype=torch.int32, device=dev)
    hist[:, 0, :M] = xb.flip(1)
    hist[:, 1, :M] = pb.flip(1)
    if not synthesize:
        hist[:, 0, M:] = data  # the predictor's sample history is its input
    w = torch.stack([fc.flip(1), ic.flip(1)], dim=1)  # (B, 2, M)
    # samples in which some row is still warming up
    n_warm = min(N, max(0, int((M - t.to(torch.int64)).max())))
    outs = []
    for n, x in enumerate(data.t().unbind(0)):
        win = hist[:, :, n : n + M]
        pred = (torch.sum(w * win, dim=(1, 2), dtype=torch.int32) + c512) >> c10
        if synthesize:
            out = x + pred
            res, sample = x, out  # the step uses the residual (pre-addition)
        else:
            out = x - pred
            res, sample = out, x
        step = torch.sign(res) * (torch.frexp(res.to(torch.float64)).exponent >> c1)
        ins = pred
        if n < n_warm:
            warm = (t + n) < M
            step = torch.where(warm, 0, step)
            ins = torch.where(warm, sample, pred)
            out = torch.where(warm, x, out)
        w += step[:, None, None] * torch.sign(win)
        if synthesize:
            hist[:, 0, M + n] = sample
        hist[:, 1, M + n] = ins
        outs.append(out)
    new_state = LmsState(
        w[:, 0].flip(1), w[:, 1].flip(1),
        hist[:, 0, N:].flip(1), hist[:, 1, N:].flip(1), t + N,
    )
    return torch.stack(outs, dim=1), new_state


def lms_predict(
    data: torch.Tensor, state: LmsState, num_coef: int
) -> tuple[torch.Tensor, LmsState]:
    """data: (B, N) int32 -> (residual, new state)."""
    return _lms_loop(data, state, num_coef, synthesize=False)


def lms_synthesize(
    residual: torch.Tensor, state: LmsState, num_coef: int
) -> tuple[torch.Tensor, LmsState]:
    """residual: (B, N) int32 -> (output, new state)."""
    return _lms_loop(residual, state, num_coef, synthesize=True)
