"""PARCOR lattice analysis/synthesis filters, plain PyTorch (counterpart of
sla_tpu/kernels/lattice.py; reference src/SLAPredictor.c:557-740).

Q15 coefficients, round-half constant 1<<14, wrapping int32 arithmetic:

predict (per sample, order p):
    f[0] = x
    f[k] = f[k-1] - ((c[k]*b_prev[k-1] + 16384) >> 15)      k = 1..p
    b[k] = b_prev[k-1] - ((c[k]*f[k-1] + 16384) >> 15)      k = 1..p
    b[0] = x ; residual = f[p]

synthesize (per sample):
    f = r ; for k = p..1: f += ((c[k]*b_prev[k-1] + 16384) >> 15)
            then b[k] = b_prev[k-1] - ((c[k]*f + 16384) >> 15)
    out = f ; b[0] = f

Every stage product uses the previous sample's state, so one sample is a
few vector ops over (B, p) around one prefix sum m -> cumsum(m):
f[k-1] = x - cumsum(m)[k] + m[k] when predicting, and f after stage k =
r + cumsum(m)[p] - cumsum(m)[k] + m[k] when synthesizing. The sample loop
stays sequential. The state ping-pongs between two preallocated buffers,
so a sample allocates little: these loops run on the CPU as the port's
reference and its no-GPU path, where each torch op costs microseconds.
"""

from __future__ import annotations

import torch

from .. import debug


def _qmul_fn(device):
    """v -> (c*v + 16384) >> 15 in wrapping int32, the C expression, with
    its constants as tensors on `device` (cheaper per op than Python ints)."""
    half = torch.tensor(1 << 14, dtype=torch.int32, device=device)
    q = torch.tensor(15, dtype=torch.int32, device=device)
    return lambda c, v: torch.addcmul(half, c, v) >> q


def _check_qmul(checks, c: torch.Tensor, v: torch.Tensor, what: str) -> None:
    """SLA_TPU_DEBUG_ASSERTS: the quantized coefficient must be a true Q15
    value and the rounded stage product must fit int32 (the lattice analog
    of SLAPredictor.c:1265-1271; sla_tpu/kernels/lattice.py _check_qmul)."""
    q = (c.to(torch.int64) * v.to(torch.int64) + (1 << 14)) >> 15
    checks.check(
        torch.all(c.abs() <= (1 << 15)) & debug.fits_int32(q),
        f"lattice {what} stage product overflows int32",
    )


def _state_buffers(backward: torch.Tensor, p: int):
    """Two (B, p+1) state buffers, the first holding `backward`, with the
    views each sample reads (b[0..p-1]) and writes (b[0], b[1..p])."""
    bufs = [backward.clone(), torch.empty_like(backward)]
    return bufs, [(b[:, :p], b[:, :1], b[:, 1:]) for b in bufs]


def lattice_predict(
    data: torch.Tensor, coef: torch.Tensor, backward: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward lattice (analysis).

    data: (B, N) int32; coef: (B, p) int32 = quantized c[1..p];
    backward: (B, p+1) int32 state. Returns (residual (B, N), new state).
    """
    c = coef.to(torch.int32)
    p = c.shape[1]
    N = data.shape[1]
    if p == 0:
        # order 0 is a valid stream parameter: passthrough, state slot 0
        # tracks the last sample (sla_tpu/kernels/lattice.py:71-76)
        return data, (data[:, -1:].clone() if N else backward)
    if N == 0:
        return data, backward
    qmul = _qmul_fn(data.device)
    bufs, views = _state_buffers(backward, p)
    checks = debug.Checks() if debug.asserts_enabled() else None
    sums = []  # cumsum(m)[p] per sample: residual = x - sum
    for n, x in enumerate(data.t().unsqueeze(2).unbind(0)):  # x: (B, 1)
        b_lo = views[n % 2][0]
        _, b0, b_hi = views[(n + 1) % 2]
        if checks is not None:
            _check_qmul(checks, c, b_lo, "predict")
        m = qmul(c, b_lo)
        cs = torch.cumsum(m, dim=1, dtype=torch.int32)
        f_prev = x - cs + m  # f[0..p-1]
        if checks is not None:
            _check_qmul(checks, c, f_prev, "predict-update")
        torch.sub(b_lo, qmul(c, f_prev), out=b_hi)
        b0.copy_(x)
        sums.append(cs[:, -1])
    if checks is not None:
        checks.raise_first()
    return data - torch.stack(sums, dim=1), bufs[N % 2]


def lattice_synthesize(
    residual: torch.Tensor, coef: torch.Tensor, backward: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse lattice (synthesis).

    residual: (B, N) int32; coef: (B, p); backward: (B, p+1) state.
    Returns (output (B, N), new state).
    """
    c = coef.to(torch.int32)
    p = c.shape[1]
    N = residual.shape[1]
    if p == 0:
        return residual, (residual[:, -1:].clone() if N else backward)
    if N == 0:
        return residual, backward
    qmul = _qmul_fn(residual.device)
    bufs, views = _state_buffers(backward, p)
    checks = debug.Checks() if debug.asserts_enabled() else None
    outs = []
    for n, r in enumerate(residual.t().unsqueeze(2).unbind(0)):  # r: (B, 1)
        b_lo = views[n % 2][0]
        _, b0, b_hi = views[(n + 1) % 2]
        if checks is not None:
            _check_qmul(checks, c, b_lo, "synth")
        m = qmul(c, b_lo)
        cs = torch.cumsum(m, dim=1, dtype=torch.int32)
        out = r + cs[:, -1:]  # all p stages applied
        f = out - cs + m  # f after stages p..k, k = 1..p
        if checks is not None:
            _check_qmul(checks, c, f, "synth-update")
        torch.sub(b_lo, qmul(c, f), out=b_hi)
        b0.copy_(out)
        outs.append(out)
    if checks is not None:
        checks.raise_first()
    return torch.cat(outs, dim=1), bufs[N % 2]


def lattice_init_state(batch: int, order: int, device=None) -> torch.Tensor:
    return torch.zeros((batch, order + 1), dtype=torch.int32, device=device)
