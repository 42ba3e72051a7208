"""Wrappers of the seven CUDA filter kernels (csrc/filters.cu), each beside
its plain PyTorch version.

    lattice_predict  K1  pre-emphasis (optional) -> PARCOR lattice predict
    stage2_predict   K2  long-term FIR predict -> LMS predict
    synth_cascade    K3  LMS synth -> long-term synth -> lattice synth
                         -> de-emphasis
    fused_encode     K4  K1 then K2 in one pass, the FIR reading the
                         stage-1 residual
    lattice_synth    K5  PARCOR lattice synth -> de-emphasis (optional)
    lms_synth        K6  LMS synth
    longterm_synth   K7  long-term synth over its own output

They replace sla_tpu/kernels/pallas_filters.py's lattice_filter_tl /
lattice_filter_wide_tl (K1 predict, K5 synthesize), fused_stage2_tl /
fused_stage2_wide_tl, fused_synth_tl / fused_synth_wide_tl, fused_encode_tl
/ fused_encode_wide_tl, lms_filter_tl (K2 covers its predict direction, K6
its synthesize direction) and longterm_synth_tl.

Every wrapper takes (B, L) int32 rows, each filtered from zero state (the
format resets the filters at block start), and returns (B, L) int32. The
long-term parameters are in the kernels' layout: md (B,) int32 = pitch +
T//2, 0 for a row without the stage, and q15 (B, T) int32 = Q31 coefficient
>> 16 (sla_tpu_torch/params.py makes them).

For a tensor on the CPU a wrapper runs the plain version. For a CUDA tensor
it launches the kernel on the current stream or raises; it never falls
back. `launches` counts the kernel launches of each wrapper, and only
those.
"""

from __future__ import annotations

import torch

from .build import cuda_library
from .emphasis import de_emphasis, pre_emphasis
from .lattice import lattice_init_state, lattice_predict as _lattice_predict
from .lattice import lattice_synthesize
from .lms import lms_init_state, lms_predict, lms_synthesize
from .longterm import longterm_predict_q15, longterm_synthesize_q15

MAX_PARCOR, MAX_LMS, MAX_TAPS = 48, 40, 5  # filters.cuh caps

launches = {
    "lattice_predict": 0, "stage2_predict": 0, "synth_cascade": 0,
    "fused_encode": 0, "lattice_synth": 0, "lms_synth": 0, "longterm_synth": 0,
}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


# -- plain versions ------------------------------------------------------------


def _zero_rows(data: torch.Tensor) -> torch.Tensor:
    return torch.zeros((data.shape[0],), dtype=torch.int32, device=data.device)


def lattice_predict_plain(
    data: torch.Tensor, coef: torch.Tensor, emphasis: bool = True
) -> torch.Tensor:
    if emphasis:
        data, _ = pre_emphasis(data, _zero_rows(data))
    out, _ = _lattice_predict(
        data, coef, lattice_init_state(data.shape[0], coef.shape[1], data.device)
    )
    return out


def stage2_predict_plain(
    data: torch.Tensor, md: torch.Tensor, q15: torch.Tensor, lms_order: int
) -> torch.Tensor:
    out = longterm_predict_q15(data, md, q15)
    out, _ = lms_predict(out, lms_init_state(data.shape[0], lms_order, data.device), lms_order)
    return out


def synth_cascade_plain(
    data: torch.Tensor, coef: torch.Tensor, md: torch.Tensor, q15: torch.Tensor,
    lms_order: int,
) -> torch.Tensor:
    B, dev = data.shape[0], data.device
    out, _ = lms_synthesize(data, lms_init_state(B, lms_order, dev), lms_order)
    out, _ = longterm_synthesize_q15(out, md, q15)
    out, _ = lattice_synthesize(out, coef, lattice_init_state(B, coef.shape[1], dev))
    out, _ = de_emphasis(out, torch.zeros((B,), dtype=torch.int32, device=dev))
    return out


def fused_encode_plain(
    data: torch.Tensor, coef: torch.Tensor, md: torch.Tensor, q15: torch.Tensor,
    lms_order: int,
) -> torch.Tensor:
    return stage2_predict_plain(lattice_predict_plain(data, coef), md, q15, lms_order)


def lattice_synth_plain(
    data: torch.Tensor, coef: torch.Tensor, emphasis: bool = True
) -> torch.Tensor:
    out, _ = lattice_synthesize(
        data, coef, lattice_init_state(data.shape[0], coef.shape[1], data.device)
    )
    if emphasis:
        out, _ = de_emphasis(out, _zero_rows(data))
    return out


def lms_synth_plain(data: torch.Tensor, lms_order: int) -> torch.Tensor:
    out, _ = lms_synthesize(data, lms_init_state(data.shape[0], lms_order, data.device), lms_order)
    return out


def longterm_synth_plain(data: torch.Tensor, md: torch.Tensor, q15: torch.Tensor) -> torch.Tensor:
    out, _ = longterm_synthesize_q15(data, md, q15)
    return out


# -- kernel wrappers -----------------------------------------------------------


def _check(data: torch.Tensor, coef=None, md=None, q15=None, lms_order: int = 0) -> None:
    if data.dtype != torch.int32 or data.dim() != 2:
        raise ValueError(f"rows must be (B, L) int32, got {tuple(data.shape)} {data.dtype}")
    B = data.shape[0]
    for name, t, dims in (("coef", coef, 2), ("md", md, 1), ("q15", q15, 2)):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.dim() != dims or t.shape[0] != B:
            raise ValueError(f"{name} must be int32 with {B} rows, got {tuple(t.shape)} {t.dtype}")
        if t.device != data.device:
            raise ValueError(f"{name} is on {t.device}, the rows on {data.device}")
    if data.device.type == "cuda":
        if coef is not None and coef.shape[1] > MAX_PARCOR:
            raise ValueError(f"PARCOR order {coef.shape[1]} > {MAX_PARCOR}")
        if q15 is not None and q15.shape[1] > MAX_TAPS:
            raise ValueError(f"long-term taps {q15.shape[1]} > {MAX_TAPS}")
        if lms_order > MAX_LMS:
            raise ValueError(f"LMS order {lms_order} > {MAX_LMS}")
    elif data.device.type != "cpu":
        raise ValueError(f"no kernel for device {data.device}")


def _launch(name: str, fn, data: torch.Tensor, *args) -> torch.Tensor:
    """Transposes rows to the kernels' (L, B) layout, launches `fn` on the
    current stream and transposes the result back."""
    with torch.cuda.device(data.device):
        x_t = data.t().contiguous()
        y_t = torch.empty_like(x_t)
        stream = torch.cuda.current_stream(data.device).cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        err = getattr(cuda_library(), fn)(x_t.data_ptr(), y_t.data_ptr(), *ptrs, stream)
        if err != 0:
            raise RuntimeError(f"{fn} launch failed: cudaError {err}")
        launches[name] += 1
        return y_t.t().contiguous()


def lattice_predict(
    data: torch.Tensor, coef: torch.Tensor, emphasis: bool = True
) -> torch.Tensor:
    """K1. data: (B, L) int32 samples; coef: (B, p) int32 Q15 c[1..p];
    emphasis: pre-emphasize first (the codec always does)."""
    _check(data, coef=coef)
    if data.numel() == 0:
        return data.clone()
    if data.device.type == "cpu":
        return lattice_predict_plain(data, coef, emphasis)
    B, L = data.shape
    return _launch("lattice_predict", "sla_lattice_predict", data,
                   coef.contiguous(), B, L, coef.shape[1], int(emphasis))


def stage2_predict(
    data: torch.Tensor, md: torch.Tensor, q15: torch.Tensor, lms_order: int
) -> torch.Tensor:
    """K2. data: (B, L) int32 stage-1 residual; md (B,), q15 (B, T)."""
    _check(data, md=md, q15=q15, lms_order=lms_order)
    if data.numel() == 0:
        return data.clone()
    if data.device.type == "cpu":
        return stage2_predict_plain(data, md, q15, lms_order)
    B, L = data.shape
    return _launch("stage2_predict", "sla_stage2_predict", data,
                   md.contiguous(), q15.contiguous(), B, L, q15.shape[1], lms_order)


def synth_cascade(
    data: torch.Tensor, coef: torch.Tensor, md: torch.Tensor, q15: torch.Tensor,
    lms_order: int,
) -> torch.Tensor:
    """K3. data: (B, L) int32 residual; coef (B, p); md (B,), q15 (B, T).
    Returns the PCM rows before the MS inverse and the left shift."""
    _check(data, coef=coef, md=md, q15=q15, lms_order=lms_order)
    if data.numel() == 0:
        return data.clone()
    if data.device.type == "cpu":
        return synth_cascade_plain(data, coef, md, q15, lms_order)
    B, L = data.shape
    # the long-term stage's output history, (L, B) like the data
    hist = torch.empty((L, B), dtype=torch.int32, device=data.device)
    return _launch("synth_cascade", "sla_synth_cascade", data,
                   hist, coef.contiguous(), md.contiguous(), q15.contiguous(),
                   B, L, coef.shape[1], q15.shape[1], lms_order)


def fused_encode(
    data: torch.Tensor, coef: torch.Tensor, md: torch.Tensor, q15: torch.Tensor,
    lms_order: int,
) -> torch.Tensor:
    """K4. data: (B, L) int32 samples; coef (B, p); md (B,), q15 (B, T).
    Returns the final residual, equal to K1 then K2."""
    _check(data, coef=coef, md=md, q15=q15, lms_order=lms_order)
    if data.numel() == 0:
        return data.clone()
    if data.device.type == "cpu":
        return fused_encode_plain(data, coef, md, q15, lms_order)
    B, L = data.shape
    # the stage-1 residual's history, (L, B) like the data
    hist = torch.empty((L, B), dtype=torch.int32, device=data.device)
    return _launch("fused_encode", "sla_fused_encode", data,
                   hist, coef.contiguous(), md.contiguous(), q15.contiguous(),
                   B, L, coef.shape[1], q15.shape[1], lms_order)


def lattice_synth(
    data: torch.Tensor, coef: torch.Tensor, emphasis: bool = True
) -> torch.Tensor:
    """K5. data: (B, L) int32 lattice residual; coef (B, p); emphasis:
    de-emphasize the lattice output."""
    _check(data, coef=coef)
    if data.numel() == 0:
        return data.clone()
    if data.device.type == "cpu":
        return lattice_synth_plain(data, coef, emphasis)
    B, L = data.shape
    return _launch("lattice_synth", "sla_lattice_synth", data,
                   coef.contiguous(), B, L, coef.shape[1], int(emphasis))


def lms_synth(data: torch.Tensor, lms_order: int) -> torch.Tensor:
    """K6. data: (B, L) int32 LMS residual. Order 0 passes through."""
    _check(data, lms_order=lms_order)
    if data.numel() == 0:
        return data.clone()
    if data.device.type == "cpu":
        return lms_synth_plain(data, lms_order)
    B, L = data.shape
    return _launch("lms_synth", "sla_lms_synth", data, B, L, lms_order)


def longterm_synth(data: torch.Tensor, md: torch.Tensor, q15: torch.Tensor) -> torch.Tensor:
    """K7. data: (B, L) int32 long-term residual; md (B,), q15 (B, T). Rows
    with md 0 pass through; a tap at or ahead of n contributes 0."""
    _check(data, md=md, q15=q15)
    if data.numel() == 0:
        return data.clone()
    if data.device.type == "cpu":
        return longterm_synth_plain(data, md, q15)
    B, L = data.shape
    # the stage's output history, (L, B) like the data
    hist = torch.empty((L, B), dtype=torch.int32, device=data.device)
    return _launch("longterm_synth", "sla_longterm_synth", data,
                   hist, md.contiguous(), q15.contiguous(), B, L, q15.shape[1])
