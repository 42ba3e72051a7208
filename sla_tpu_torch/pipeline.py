"""Batched filter stages over a (blocks*channels, L) grid, on torch tensors
(counterpart of sla_tpu/pipeline.py).

The encode side stops between its two stages, because the long-term
(pitch) analysis is a host float64 step that needs the PARCOR residual
(SLAEncoder.c:620):

    stage1: pre-emphasis -> lattice predict          (K1)
    pitch analysis                                    (host, analysis/)
    stage2: long-term predict -> LMS predict          (K2)

Decode is one stage: LMS synth -> long-term synth -> lattice synth ->
de-emphasis (K3). A flow that already knows every filter parameter (the
device tools, `entry.entry()`) runs the whole encode cascade as one kernel,
`encode_filters_fused` (K4). Each stage runs where its input tensor lies:
the CUDA kernel on a CUDA device, the plain PyTorch version on the CPU
(kernels/cuda_filters.py). Rows need no padding: the kernels take any
(B, L), every order the encoder admits, and every long-term lag.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .host import native
from .kernels import cuda_filters
from .kernels.emphasis import pre_emphasis
from .kernels.lattice import lattice_init_state, lattice_predict
from .kernels.lms import lms_init_state, lms_predict
from .kernels.longterm import longterm_predict_q15
from .params import longterm_params

# row-samples below which 'auto' keeps the native host cascade
# (sla_tpu/pipeline.py:683-687; not yet measured against the card)
DEFAULT_DEVICE_THRESHOLD = 16_000_000


def encode_stage1(data: torch.Tensor, parcor_coef: torch.Tensor, parcor_order: int) -> torch.Tensor:
    """data: (B, L) int32, parcor_coef: (B, p) int32 (orders 1..p).
    Returns the PARCOR residual (B, L)."""
    return cuda_filters.lattice_predict(data, parcor_coef[:, :parcor_order])


def encode_stage2(
    residual: torch.Tensor, pitch, ltm_coef, num_taps: int, lms_order: int,
) -> torch.Tensor:
    """residual: (B, L) PARCOR residual; pitch: (B,) int32 numpy (0
    disables the long-term stage for that row); ltm_coef: (B, >=T) int32
    Q31 numpy. Returns the final residual handed to the entropy coder."""
    md, q15 = longterm_params(pitch, ltm_coef, num_taps, residual.device)
    return cuda_filters.stage2_predict(residual, md, q15, lms_order)


def decode_stage(
    residual: torch.Tensor, parcor_coef: torch.Tensor, pitch, ltm_coef,
    parcor_order: int, num_taps: int, lms_order: int,
) -> torch.Tensor:
    """Full synthesis chain for a batch of compressed blocks. residual:
    (B, L) int32 entropy-decoded residual; pitch and ltm_coef numpy as in
    encode_stage2. Returns PCM rows before the MS inverse and the final
    left shift."""
    md, q15 = longterm_params(pitch, ltm_coef, num_taps, residual.device)
    return cuda_filters.synth_cascade(
        residual, parcor_coef[:, :parcor_order], md, q15, lms_order
    )


def encode_filters_fused(
    data: torch.Tensor, parcor_coef: torch.Tensor, pitch, ltm_coef,
    parcor_order: int, num_taps: int, lms_order: int,
) -> torch.Tensor:
    """The whole encode cascade for known parameters in one pass (K4):
    pre-emphasis -> lattice predict -> long-term predict -> LMS predict.
    data: (B, L) int32; parcor_coef: (B, >=p) int32; pitch and ltm_coef
    numpy as in encode_stage2. Equal to encode_stage1 then encode_stage2,
    and to encode_filters, for every pitch and order."""
    md, q15 = longterm_params(pitch, ltm_coef, num_taps, data.device)
    return cuda_filters.fused_encode(
        data, parcor_coef[:, :parcor_order], md, q15, lms_order
    )


def encode_filters(
    data: torch.Tensor, parcor_coef: torch.Tensor, pitch, ltm_coef,
    parcor_order: int, num_taps: int, lms_order: int,
) -> torch.Tensor:
    """The whole encode cascade for known parameters, in plain PyTorch:
    pre-emphasis -> lattice predict -> long-term predict -> LMS predict.
    The reference chain the stages are held against."""
    B, dev = data.shape[0], data.device
    out, _ = pre_emphasis(data, torch.zeros((B,), dtype=torch.int32, device=dev))
    out, _ = lattice_predict(
        out, parcor_coef[:, :parcor_order], lattice_init_state(B, parcor_order, dev)
    )
    md, q15 = longterm_params(pitch, ltm_coef, num_taps, dev)
    out = longterm_predict_q15(out, md, q15)
    out, _ = lms_predict(out, lms_init_state(B, lms_order, dev), lms_order)
    return out


def select_backend(configured: str, row_samples: int, device: torch.device) -> str:
    """Filter backend for the Encoder and Decoder: 'host' (native C++
    cascade) for batches too small to amortize a device dispatch, 'device'
    (the torch stages on `device`) for big batches when that device is a
    CUDA card — the tier sla_tpu gives a TPU. Without the native library
    every batch takes the device stages (on the CPU, their plain versions).
    'mesh' is not ported yet."""
    if configured == "mesh":
        raise NotImplementedError("backend='mesh' (multi-GPU) is not ported yet")
    if configured != "auto":
        return configured
    if not native.available():
        return "device"
    try:
        threshold = int(os.environ.get("SLA_TPU_DEVICE_THRESHOLD", DEFAULT_DEVICE_THRESHOLD))
    except ValueError:  # malformed knob: the default, as sla_tpu does
        threshold = DEFAULT_DEVICE_THRESHOLD
    if row_samples < threshold:
        return "host"
    if device.type == "cuda" and torch.cuda.is_available():
        return "device"
    return "host"


def device_entropy_on(config, backend: str) -> bool:
    """On-chip entropy coding is not ported yet (sla_tpu/rice_device.py), so
    the port codes symbols on the host whatever the backend: its
    device_entropy='auto' means host entropy until that port lands. Streams
    are byte-identical either way. SLA_TPU_DEVICE_ENTROPY is refused rather
    than ignored: set to force the device coder on, the request cannot be
    met, and set to anything at all, sla_tpu's host encoder reads its mere
    presence as a device-entropy request."""
    if os.environ.get("SLA_TPU_DEVICE_ENTROPY", "").strip():
        raise NotImplementedError(
            "SLA_TPU_DEVICE_ENTROPY: on-chip entropy coding is not ported to "
            "sla_tpu_torch yet; unset it"
        )
    return False


def to_rows(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a (B, L) int32 numpy batch."""
    return torch.from_numpy(np.ascontiguousarray(batch, dtype=np.int32)).to(device)
