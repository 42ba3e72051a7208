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

With SLA_TPU_DEBUG_ASSERTS set, every stage runs its checked plain version
on the rows' own device instead of the kernel (debug.py): sla_tpu's assert
mode runs its checkified scans instead of Pallas in the same way. This
route is taken only when the variable is set.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import debug, native
from .kernels import cuda_filters
from .kernels.emphasis import pre_emphasis
from .kernels.lattice import lattice_init_state, lattice_predict
from .kernels.lms import lms_init_state, lms_predict
from .kernels.longterm import longterm_predict_q15
from .params import longterm_params

# row-samples below which 'auto' keeps the native host cascade: sla_tpu's
# value (sla_tpu/pipeline.py:683-687), kept only because the card's sweep
# gives no threshold; it is not a measured crossover. chip_smoke.py phase 8
# (bench.make_signal at 5-300 s, backend 'host' against 'device', best of 3;
# NVIDIA H100 80GB HBM3, 700.00 W power limit; four sweeps in three runs)
# found the card's encode slower than the host's at 1.3M, 15.9M and 26.5M
# row-samples in every sweep, faster at 0.44M and once each at 2.6M, 5.3M
# and 10.6M, so no swept size has every larger one no slower on the card.
# Around the value, at 15.9M and 26.5M, the card encoded that signal slower
# (host / card 0.69-0.92), while in both final runs phase 3's music clip
# at 26.5M encoded faster on the card (0.619 / 0.639 s, 1.015 / 1.150 s):
# the choice rests on one synthetic signal. Decode was faster on the card from 1.3M
# to 10.6M in every sweep and slower at 26.5M in three of four.
DEFAULT_DEVICE_THRESHOLD = 16_000_000


def encode_stage1(data: torch.Tensor, parcor_coef: torch.Tensor, parcor_order: int) -> torch.Tensor:
    """data: (B, L) int32, parcor_coef: (B, p) int32 (orders 1..p).
    Returns the PARCOR residual (B, L)."""
    if debug.asserts_enabled():
        return cuda_filters.lattice_predict_plain(data, parcor_coef[:, :parcor_order])
    return cuda_filters.lattice_predict(data, parcor_coef[:, :parcor_order])


def encode_stage2(
    residual: torch.Tensor, pitch, ltm_coef, num_taps: int, lms_order: int,
) -> torch.Tensor:
    """residual: (B, L) PARCOR residual; pitch: (B,) int32 numpy (0
    disables the long-term stage for that row); ltm_coef: (B, >=T) int32
    Q31 numpy. Returns the final residual handed to the entropy coder."""
    md, q15 = longterm_params(pitch, ltm_coef, num_taps, residual.device)
    if debug.asserts_enabled():
        return cuda_filters.stage2_predict_plain(residual, md, q15, lms_order)
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
    synth = (cuda_filters.synth_cascade_plain if debug.asserts_enabled()
             else cuda_filters.synth_cascade)
    return synth(residual, parcor_coef[:, :parcor_order], md, q15, lms_order)


def encode_filters_fused(
    data: torch.Tensor, parcor_coef: torch.Tensor, pitch, ltm_coef,
    parcor_order: int, num_taps: int, lms_order: int,
) -> torch.Tensor:
    """The whole encode cascade for known parameters in one pass (K4):
    pre-emphasis -> lattice predict -> long-term predict -> LMS predict.
    data: (B, L) int32; parcor_coef: (B, >=p) int32; pitch and ltm_coef
    numpy as in encode_stage2. Equal to encode_stage1 then encode_stage2,
    and to encode_filters, for every pitch and order. Assert mode runs the
    two checked stages instead, as sla_tpu does."""
    if debug.asserts_enabled():
        return encode_stage2(
            encode_stage1(data, parcor_coef, parcor_order), pitch, ltm_coef,
            num_taps, lms_order,
        )
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


def mesh_cards(device: torch.device) -> list[torch.device]:
    """The CUDA cards a mesh on `device` spans: every card torch sees, or
    only `device` itself inside a torch.distributed group of more than one
    process, which runs one process a card (corpus.py's process grid)."""
    import torch.distributed as dist

    device = torch.device(device)
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        index = torch.cuda.current_device() if device.index is None else device.index
        return [torch.device("cuda", index)]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def select_backend(configured: str, row_samples: int, device: torch.device) -> str:
    """Filter backend for the Encoder and Decoder: 'host' (native C++
    cascade) for batches too small to amortize a device dispatch, 'device'
    (the torch stages on `device`) for big batches when that device is a
    CUDA card — the tier sla_tpu gives a TPU — and 'mesh' (the stages
    sharded over the cards of mesh_cards, parallel/) when that is more than
    one card, as sla_tpu picks its mesh (sla_tpu/pipeline.py:705-711). A
    CPU device never picks the mesh under 'auto': torch has no
    multi-device CPU runtime. Without the native library every batch takes
    the device stages (on the CPU, their plain versions)."""
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
        return "mesh" if len(mesh_cards(device)) > 1 else "device"
    return "host"


def device_entropy_on(config, backend: str) -> bool:
    """Shared device-entropy policy of the Encoder and Decoder (one
    definition, so the two sides cannot drift; sla_tpu/pipeline.py
    device_entropy_on): on-card symbol coding (K8, K9) is the default
    whenever the filter or synthesis batch runs on the device or mesh
    backend; SLA_TPU_DEVICE_ENTROPY forces it whatever the backend (both
    directions then move the batch across the host/device boundary
    themselves); config.device_entropy='off' turns the default off. The
    variable is parsed: '0'/'off'/'false'/'no' (any case, stripped) force it
    off, anything else non-empty forces it on, unset or empty defers to the
    config."""
    v = os.environ.get("SLA_TPU_DEVICE_ENTROPY", "").strip().lower()
    if v:
        return v not in ("0", "off", "false", "no")
    if getattr(config, "device_entropy", "auto") == "off":
        return False
    return backend in ("device", "mesh")


def fetch_int32(x: torch.Tensor) -> np.ndarray:
    """An int32 tensor on the host, equal to x.cpu().numpy(): copied as
    int16 and widened on the host when every value fits (residuals usually
    do), which halves the device-to-host copy; one on-device range check
    and one scalar read decide (sla_tpu/pipeline.py:36-56)."""
    if bool(((x >= -32768) & (x <= 32767)).all()):
        return x.to(torch.int16).cpu().numpy().astype(np.int32)
    return x.cpu().numpy()


def to_rows(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a (B, L) int32 numpy batch."""
    return torch.from_numpy(np.ascontiguousarray(batch, dtype=np.int32)).to(device)
