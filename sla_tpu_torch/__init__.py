"""sla_tpu_torch — the SLA codec's filter path on PyTorch and hand-written CUDA.

A port of `sla_tpu` for one NVIDIA H100. The host layers (analysis, entropy
coding, container format, native C++ runtime) are `sla_tpu`'s own modules,
loaded through `sla_tpu_torch.host` without importing jax. The per-sample
filter cascade — stage 1 (pre-emphasis + PARCOR lattice predict), stage 2
(long-term FIR + sign-sign LMS predict) and the decode synthesis cascade —
runs as CUDA kernels (`kernels/cuda_filters.py`) on a CUDA device and as
their plain PyTorch versions on the CPU; so do the whole encode cascade for
known parameters (`pipeline.encode_filters_fused`, `entry.entry()`) and the
single stages the device tools (`tools/`) check. Streams are byte-identical
to `sla_tpu`'s and decoded PCM is exact.

This package imports torch and never jax.
"""

import os as _os

# Keep large scratch buffers in the heap across frees (sla_tpu/__init__.py
# sets the same thresholds): the codec churns through multi-hundred-MB
# buffers per encode, and glibc returns every >128 KB block to the OS on
# free, so each reuse page-faults it back in. Opt out with SLA_TPU_NO_MALLOPT.
if not _os.environ.get("SLA_TPU_NO_MALLOPT"):
    try:
        import ctypes as _ctypes

        _libc = _ctypes.CDLL("libc.so.6")
        _libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        _libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except OSError:
        pass

from .host.constants import ChannelProcessMethod, WindowFunctionType  # noqa: E402
from .host.errors import ApiResult, SLAError  # noqa: E402,F401
from .host.format import EncodeParameter, WaveFormat  # noqa: E402
from .host.encoder import EncoderConfig  # noqa: E402,F401
from .host.decoder import DecoderConfig  # noqa: E402,F401
from .encoder import Encoder  # noqa: E402,F401
from .decoder import Decoder  # noqa: E402,F401

# Encode presets 0..4, restated from sla_tpu/__init__.py (which imports jax);
# tests hold them equal to sla_tpu.PRESETS. Reference: src/main.c:63-70.
PRESETS = (
    EncodeParameter(8, 1, 4, ChannelProcessMethod.NONE, WindowFunctionType.RECTANGULAR, 4096),
    EncodeParameter(8, 1, 8, ChannelProcessMethod.STEREO_MS, WindowFunctionType.SIN, 12288),
    EncodeParameter(16, 1, 8, ChannelProcessMethod.STEREO_MS, WindowFunctionType.SIN, 12288),
    EncodeParameter(32, 3, 8, ChannelProcessMethod.STEREO_MS, WindowFunctionType.SIN, 12288),
    EncodeParameter(32, 3, 8, ChannelProcessMethod.STEREO_MS, WindowFunctionType.SIN, 16384),
)
DEFAULT_PRESET = 2


def preset_parameter(preset_no: int, num_channels: int) -> EncodeParameter:
    """Preset's encode parameter for a given channel count: MS only applies
    to actual stereo sources (reference main.c:124-130)."""
    p = PRESETS[preset_no]
    ch_method = (
        p.ch_process_method if num_channels == 2 else ChannelProcessMethod.NONE
    )
    return EncodeParameter(
        p.parcor_order, p.longterm_order, p.lms_order_per_filter,
        ch_method, p.window_function_type, p.max_num_block_samples,
    )
