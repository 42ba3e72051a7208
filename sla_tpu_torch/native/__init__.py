"""ctypes bindings for the native host entropy stage (sla_native.cpp).

Builds the shared library at first use with g++ -O3 into
`build/sla_tpu_torch/` beside the package, never beside the source: the
build is keyed by a hash of the source, the command and the CPU that
`-march=native` resolves to, runs under a file lock and is published
atomically (kernels/build.py). Falls back gracefully: callers check
`available()` and use the pure-Python codecs in the port's `rice`
otherwise.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

from ..constants import LONGTERM_MAX_PERIOD
from ..errors import ApiResult, SLAError

# single-row synth scratch: long-term ring capacity (any size >= max lag +
# taps decodes identically; keep one canonical value)
_LT_HIST_LEN = LONGTERM_MAX_PERIOD + 2

_SRC = pathlib.Path(__file__).resolve().parent / "sla_native.cpp"
GXX_FLAGS = [
    # -ffp-contract=off: FMA contraction would change the FFT's
    # float64 rounding and break byte-identity with the reference
    "-O3", "-march=native", "-funroll-loops",
    "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC", "-fwrapv",
    "-pthread",  # block-parallel entropy stages
]

_lib: ctypes.CDLL | None = None
_load_failed = False
_load_lock = threading.Lock()  # one build/load per process

# SLA_TPU_SANITIZE selects an ASan + UBSan instrumented build, under its own
# name, so the normal library's build is untouched. The instrumented library
# only loads when libasan is preloaded before Python starts; the fp flags
# stay identical, so its streams are byte-identical too.
# -fno-sanitize-recover: any finding aborts loudly (-fwrapv already makes
# signed wrap defined, so UBSan does not flag the format's int32 wrapping).
SANITIZE_FLAGS = ["-fsanitize=address,undefined", "-fno-sanitize-recover=all",
                  "-fno-omit-frame-pointer", "-g"]
# SLA_TPU_NATIVE_DEBUG selects a -DSLA_TPU_DEBUG build whose cascades carry
# the reference's SLA_Assert-equivalent invariant checks (LMS tap products,
# lattice stage products, long-term prediction range, Levinson e>=0 and
# |gamma|<1), compiled out of the production library exactly like NDEBUG.
DEBUG_FLAGS = ["-DSLA_TPU_DEBUG"]


def _sanitize() -> bool:
    return bool(os.environ.get("SLA_TPU_SANITIZE"))


def build_command() -> tuple[str, list[str]]:
    """(library name, g++ command) of the variant the environment selects:
    the sanitized build, else the debug build, else the production one.
    Each variant builds under its own name and key in build/sla_tpu_torch/."""
    cmd = ["g++"] + GXX_FLAGS
    if _sanitize():
        return "sla_native_san", cmd + SANITIZE_FLAGS + (
            DEBUG_FLAGS if os.environ.get("SLA_TPU_NATIVE_DEBUG") else [])
    if os.environ.get("SLA_TPU_NATIVE_DEBUG"):
        return "sla_native_dbg", cmd + DEBUG_FLAGS
    return "sla_native", cmd


def _build() -> pathlib.Path | None:
    """The built library's path, or None when g++ is missing or fails. A
    failed sanitized build raises: the sanitizer run must never go on with
    no native code under ASan."""
    from ..kernels.build import build_library

    name, cmd = build_command()
    try:
        # what -march=native means on this CPU: a library built for one
        # machine is never loaded on another
        target = subprocess.run(
            ["g++", "-march=native", "-Q", "--help=target"],
            capture_output=True, text=True, check=True,
        ).stdout
        return build_library(name, cmd, [_SRC], key=target)
    except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
        if _sanitize():
            raise RuntimeError(
                "SLA_TPU_SANITIZE is set but the instrumented build failed "
                f"(g++ needs -fsanitize support): {e}"
            ) from e
        return None


def _load() -> ctypes.CDLL | None:
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed or os.environ.get("SLA_TPU_NO_NATIVE"):
        return None
    with _load_lock:
        return _load_locked()


def _load_locked() -> ctypes.CDLL | None:
    global _lib, _load_failed
    if _lib is not None:  # raced another thread past the lock
        return _lib
    if _load_failed:
        return None
    path = _build()
    if path is None:
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        if _sanitize():
            # never fall back to Python in sanitizer mode: the point is
            # running the native code under ASan
            raise RuntimeError(
                "SLA_TPU_SANITIZE is set but the instrumented library failed "
                f"to load (libasan must be LD_PRELOADed before Python): {e}"
            ) from e
        _load_failed = True
        return None

    i64, i32, u16 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint16
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_u32 = ctypes.POINTER(ctypes.c_uint32)

    lib.sla_crc16.restype = u16
    lib.sla_crc16.argtypes = [p_u8, i64]
    lib.sla_put_data_array.restype = i64
    lib.sla_put_data_array.argtypes = [p_i32, i32, i32, p_u32, p_u8, i64]
    lib.sla_get_data_array.restype = i64
    lib.sla_get_data_array.argtypes = [p_u8, i64, i64, i32, i32, p_u32, p_i32]
    lib.sla_put_raw.restype = i64
    lib.sla_put_raw.argtypes = [p_i32, i32, i32, p_i32, p_u8, i64]
    lib.sla_get_raw.restype = i64
    lib.sla_get_raw.argtypes = [p_u8, i64, i64, i32, i32, p_i32, p_i32]
    lib.sla_initial_params.restype = None
    lib.sla_initial_params.argtypes = [p_i32, i32, i32, p_u32]
    lib.sla_initial_params_rows.restype = None
    lib.sla_initial_params_rows.argtypes = [
        p_i32, i64, i32, ctypes.POINTER(ctypes.c_int64), p_u32,
    ]
    p_f64 = ctypes.POINTER(ctypes.c_double)
    lib.sla_fft.restype = None
    lib.sla_fft.argtypes = [p_f64, ctypes.c_uint32, i32]
    lib.sla_lesolve.restype = i32
    lib.sla_lesolve.argtypes = [p_f64, p_f64, i32, i32]
    lib.sla_longterm_autocorr.restype = None
    lib.sla_longterm_autocorr.argtypes = [p_i32, i32, p_f64, i32, p_f64, i32]
    lib.sla_longterm_autocorr_rows8.restype = None
    lib.sla_longterm_autocorr_rows8.argtypes = [p_i32, p_i32, i32, p_f64, i32, p_f64, i32]
    p_i64_arr = ctypes.POINTER(ctypes.c_int64)
    lib.sla_span_autocorr.restype = i32
    lib.sla_span_autocorr.argtypes = [
        p_f64, i32, i32, p_i64_arr, i32, p_i64_arr, i32, i32, p_f64,
    ]
    lib.sla_span_autocorr_multi.restype = i32
    lib.sla_span_autocorr_multi.argtypes = [
        p_f64, i32, i64, p_i64_arr, i32, i64, p_i64_arr, i32, p_i64_arr,
        i32, i32, p_f64,
    ]
    lib.sla_span_autocorr_multi_onepass.restype = i32
    lib.sla_span_autocorr_multi_onepass.argtypes = (
        lib.sla_span_autocorr_multi.argtypes
    )
    _i32src_args = [
        p_i32, i64, i32, i32, p_i64_arr, i32, i64, p_i64_arr, i32,
        p_i64_arr, i32, i32, p_f64,
    ]
    lib.sla_span_autocorr_multi_i32.restype = i32
    lib.sla_span_autocorr_multi_i32.argtypes = _i32src_args
    lib.sla_span_autocorr_multi_onepass_i32.restype = i32
    lib.sla_span_autocorr_multi_onepass_i32.argtypes = _i32src_args
    lib.sla_span_cost.restype = i32
    lib.sla_span_cost.argtypes = [p_f64, p_f64, i32, i32, i32, i32, p_f64, p_f64, p_f64]
    lib.sla_encode_block.restype = i64
    lib.sla_encode_block.argtypes = [
        i32, i32, i32, i32, i32, i32, i32,
        p_i32, p_i32, p_i32, p_i32, p_u32, p_i32, p_i32, p_u8, i64,
    ]
    lib.sla_encode_blocks.restype = i64
    lib.sla_encode_blocks.argtypes = [
        i32, i32, i32, i32, i32, i32,
        p_i32, p_i32, p_i32, p_i32, p_i32, p_i32, p_u32,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
        p_i32, p_u8, i64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sla_partition_solve.restype = i32
    lib.sla_partition_solve.argtypes = [
        p_f64, ctypes.POINTER(ctypes.c_int64), p_i32, p_i32, i32,
        ctypes.c_double, p_i32, p_i32,
    ]
    p_u64 = ctypes.POINTER(ctypes.c_uint64)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    lib.sla_get_data_arrays.restype = i64
    lib.sla_get_data_arrays.argtypes = [
        p_u8, i64, i32, ctypes.POINTER(ctypes.c_int64), i32, p_i32, p_u32,
        p_i32, ctypes.POINTER(ctypes.c_int64), i64,
    ]
    lib.sla_get_data_array_partial.restype = i32
    lib.sla_get_data_array_partial.argtypes = [
        p_u8, i64, p_i64, i32, i32, p_u64, p_u32, i32, p_i32,
    ]
    lib.sla_parse_block_headers.restype = i64
    lib.sla_parse_block_headers.argtypes = [
        p_u8, i64, i64, i64, i32, i32, i32, i32, i32, i32, i64,
        p_i64, p_i64, p_i32, p_i32, p_i64, p_i32, p_i32, p_i32, p_u32,
    ]
    lib.sla_parse_stream_block_header.restype = i64
    lib.sla_parse_stream_block_header.argtypes = [
        i64, i64, i32, i32, i32, i32, i32, p_i64, p_i32, p_i32, p_i32, p_u32,
    ]
    lib.sla_find_pitch.restype = i32
    lib.sla_find_pitch.argtypes = [p_f64, i32]
    lib.sla_ms_shift_blocks.restype = None
    lib.sla_ms_shift_blocks.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), p_i32, i32, i32, i64, i32, i32, p_i32,
    ]
    lib.sla_block_stats.restype = None
    lib.sla_block_stats.argtypes = [
        p_i32, i64, i32, ctypes.POINTER(ctypes.c_int64), p_i32, i32, p_i32, p_i32,
    ]
    lib.sla_longterm_post.restype = i32
    lib.sla_longterm_post.argtypes = [p_f64, i32, i32, i32, i32, p_i32, p_f64]
    lib.sla_lpc_analyze.restype = i32
    lib.sla_lpc_analyze.argtypes = [p_f64, i32, i32, i32, p_f64, p_f64]
    lib.sla_lpc_analyze_rows_mt.restype = i32
    lib.sla_lpc_analyze_rows_mt.argtypes = [
        p_f64, i32, i32, i32, i32, p_f64, i32, p_f64, p_f64,
    ]
    lib.sla_longterm_autocorr_rows_mt.restype = i32
    lib.sla_longterm_autocorr_rows_mt.argtypes = [
        p_i32, p_i32, i32, i32, i32, p_f64, i32,
    ]
    lib.sla_lpc_analyze_rows8.restype = i32
    lib.sla_lpc_analyze_rows8.argtypes = [p_f64, i32, i32, i32, p_f64, i32, p_f64, p_f64]
    lib.sla_lpc_analyze_rows_off_mt.restype = i32
    lib.sla_lpc_analyze_rows_off_mt.argtypes = [
        p_f64, p_i64, i32, i32, i32, i32, p_f64, i32, p_f64, p_f64,
    ]
    lib.sla_lpc_analyze_rows_off_i32_mt.restype = i32
    lib.sla_lpc_analyze_rows_off_i32_mt.argtypes = [
        p_i32, i64, p_i64, p_i32, i32, i32, i32, i32, p_f64, i32, p_f64, p_f64,
    ]
    lib.sla_make_window.restype = i32
    lib.sla_make_window.argtypes = [i32, i32, p_f64]
    lib.sla_pack_parts.restype = i64
    lib.sla_pack_parts.argtypes = [p_u32, p_i32, i64, p_u8, i64]
    lib.sla_init_param_state.restype = None
    lib.sla_init_param_state.argtypes = [p_u32, i32, p_u64, p_u32, ctypes.POINTER(i32)]
    lib.sla_predict_stage1.restype = i32
    lib.sla_predict_stage1.argtypes = [p_i32, p_i32, i32, p_i32, i32]
    lib.sla_predict_stage2.restype = i32
    lib.sla_predict_stage2.argtypes = [p_i32, p_i32, i32, i32, p_i32, i32, i32]
    lib.sla_predict_stage1_rows8.restype = i32
    lib.sla_predict_stage1_rows8.argtypes = [p_i32, p_i32, i32, p_i32, i32]
    lib.sla_predict_stage1_rows16.restype = i32
    lib.sla_predict_stage1_rows16.argtypes = [p_i32, p_i32, i32, p_i32, i32]
    lib.sla_predict_stage1_rows8_at.restype = i32
    lib.sla_predict_stage1_rows8_at.argtypes = [p_i32, p_i64, p_i32, i32, p_i32, i32]
    lib.sla_predict_stage1_rows16_at.restype = i32
    lib.sla_predict_stage1_rows16_at.argtypes = [p_i32, p_i64, p_i32, i32, p_i32, i32]
    _synth_out_args = [
        p_i32, i32, p_i32, i32, p_i32, p_i32, i32, i32,
        p_i32, p_i64, i32, i32,
    ]
    lib.sla_synth_rows8_out.restype = i32
    lib.sla_synth_rows8_out.argtypes = _synth_out_args
    lib.sla_synth_rows16_out.restype = i32
    lib.sla_synth_rows16_out.argtypes = _synth_out_args
    # row-pointer (_at) forms: rows at base + offs, no pack/scatter copies
    _synth_at_args = [
        p_i32, p_i64, p_i32, p_i64, i32, p_i32, i32, p_i32, p_i32, i32, i32,
    ]
    lib.sla_synth_rows8_at.restype = i32
    lib.sla_synth_rows8_at.argtypes = _synth_at_args
    lib.sla_synth_rows16_at.restype = i32
    lib.sla_synth_rows16_at.argtypes = _synth_at_args
    _synth_out_at_args = [
        p_i32, p_i64, i32, p_i32, i32, p_i32, p_i32, i32, i32,
        p_i32, p_i64, i32, i32,
    ]
    lib.sla_synth_rows8_out_at.restype = i32
    lib.sla_synth_rows8_out_at.argtypes = _synth_out_at_args
    lib.sla_synth_rows16_out_at.restype = i32
    lib.sla_synth_rows16_out_at.argtypes = _synth_out_at_args
    lib.sla_predict_stage2_rows8.restype = i32
    lib.sla_predict_stage2_rows8.argtypes = [p_i32, p_i32, i32, p_i32, p_i32, i32, i32]
    lib.sla_predict_stage2_rows16.restype = i32
    lib.sla_predict_stage2_rows16.argtypes = [p_i32, p_i32, i32, p_i32, p_i32, i32, i32]
    lib.sla_synth_rows8.restype = i32
    lib.sla_synth_rows8.argtypes = [
        p_i32, p_i32, i32, p_i32, i32, p_i32, p_i32, i32, i32,
    ]
    lib.sla_synth_rows16.restype = i32
    lib.sla_synth_rows16.argtypes = [
        p_i32, p_i32, i32, p_i32, i32, p_i32, p_i32, i32, i32,
    ]
    lib.sla_convert_ms.restype = i32
    lib.sla_convert_ms.argtypes = [
        p_i32, i32, i64, i32, p_i32, i32, p_i32, p_f64, i32,
    ]
    lib.sla_synth_chunk.restype = i32
    lib.sla_synth_chunk.argtypes = [
        p_i32, p_i32, i32,  # residual, out, n
        p_i32, i32, p_i32,  # parcor_coef, order, lattice_state
        i32, p_i32, i32, p_i32, i32, p_i32,  # pitch, ltm_coef, taps, hist, hist_len, lt_processed
        i32, p_i32, p_i32,  # lms_order, lms_state, lms_processed
        p_i32,  # deemph_prev
    ]
    # void* pointer args: accepts both POINTER(c_int32) objects and raw
    # .ctypes.data integers — the streaming tick prebinds the latter
    vp = ctypes.c_void_p
    lib.sla_synth_chunk_rows.restype = i32
    lib.sla_synth_chunk_rows.argtypes = [
        vp, vp, i32, i32,  # residual, out, C, n
        vp, i32, i32, vp,  # parcor_coef, coef_stride, order, lattice_state
        vp, vp, i32, i32,  # pitch, ltm_coef, ltm_stride, num_taps
        vp, i32, vp,  # lt_hist, lt_hist_len, lt_processed
        i32, vp, vp, vp,  # lms_order, lms_state, lms_processed, deemph_prev
        i32, i32,  # ms, shift
    ]
    lib.sla_stream_tick_packed.restype = i32
    lib.sla_stream_tick_packed.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    lib.sla_stream_tick_strided.restype = i32
    lib.sla_stream_tick_strided.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    lib.sla_stream_tick.restype = i32
    lib.sla_stream_tick.argtypes = [
        vp, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),  # buf, len, pos
        vp, vp, i32,  # param_state, eff_params, use_golomb
        vp,  # residual_scratch
        vp, i32, i32,  # out, C, n
        vp, i32, i32, vp,  # parcor_coef, coef_stride, order, lattice_state
        vp, vp, i32, i32,  # pitch, ltm_coef, ltm_stride, num_taps
        vp, i32, vp,  # lt_hist, lt_hist_len, lt_processed
        i32, vp, vp, vp,  # lms_order, lms_state, lms_processed, deemph_prev
        i32, i32,  # ms, shift
    ]

    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def crc16(data: bytes | bytearray | memoryview | np.ndarray) -> int:
    lib = _load()
    if isinstance(data, np.ndarray):
        # reinterpret as bytes: .size on a wider dtype would CRC only the
        # first 1/itemsize of the buffer through a reinterpreted pointer;
        # a non-contiguous view's raw pointer would CRC the skipped bytes
        buf = data.view(np.uint8) if data.dtype != np.uint8 else data
        if not buf.flags.c_contiguous:
            buf = np.ascontiguousarray(buf)
    else:
        buf = np.frombuffer(data, dtype=np.uint8)
    return int(lib.sla_crc16(_u8ptr(buf), buf.size))


def put_data_array(data: np.ndarray, init_params: list[int]) -> bytes:
    """data: (C, N) int32 C-contiguous. Returns the byte-aligned payload."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.int32)
    C, N = data.shape
    params = np.asarray(init_params, dtype=np.uint32)
    # worst case: gamma-escaped 32-bit symbols, bounded ~3x raw; retry bigger on overflow
    cap = 8 * data.nbytes + 1024
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = int(lib.sla_put_data_array(_i32ptr(data), C, N, _u32ptr(params), _u8ptr(out), cap))
        if n >= 0:
            return out[:n].tobytes()
        if n == -3:
            raise SLAError(
                ApiResult.INVALID_ARGUMENT,
                "pathological static-Golomb run (the reference would emit "
                "a multi-gigabit unary string here)",
            )
        if n == -2:
            raise ValueError(f"put_data_array: too many channels for native scratch ({C})")
        cap *= 2


def get_data_array(
    stream: bytes | memoryview, bit_offset: int, C: int, N: int, init_params: list[int]
) -> np.ndarray:
    lib = _load()
    buf = np.frombuffer(stream, dtype=np.uint8)
    params = np.asarray(init_params, dtype=np.uint32)
    out = np.empty((C, N), dtype=np.int32)
    end = int(
        lib.sla_get_data_array(
            _u8ptr(buf), buf.size, bit_offset, C, N, _u32ptr(params), _i32ptr(out)
        )
    )
    if end < 0:
        raise ValueError(f"get_data_array: too many channels for native scratch ({C})")
    if end > 8 * buf.size:
        # the native reader zero-fills past the end; surfacing the over-read
        # here keeps truncated streams loud even with CRC checks disabled
        # (mirrors SLA_APIRESULT_INSUFFICIENT_DATA_SIZE semantics)
        raise SLAError(ApiResult.INSUFFICIENT_DATA_SIZE, "payload over-read")
    return out


def put_raw(data: np.ndarray, bits_per_ch: list[int]) -> bytes:
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.int32)
    C, N = data.shape
    bits = np.asarray(bits_per_ch, dtype=np.int32)
    cap = (sum(bits_per_ch) * N) // 8 + 64
    out = np.empty(cap, dtype=np.uint8)
    n = int(lib.sla_put_raw(_i32ptr(data), C, N, _i32ptr(bits), _u8ptr(out), cap))
    if n < 0:
        raise ValueError(f"native bit emission failed (rc={n})")
    return out[:n].tobytes()


def get_data_arrays_strided(
    stream: bytes | memoryview | np.ndarray,
    bit_offsets: np.ndarray,
    num_samples: np.ndarray,
    init_params: np.ndarray,
    L: int,
) -> tuple[np.ndarray, list[np.ndarray]]:
    """Entropy-decode many blocks straight into synthesis batch layout.

    Like get_data_arrays, but each block's C rows land at row stride L in
    one (W*C, L) buffer — exactly the layout the batched synthesis kernels
    consume, so the decoder skips the assemble-into-batch copy entirely.
    Short (tail) blocks decode in place too: the native coders take the row
    stride directly. Returns (batch, per-block (C, n_b) strided views into
    it). Columns past n_b are uninitialized; callers slice by length."""
    lib = _load()
    buf = (
        stream if isinstance(stream, np.ndarray) else np.frombuffer(stream, dtype=np.uint8)
    )
    offs = np.ascontiguousarray(bit_offsets, dtype=np.int64)
    ns = np.ascontiguousarray(num_samples, dtype=np.int32)
    init = np.ascontiguousarray(init_params, dtype=np.uint32)
    W, C = init.shape
    if np.any(ns > L):
        raise SLAError(
            ApiResult.DETECT_DATA_CORRUPTION,
            "block sample count exceeds the stream's max block size",
        )
    batch = np.empty((W * C, L), dtype=np.int32)
    out_offs = np.arange(W, dtype=np.int64) * (C * L)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    rc = int(
        lib.sla_get_data_arrays(
            _u8ptr(buf), buf.size, W, offs.ctypes.data_as(p_i64), C,
            _i32ptr(ns), _u32ptr(init), _i32ptr(batch),
            out_offs.ctypes.data_as(p_i64), L,
        )
    )
    _raise_get_arrays(rc, C)
    views = [
        batch[b * C : (b + 1) * C, : int(ns[b])] for b in range(W)
    ]
    return batch, views


def _raise_get_arrays(rc: int, C: int) -> None:
    if rc == -1:
        raise ValueError(f"get_data_arrays: too many channels for native scratch ({C})")
    if rc < 0:
        raise SLAError(
            ApiResult.INSUFFICIENT_DATA_SIZE,
            f"payload over-read in block {-rc - 2}",
        )


def get_data_arrays(
    stream: bytes | memoryview | np.ndarray,
    bit_offsets: np.ndarray,
    num_samples: np.ndarray,
    init_params: np.ndarray,
) -> list[np.ndarray]:
    """Entropy-decode many blocks' payloads in one call.

    bit_offsets/num_samples: (W,); init_params: (W, C). Returns per-block
    (C, n_b) int32 views into one flat buffer (same values as per-block
    get_data_array calls)."""
    lib = _load()
    buf = (
        stream if isinstance(stream, np.ndarray) else np.frombuffer(stream, dtype=np.uint8)
    )
    offs = np.ascontiguousarray(bit_offsets, dtype=np.int64)
    ns = np.ascontiguousarray(num_samples, dtype=np.int32)
    init = np.ascontiguousarray(init_params, dtype=np.uint32)
    W, C = init.shape
    out_offs = np.zeros(W, dtype=np.int64)
    np.cumsum(C * ns[:-1].astype(np.int64), out=out_offs[1:])
    total = int(out_offs[-1] + C * ns[-1]) if W else 0
    out = np.empty(total, dtype=np.int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    rc = int(
        lib.sla_get_data_arrays(
            _u8ptr(buf), buf.size, W, offs.ctypes.data_as(p_i64), C,
            _i32ptr(ns), _u32ptr(init), _i32ptr(out),
            out_offs.ctypes.data_as(p_i64), 0,
        )
    )
    _raise_get_arrays(rc, C)
    return [
        out[int(out_offs[b]) : int(out_offs[b]) + C * int(ns[b])].reshape(C, int(ns[b]))
        for b in range(W)
    ]


def get_raw(
    stream: bytes | memoryview, bit_offset: int, C: int, N: int, bits_per_ch: list[int]
) -> np.ndarray:
    lib = _load()
    buf = np.frombuffer(stream, dtype=np.uint8)
    bits = np.asarray(bits_per_ch, dtype=np.int32)
    out = np.empty((C, N), dtype=np.int32)
    end = int(
        lib.sla_get_raw(_u8ptr(buf), buf.size, bit_offset, C, N, _i32ptr(bits), _i32ptr(out))
    )
    if end > 8 * buf.size:
        raise SLAError(ApiResult.INSUFFICIENT_DATA_SIZE, "raw payload over-read")
    return out


def _f64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))




def fft(data: np.ndarray, sign: int) -> None:
    """In-place real FFT with the reference's exact butterfly arithmetic
    (SLAUtility_FFT). data: (n,) float64, n a power of two."""
    lib = _load()
    if data.dtype != np.float64 or not data.flags.c_contiguous:
        raise ValueError("fft: need a C-contiguous float64 array")
    lib.sla_fft(_f64ptr(data), data.size, sign)


def lesolve(A: np.ndarray, b: np.ndarray, iterations: int = 2) -> int:
    """Solve A x = b in place (b becomes x) with the reference's Crout LU +
    long-double iterative refinement. Returns 0 ok, -1 singular."""
    lib = _load()
    A = np.ascontiguousarray(A, dtype=np.float64)
    if b.dtype != np.float64 or not b.flags.c_contiguous:
        raise ValueError("lesolve: need a C-contiguous float64 array")
    return int(lib.sla_lesolve(_f64ptr(A), _f64ptr(b), A.shape[0], iterations))


def longterm_autocorr(data: np.ndarray, fft_size: int, out_lags: int) -> np.ndarray:
    """Wiener-Khinchin autocorrelation of one int32 row, bit-exact to the
    reference analysis path. Returns (out_lags,) float64."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.int32)
    work = np.empty(fft_size, dtype=np.float64)
    out = np.empty(out_lags, dtype=np.float64)
    lib.sla_longterm_autocorr(
        _i32ptr(data), data.size, _f64ptr(work), fft_size, _f64ptr(out), out_lags
    )
    return out


def longterm_autocorr_rows(
    data: np.ndarray, lengths: np.ndarray, fft_size: int, out_lags: int
) -> np.ndarray:
    """Batched exact autocorrelation: (B, L) int32 rows with per-row valid
    lengths -> (B, out_lags). Groups of 8 run through the interleaved FFT
    (identical per-row arithmetic); stragglers use the scalar path."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.int32)
    B, L = data.shape
    out = np.empty((B, out_lags), dtype=np.float64)
    lens = np.ascontiguousarray(lengths, dtype=np.int32)
    # one call: 8-row interleaved exact FFTs with a zero-padded tail group,
    # sharded across worker threads on multi-core hosts
    lib.sla_longterm_autocorr_rows_mt(
        _i32ptr(data), _i32ptr(lens), B, L, fft_size, _f64ptr(out), out_lags
    )
    return out


def ms_shift_blocks(
    sources: list[np.ndarray],
    dst_offsets: np.ndarray,
    num_samples: np.ndarray,
    dst: np.ndarray,
    shift: int,
    ms: bool,
) -> None:
    """Assemble final PCM: per block, MS inverse (when ms) + left shift
    from (C, n) synthesis rows into the (C, total) output at the block's
    sample offset — one native pass, no per-block temporaries."""
    lib = _load()
    W = len(sources)
    C, total = dst.shape
    ptrs = np.empty(W, dtype=np.uint64)
    strides = np.empty(W, dtype=np.int64)
    keep = []
    for b, rows in enumerate(sources):
        if rows.dtype != np.int32 or rows.strides[1] != 4 or rows.strides[0] % 4:
            rows = np.ascontiguousarray(rows, dtype=np.int32)
        keep.append(rows)
        ptrs[b] = rows.ctypes.data
        strides[b] = rows.strides[0] // 4
    offs = np.ascontiguousarray(dst_offsets, dtype=np.int64)
    ns = np.ascontiguousarray(num_samples, dtype=np.int32)
    p_u64 = ctypes.POINTER(ctypes.c_uint64)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    lib.sla_ms_shift_blocks(
        ptrs.ctypes.data_as(p_u64), strides.ctypes.data_as(p_i64),
        offs.ctypes.data_as(p_i64), _i32ptr(ns), W, C, total, int(shift),
        1 if ms else 0, _i32ptr(dst),
    )
    del keep


def block_stats(
    base: np.ndarray, offsets: np.ndarray, num_samples: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-block per-channel (max, min) over views of a (C, N) signal in
    one pass — feeds the silence scan and the bit-width derivation."""
    lib = _load()
    base = np.ascontiguousarray(base, dtype=np.int32)
    C, N = base.shape
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    ns = np.ascontiguousarray(num_samples, dtype=np.int32)
    W = offs.size
    mx = np.empty((W, C), dtype=np.int32)
    mn = np.empty((W, C), dtype=np.int32)
    lib.sla_block_stats(
        _i32ptr(base), N, C, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _i32ptr(ns), W, _i32ptr(mx), _i32ptr(mn),
    )
    return mx, mn


def longterm_post(
    ac: np.ndarray, num_taps: int, max_period: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pitch + Toeplitz solve + stability clamp for every row of ac
    (B, lags) in one call. Returns (pitch (B,) int32, coef (B, T) f64);
    disabled rows get pitch 0 / zero coefficients."""
    lib = _load()
    ac = np.ascontiguousarray(ac, dtype=np.float64)
    B, lags = ac.shape
    pitch = np.empty(B, dtype=np.int32)
    coef = np.empty((B, num_taps), dtype=np.float64)
    rc = lib.sla_longterm_post(
        _f64ptr(ac), B, lags, num_taps, max_period, _i32ptr(pitch), _f64ptr(coef)
    )
    if rc != 0:
        raise ValueError(f"longterm_post: tap count out of native scratch range ({num_taps})")
    return pitch, coef


class PayloadCursor:
    """Resumable entropy-decode cursor over one block payload."""

    def __init__(self, init_params: list[int], num_channels: int, bit_offset: int):
        C = num_channels
        self.C = C
        self.bit_pos = ctypes.c_int64(0)
        self.param_state = np.zeros(C * 2, dtype=np.uint64)
        self.eff_params = np.zeros(C, dtype=np.uint32)
        self.reinit(init_params, bit_offset)

    def reinit(self, init_params, bit_offset: int) -> None:
        """(Re-)seed the cursor IN PLACE — sla_init_param_state overwrites
        every param_state/eff_params slot, so this serves both first
        construction and block transitions: the storage (and thus any
        pointers a prebound StreamTick captured) stays put; only the values
        reset. use_golomb can flip per block — rebind dependents
        (StreamTick slot 5)."""
        lib = _load()
        self.bit_pos.value = bit_offset
        use_golomb = ctypes.c_int32(0)
        lib.sla_init_param_state(
            _u32ptr(np.asarray(init_params, dtype=np.uint32)), self.C,
            self.param_state.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            _u32ptr(self.eff_params), ctypes.byref(use_golomb),
        )
        self.use_golomb = int(use_golomb.value)

    def read(self, stream: bytes | memoryview | np.ndarray, num_samples: int) -> np.ndarray:
        """Decode the next `num_samples` interleaved symbols -> (C, n) int32."""
        lib = _load()
        buf = (
            stream
            if isinstance(stream, np.ndarray)
            else np.frombuffer(stream, dtype=np.uint8)
        )
        out = np.empty((self.C, num_samples), dtype=np.int32)
        _ck(lib.sla_get_data_array_partial(
            _u8ptr(buf), buf.size, ctypes.byref(self.bit_pos), self.C, num_samples,
            self.param_state.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            _u32ptr(self.eff_params), self.use_golomb, _i32ptr(out),
        ), "payload_cursor.read")
        return out


def _ck(rc: int, where: str) -> None:
    """Raise on a nonzero native return code: the kernels reject geometry
    they lack scratch for (e.g. num_taps > 8, orders > 64) and returning
    their untouched/partial output as audio would be silent corruption."""
    if rc:
        raise ValueError(f"{where}: native kernel rejected the call (rc={rc})")


def _threads() -> int:
    """Worker threads for the row-group filter stages (mirrors the native
    entropy_threads policy: SLA_TPU_THREADS override, else cpu count capped
    at 8)."""
    v = os.environ.get("SLA_TPU_THREADS")
    if v:
        try:
            return max(1, int(v))
        except ValueError:
            return 1
    return max(1, min(os.cpu_count() or 1, 8))


def _run_jobs(jobs: list) -> None:
    """Run row-group closures serially or on a thread pool. The native
    calls release the GIL and every job writes a disjoint output region,
    so any schedule is byte-identical to the serial loop."""
    if len(jobs) > 1 and _threads() > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(_threads(), len(jobs))) as ex:
            for _ in ex.map(lambda f: f(), jobs):
                pass
    else:
        for f in jobs:
            f()


def _row_groups(lens) -> tuple[list, list]:
    """Group nonzero-length rows into SIMD lane groups of 8/16.

    Equal-length rows group exactly (preserving the consecutive zero-copy
    view path); each bucket's leftovers pool across buckets, sorted by
    descending length, into mixed-length groups that run to the GROUP MAX
    (short rows' inputs zero-pad; outputs past a row's own length are
    discarded, so every written sample is identical to a per-row run).
    Without pooling, the optimal partition's variable block sizes fragment
    the buckets into sub-8 tails that fall to the scalar path.

    Returns (groups, singles): groups as (n, idx, row_lens) with
    row_lens None for exact groups; singles as (n, b) scalar rows."""
    by_len: dict[int, list[int]] = {}
    for b, n in enumerate(lens):
        if n > 0:
            by_len.setdefault(int(n), []).append(b)
    groups: list = []
    pool: list = []
    for n, rows in by_len.items():
        g = 0
        while g + 8 <= len(rows):
            take = 16 if g + 16 <= len(rows) else 8
            groups.append((n, rows[g : g + take], None))
            g += take
        pool.extend((n, b) for b in rows[g:])
    pool.sort(key=lambda t: -t[0])
    g = 0
    while g + 8 <= len(pool):
        take = 16 if g + 16 <= len(pool) else 8
        chunk = pool[g : g + take]
        if chunk[0][0] == chunk[-1][0]:  # equal lengths after all
            groups.append((chunk[0][0], [b for _, b in chunk], None))
        else:
            groups.append(
                (chunk[0][0], [b for _, b in chunk], [n for n, _ in chunk])
            )
        g += take
    tail = pool[g:]
    if len(tail) >= 4:  # pad with duplicates of the last (shortest) row
        idx = [b for _, b in tail] + [tail[-1][1]] * (8 - len(tail))
        rl = [n for n, _ in tail] + [tail[-1][0]] * (8 - len(tail))
        if rl[0] == rl[-1]:
            groups.append((rl[0], idx, None))
        else:
            groups.append((rl[0], idx, rl))
        tail = []
    return groups, tail

def predict_stage1_rows(
    data: np.ndarray, parcor_coef: np.ndarray, lengths: np.ndarray | None = None
) -> np.ndarray:
    """Host pre-emphasis + lattice predict over a (B, L) batch, row-serial.

    data: (B, L) int32; parcor_coef: (B, p). Returns the (B, L) PARCOR
    residual (rows zero-padded past their length)."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.int32)
    B, L = data.shape
    # empty + per-row tail zeroing: a full np.zeros memset of the ~10 MB
    # batch costs milliseconds under this host's page-fault pricing, and
    # every consumed (row, :length) region is written by a kernel below
    out = np.empty_like(data)
    coef = np.ascontiguousarray(parcor_coef, dtype=np.int32)
    p = coef.shape[1]
    if p > 64:  # native lattice scratch capacity: don't trust callers
        raise ValueError(f"predict_stage1_rows: order out of native scratch range ({p})")
    lens = (
        np.asarray(lengths, dtype=np.int64)
        if lengths is not None
        else np.full(B, L, dtype=np.int64)
    )
    for b in np.nonzero(lens < L)[0]:  # keep the zero-padded contract
        out[b, lens[b] :] = 0
    groups, singles = _row_groups(lens)
    jobs = []
    for n, idx, row_lens in groups:
        # 16-row groups fill a 512-bit int32 vector (measurably faster
        # for the lattice); identical per-row arithmetic either way
        take = len(idx)
        fn = (
            lib.sla_predict_stage1_rows16
            if take == 16
            else lib.sla_predict_stage1_rows8
        )
        i0 = idx[0]
        # consecutive full-width groups pass views straight through —
        # no gather copy in, no scatter copy out
        if row_lens is None and n == L and idx == list(range(i0, i0 + take)):
            coef8 = np.ascontiguousarray(coef[i0 : i0 + take])

            def run(fn=fn, i0=i0, n=n, coef8=coef8):
                fn(_i32ptr(data[i0:]), _i32ptr(out[i0:]), n, _i32ptr(coef8), p)

        elif row_lens is None:
            in8 = np.ascontiguousarray(data[idx, :n])
            coef8 = np.ascontiguousarray(coef[idx])

            def run(fn=fn, idx=idx, n=n, in8=in8, coef8=coef8):
                out8 = np.empty_like(in8)
                fn(_i32ptr(in8), _i32ptr(out8), n, _i32ptr(coef8), p)
                out[idx, :n] = out8

        else:
            in8 = np.zeros((take, n), dtype=np.int32)
            for i, (b, nb) in enumerate(zip(idx, row_lens)):
                in8[i, :nb] = data[b, :nb]
            coef8 = np.ascontiguousarray(coef[idx])

            def run(fn=fn, idx=idx, n=n, in8=in8, coef8=coef8,
                    row_lens=row_lens):
                out8 = np.empty_like(in8)
                fn(_i32ptr(in8), _i32ptr(out8), n, _i32ptr(coef8), p)
                for i, (b, nb) in enumerate(zip(idx, row_lens)):
                    out[b, :nb] = out8[i, :nb]

        jobs.append(run)
    for n, b in singles:

        def run(b=b, n=n):
            row = np.empty(n, dtype=np.int32)
            lib.sla_predict_stage1(
                _i32ptr(data[b]), _i32ptr(row), n, _i32ptr(coef[b]), p
            )
            out[b, :n] = row

        jobs.append(run)
    _run_jobs(jobs)
    return out


def predict_stage1_rows_at(
    base: np.ndarray,
    row_offs: np.ndarray,
    parcor_coef: np.ndarray,
    lengths: np.ndarray,
    L: int,
) -> np.ndarray:
    """predict_stage1_rows over rows that live IN PLACE as (channel,
    offset) slices of the whole-file int32 signal: row b =
    base_flat[row_offs[b] : row_offs[b] + lengths[b]]. Skips the (B, L)
    batch assembly copy (~4 bytes/row-sample of pure traffic). Returns
    the (B, L) residual, rows zero-padded past their length — identical
    values to predict_stage1_rows on an assembled batch.

    Mixed-length lane groups still gather (reading past a short row in
    place could cross the array end); exact-length groups — the common
    case — read in place."""
    lib = _load()
    if parcor_coef.shape[1] > 64:
        raise ValueError("predict_stage1_rows_at: order out of native scratch range")
    if base.dtype != np.int32 or not base.flags.c_contiguous:
        # row_offs embed the buffer's raw element layout: any re-layout or
        # dtype copy would silently misaddress every row (the mixed-length
        # gather below also assumes reshape(-1) is a view)
        raise ValueError(
            "predict_stage1_rows_at: base must be C-contiguous int32")
    offs = np.asarray(row_offs, dtype=np.int64)
    lens = np.asarray(lengths, dtype=np.int64)
    B = offs.size
    out = np.empty((B, L), dtype=np.int32)
    for b in np.nonzero(lens < L)[0]:  # zero-padded contract, tails only
        out[b, lens[b] :] = 0
    coef = np.ascontiguousarray(parcor_coef, dtype=np.int32)
    p = coef.shape[1]
    base_ptr = _i32ptr(base)
    base_addr = base.ctypes.data

    def row_ptr(off):
        return ctypes.cast(base_addr + 4 * int(off),
                           ctypes.POINTER(ctypes.c_int32))

    p_i64 = ctypes.POINTER(ctypes.c_int64)
    groups, singles = _row_groups(lens)
    jobs = []
    for n, idx, row_lens in groups:
        take = len(idx)
        coef8 = np.ascontiguousarray(coef[idx])
        if row_lens is None:
            fn = (
                lib.sla_predict_stage1_rows16_at
                if take == 16
                else lib.sla_predict_stage1_rows8_at
            )
            off8 = np.ascontiguousarray(offs[idx])
            i0 = idx[0]
            if n == L and idx == list(range(i0, i0 + take)):

                def run(fn=fn, off8=off8, i0=i0, n=n, coef8=coef8):
                    fn(base_ptr, off8.ctypes.data_as(p_i64),
                       _i32ptr(out[i0:]), n, _i32ptr(coef8), p)

            else:

                def run(fn=fn, off8=off8, idx=idx, n=n, coef8=coef8,
                        take=take):
                    out8 = np.empty((take, n), dtype=np.int32)
                    fn(base_ptr, off8.ctypes.data_as(p_i64),
                       _i32ptr(out8), n, _i32ptr(coef8), p)
                    out[idx, :n] = out8

        else:
            # mixed lengths: gather with zero pad, exactly like the
            # batch wrapper (outputs past a row's length are discarded)
            fn = (
                lib.sla_predict_stage1_rows16
                if take == 16
                else lib.sla_predict_stage1_rows8
            )
            in8 = np.zeros((take, n), dtype=np.int32)
            flat = base.reshape(-1)
            for i, (b, nb) in enumerate(zip(idx, row_lens)):
                in8[i, :nb] = flat[offs[b] : offs[b] + nb]

            def run(fn=fn, idx=idx, n=n, in8=in8, coef8=coef8,
                    row_lens=row_lens):
                out8 = np.empty_like(in8)
                fn(_i32ptr(in8), _i32ptr(out8), n, _i32ptr(coef8), p)
                for i, (b, nb) in enumerate(zip(idx, row_lens)):
                    out[b, :nb] = out8[i, :nb]

        jobs.append(run)
    for n, b in singles:

        def run(b=b, n=n):
            row = np.empty(n, dtype=np.int32)
            lib.sla_predict_stage1(
                row_ptr(offs[b]), _i32ptr(row), n, _i32ptr(coef[b]), p
            )
            out[b, :n] = row

        jobs.append(run)
    _run_jobs(jobs)
    return out


def predict_stage2_rows(
    residual: np.ndarray,
    pitch: np.ndarray,
    ltm_coef: np.ndarray,
    num_taps: int,
    lms_order: int,
    lengths: np.ndarray | None = None,
) -> np.ndarray:
    """Host long-term + LMS predict over a (B, L) batch, row-serial.

    Equal-length rows run sixteen (AVX-512 lanes) or eight at a time
    through the interleaved SIMD cascade, like synth_rows."""
    lib = _load()
    if lms_order > 64 or num_taps > 8:  # native scratch bounds: every
        # stage-2/synth kernel rejects num_taps > 8 (sla_native.cpp:4957)
        raise ValueError(
            f"predict_stage2_rows: order out of native scratch range "
            f"(lms={lms_order}, taps={num_taps})")
    residual = np.ascontiguousarray(residual, dtype=np.int32)
    B, L = residual.shape
    # empty, not zeros: every consumed (row, :length) region is written by
    # a kernel below; zero-length rows are never read back
    out = np.empty_like(residual)
    ltm = np.ascontiguousarray(ltm_coef, dtype=np.int32)
    lens = (
        np.asarray(lengths, dtype=np.int64)
        if lengths is not None
        else np.full(B, L, dtype=np.int64)
    )
    groups, singles = _row_groups(lens)
    jobs = []
    for n, idx, row_lens in groups:
        take = len(idx)
        fn = (
            lib.sla_predict_stage2_rows16
            if take == 16
            else lib.sla_predict_stage2_rows8
        )
        i0 = idx[0]
        pit8 = np.ascontiguousarray(pitch[idx].astype(np.int32))
        ltm8 = np.ascontiguousarray(ltm[idx])
        if row_lens is None and n == L and idx == list(range(i0, i0 + take)):

            def run(fn=fn, i0=i0, n=n, pit8=pit8, ltm8=ltm8):
                _ck(fn(
                    _i32ptr(residual[i0:]), _i32ptr(out[i0:]), n,
                    _i32ptr(pit8), _i32ptr(ltm8), num_taps, lms_order,
                ), "predict_stage2_rows")

        elif row_lens is None:
            in8 = np.ascontiguousarray(residual[idx, :n])

            def run(fn=fn, idx=idx, n=n, in8=in8, pit8=pit8, ltm8=ltm8):
                out8 = np.empty_like(in8)
                _ck(fn(
                    _i32ptr(in8), _i32ptr(out8), n, _i32ptr(pit8),
                    _i32ptr(ltm8), num_taps, lms_order,
                ), "predict_stage2_rows")
                out[idx, :n] = out8

        else:
            in8 = np.zeros((take, n), dtype=np.int32)
            for i, (b, nb) in enumerate(zip(idx, row_lens)):
                in8[i, :nb] = residual[b, :nb]

            def run(fn=fn, idx=idx, n=n, in8=in8, pit8=pit8, ltm8=ltm8,
                    row_lens=row_lens):
                out8 = np.empty_like(in8)
                _ck(fn(
                    _i32ptr(in8), _i32ptr(out8), n, _i32ptr(pit8),
                    _i32ptr(ltm8), num_taps, lms_order,
                ), "predict_stage2_rows")
                for i, (b, nb) in enumerate(zip(idx, row_lens)):
                    out[b, :nb] = out8[i, :nb]

        jobs.append(run)
    for n, b in singles:

        def run(b=b, n=n):
            row = np.empty(n, dtype=np.int32)
            _ck(lib.sla_predict_stage2(
                _i32ptr(residual[b]), _i32ptr(row), n, int(pitch[b]),
                _i32ptr(ltm[b]), num_taps, lms_order,
            ), "predict_stage2")
            out[b, :n] = row

        jobs.append(run)
    _run_jobs(jobs)
    return out


def synth_rows(
    residual: np.ndarray,
    parcor_coef: np.ndarray,
    pitch: np.ndarray,
    ltm_coef: np.ndarray,
    num_taps: int,
    lms_order: int,
    lengths: np.ndarray | None = None,
) -> np.ndarray:
    """Host decode-side cascade over a (B, L) batch (LMS -> long-term ->
    lattice -> de-emphasis); inverse of predict_rows.

    Equal-length rows run eight at a time through the interleaved SIMD
    cascade; stragglers use the resumable single-row path."""
    lib = _load()
    if parcor_coef.shape[1] > 64 or lms_order > 64 or num_taps > 8:
        raise ValueError("synth_rows: order out of native scratch range")
    residual = np.ascontiguousarray(residual, dtype=np.int32)
    B, L = residual.shape
    p = parcor_coef.shape[1]
    M = lms_order
    # empty, not zeros: every consumed (row, :length) region is written by
    # a kernel below; zero-length rows are never read back
    out = np.empty_like(residual)
    coef = np.ascontiguousarray(parcor_coef, dtype=np.int32)
    ltm = np.ascontiguousarray(ltm_coef, dtype=np.int32)
    lens = (
        np.asarray(lengths, dtype=np.int64)
        if lengths is not None
        else np.full(B, L, dtype=np.int64)
    )

    groups, singles = _row_groups(lens)
    jobs = []
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    for n, idx, row_lens in groups:
        take = len(idx)
        fn = lib.sla_synth_rows16 if take == 16 else lib.sla_synth_rows8
        i0 = idx[0]
        coef8 = np.ascontiguousarray(coef[idx])
        pit8 = np.ascontiguousarray(pitch[idx].astype(np.int32))
        ltm8 = np.ascontiguousarray(ltm[idx])
        if row_lens is None and n == L and idx == list(range(i0, i0 + take)):
            # consecutive full-width group: views straight through

            def run(fn=fn, i0=i0, n=n, coef8=coef8, pit8=pit8, ltm8=ltm8):
                _ck(fn(
                    _i32ptr(residual[i0:]), _i32ptr(out[i0:]), n,
                    _i32ptr(coef8), p, _i32ptr(pit8), _i32ptr(ltm8),
                    num_taps, M,
                ), "synth_rows")

        elif row_lens is None and p > 0 and len(set(idx)) == take:
            # non-consecutive exact group: row-pointer kernel reads the
            # batch rows in place and writes the out rows in place — no
            # pack/scatter copies (duplicated padded lanes and p == 0
            # keep the copy path: see synth_rows_fused)
            fa = lib.sla_synth_rows16_at if take == 16 else lib.sla_synth_rows8_at
            roffs = np.asarray(idx, dtype=np.int64) * L

            def run(fa=fa, n=n, coef8=coef8, pit8=pit8, ltm8=ltm8,
                    roffs=roffs):
                rp = roffs.ctypes.data_as(p_i64)
                _ck(fa(
                    _i32ptr(residual), rp, _i32ptr(out), rp, n,
                    _i32ptr(coef8), p, _i32ptr(pit8), _i32ptr(ltm8),
                    num_taps, M,
                ), "synth_rows")

        elif row_lens is None:
            res8 = np.ascontiguousarray(residual[idx, :n])

            def run(fn=fn, idx=idx, n=n, res8=res8, coef8=coef8,
                    pit8=pit8, ltm8=ltm8):
                out8 = np.empty_like(res8)
                _ck(fn(
                    _i32ptr(res8), _i32ptr(out8), n, _i32ptr(coef8), p,
                    _i32ptr(pit8), _i32ptr(ltm8), num_taps, M,
                ), "synth_rows")
                out[idx, :n] = out8

        else:
            res8 = np.zeros((take, n), dtype=np.int32)
            for i, (b, nb) in enumerate(zip(idx, row_lens)):
                res8[i, :nb] = residual[b, :nb]

            def run(fn=fn, idx=idx, n=n, res8=res8, coef8=coef8,
                    pit8=pit8, ltm8=ltm8, row_lens=row_lens):
                out8 = np.empty_like(res8)
                _ck(fn(
                    _i32ptr(res8), _i32ptr(out8), n, _i32ptr(coef8), p,
                    _i32ptr(pit8), _i32ptr(ltm8), num_taps, M,
                ), "synth_rows")
                for i, (b, nb) in enumerate(zip(idx, row_lens)):
                    out[b, :nb] = out8[i, :nb]

        jobs.append(run)
    for n, b in singles:
        lat = np.zeros(p + 1, np.int32)
        hist = np.zeros(_LT_HIST_LEN, np.int32)
        ltp = np.zeros(1, np.int32)
        lms = np.zeros(4 * M, np.int32)
        lmsp = np.zeros(1, np.int32)
        de = np.zeros(1, np.int32)
        out[b, :n] = synth_chunk(
            residual[b, :n], coef[b], lat, int(pitch[b]), ltm[b], num_taps,
            hist, ltp, M, lms, lmsp, de,
        )
    _run_jobs(jobs)
    return out


def synth_rows_fused(
    residual: np.ndarray,
    parcor_coef: np.ndarray,
    pitch: np.ndarray,
    ltm_coef: np.ndarray,
    num_taps: int,
    lms_order: int,
    lengths: np.ndarray,
    dest: np.ndarray,
    dest_offs: np.ndarray,
    ms: bool,
    shift: int,
) -> None:
    """Decode-side cascade over a (B, L) batch with the OUTPUT fused:
    each finished lane group stores straight into the (C, N) PCM buffer
    `dest` at per-row element offsets `dest_offs`, with the mid/side
    inverse (rows pair even=mid / odd=side) and the final left shift
    applied in registers — the whole-batch ms_shift pass disappears.
    CLOBBERS `residual` (it is the work buffer). Values are identical to
    synth_rows followed by MS inverse + shift.

    Mixed-length lane groups and singles synthesize in place and scatter
    via NumPy (a masked fused store past a short row's length would
    clobber the next block's PCM region); requires parcor_order > 0."""
    lib = _load()
    if parcor_coef.shape[1] > 64 or lms_order > 64 or num_taps > 8:
        raise ValueError("synth_rows_fused: order out of native scratch range")
    if residual.dtype != np.int32 or not residual.flags.c_contiguous:
        raise ValueError("synth_rows_fused: need C-contiguous int32 residual")
    B, L = residual.shape
    p = parcor_coef.shape[1]
    if p <= 0:
        raise ValueError("synth_rows_fused requires parcor_order > 0")
    M = lms_order
    coef = np.ascontiguousarray(parcor_coef, dtype=np.int32)
    ltm = np.ascontiguousarray(ltm_coef, dtype=np.int32)
    lens = np.asarray(lengths, dtype=np.int64)
    doffs = np.asarray(dest_offs, dtype=np.int64)
    dest_ptr = _i32ptr(dest)
    dest_flat = dest.reshape(-1)
    p_i64 = ctypes.POINTER(ctypes.c_int64)

    groups, singles = _row_groups(lens)
    jobs = []
    leftover_rows: list[tuple[int, int]] = []  # (row, length)
    for n, idx, row_lens in groups:
        take = len(idx)
        i0 = idx[0]
        # MS pairing: lanes (2i, 2i+1) must be one block's (mid, side)
        # rows — true by construction (C == 2 rows enter the length
        # buckets together and group sizes are even), verified anyway
        pair_ok = (not ms) or all(
            idx[k] % 2 == 0 and idx[k + 1] == idx[k] + 1
            for k in range(0, take, 2)
        )
        # duplicate row indices (the padded tail group) cannot run in
        # place: the per-row long-term pass would filter the shared row
        # once per lane — those keep the pack+copy path below
        uniq = len(set(idx)) == take
        if row_lens is None and pair_ok and uniq:
            # row-pointer kernel straight over the (B, L) batch rows: no
            # pack/scatter copies for non-consecutive groups (the common
            # case once the optimal partition mixes block sizes)
            fn = (lib.sla_synth_rows16_out_at if take == 16
                  else lib.sla_synth_rows8_out_at)
            coef8 = np.ascontiguousarray(coef[idx])
            pit8 = np.ascontiguousarray(pitch[idx].astype(np.int32))
            ltm8 = np.ascontiguousarray(ltm[idx])
            off8 = np.ascontiguousarray(doffs[idx])
            roffs = np.asarray(idx, dtype=np.int64) * L

            def run(fn=fn, n=n, coef8=coef8, pit8=pit8, ltm8=ltm8,
                    off8=off8, roffs=roffs):
                _ck(fn(_i32ptr(residual), roffs.ctypes.data_as(p_i64), n,
                       _i32ptr(coef8), p, _i32ptr(pit8), _i32ptr(ltm8),
                       num_taps, M, dest_ptr, off8.ctypes.data_as(p_i64),
                       1 if ms else 0, int(shift)), "synth_rows_fused")

            jobs.append(run)
            continue
        coef8 = np.ascontiguousarray(coef[idx])
        pit8 = np.ascontiguousarray(pitch[idx].astype(np.int32))
        ltm8 = np.ascontiguousarray(ltm[idx])
        rl = row_lens if row_lens is not None else [n] * take
        if uniq:
            # mixed-length (or unpairable) group: in-place row-pointer
            # synthesis to the group max, then the NumPy leftover scatter
            # below lands each row's true length. Short rows' tail columns
            # zero-fill first (the kernel reads to n; columns past a row's
            # length are np.empty garbage otherwise — outputs there are
            # discarded, but keep the reads defined)
            fn = lib.sla_synth_rows16_at if take == 16 else lib.sla_synth_rows8_at
            for b, nb in zip(idx, rl):
                if nb < n:
                    residual[b, nb:n] = 0
            roffs = np.asarray(idx, dtype=np.int64) * L

            def run(fn=fn, n=n, coef8=coef8, pit8=pit8, ltm8=ltm8,
                    roffs=roffs):
                rp = roffs.ctypes.data_as(p_i64)
                _ck(fn(_i32ptr(residual), rp, _i32ptr(residual), rp, n,
                       _i32ptr(coef8), p, _i32ptr(pit8), _i32ptr(ltm8),
                       num_taps, M), "synth_rows_fused")

        else:
            # duplicated lanes: pack copies (each lane gets its own row)
            fn = lib.sla_synth_rows16 if take == 16 else lib.sla_synth_rows8
            res8 = np.zeros((take, n), dtype=np.int32)
            for i, (b, nb) in enumerate(zip(idx, rl)):
                res8[i, :nb] = residual[b, :nb]

            def run(fn=fn, idx=idx, n=n, res8=res8, coef8=coef8, pit8=pit8,
                    ltm8=ltm8, rl=rl):
                out8 = np.empty_like(res8)
                _ck(fn(_i32ptr(res8), _i32ptr(out8), n, _i32ptr(coef8), p,
                       _i32ptr(pit8), _i32ptr(ltm8), num_taps, M),
                    "synth_rows_fused")
                for i, (b, nb) in enumerate(zip(idx, rl)):
                    residual[b, :nb] = out8[i, :nb]

        jobs.append(run)
        leftover_rows.extend((b, nb) for b, nb in zip(idx, rl))
    for n, b in singles:
        lat = np.zeros(p + 1, np.int32)
        hist = np.zeros(_LT_HIST_LEN, np.int32)
        ltp = np.zeros(1, np.int32)
        lms = np.zeros(4 * M, np.int32)
        lmsp = np.zeros(1, np.int32)
        de = np.zeros(1, np.int32)
        residual[b, :n] = synth_chunk(
            residual[b, :n].copy(), coef[b], lat, int(pitch[b]), ltm[b],
            num_taps, hist, ltp, M, lms, lmsp, de,
        )
        leftover_rows.append((b, n))
    _run_jobs(jobs)
    # scatter the leftovers (rare): NumPy MS inverse + shift per pair/row
    if leftover_rows:
        from ..dsp.channel import ms_to_lr_int32

        done = set()
        for b, nb in leftover_rows:
            if b in done:
                continue
            if ms:
                mb = b & ~1  # the pair's mid row
                left, right = ms_to_lr_int32(
                    residual[mb, :nb], residual[mb + 1, :nb]
                )
                with np.errstate(over="ignore"):
                    dest_flat[doffs[mb] : doffs[mb] + nb] = left << np.int32(shift)
                    dest_flat[doffs[mb + 1] : doffs[mb + 1] + nb] = (
                        right << np.int32(shift)
                    )
                done.update((mb, mb + 1))
            else:
                with np.errstate(over="ignore"):
                    dest_flat[doffs[b] : doffs[b] + nb] = (
                        residual[b, :nb] << np.int32(shift)
                    )
                done.add(b)


def synth_chunk(
    residual: np.ndarray,
    parcor_coef: np.ndarray,
    lattice_state: np.ndarray,
    pitch: int,
    ltm_coef: np.ndarray,
    num_taps: int,
    lt_hist: np.ndarray,
    lt_processed: np.ndarray,
    lms_order: int,
    lms_state: np.ndarray,
    lms_processed: np.ndarray,
    deemph_prev: np.ndarray,
) -> np.ndarray:
    """Incremental synthesis of one channel chunk; mutates the state arrays.

    residual: (n,) int32; parcor_coef: (p,) orders 1..p; lattice_state:
    (p+1,); lt_hist: ring with newest at the end; lms_state: (4*M,) packed
    fc|ic|xb|pb; lt_processed/lms_processed/deemph_prev: (1,) int32.
    """
    lib = _load()
    residual = np.ascontiguousarray(residual, dtype=np.int32)
    out = np.empty_like(residual)
    _ck(lib.sla_synth_chunk(
        _i32ptr(residual), _i32ptr(out), residual.size,
        _i32ptr(parcor_coef), parcor_coef.size, _i32ptr(lattice_state),
        pitch, _i32ptr(ltm_coef), num_taps,
        _i32ptr(lt_hist), lt_hist.size, _i32ptr(lt_processed),
        lms_order, _i32ptr(lms_state), _i32ptr(lms_processed),
        _i32ptr(deemph_prev),
    ), "synth_chunk")
    return out


def synth_chunk_rows(
    residual: np.ndarray,
    parcor_coef: np.ndarray,
    lattice_state: np.ndarray,
    pitch: np.ndarray,
    ltm_coef: np.ndarray,
    num_taps: int,
    lt_hist: np.ndarray,
    lt_processed: np.ndarray,
    lms_order: int,
    lms_state: np.ndarray,
    lms_processed: np.ndarray,
    deemph_prev: np.ndarray,
    ms: bool = False,
    shift: int = 0,
) -> np.ndarray:
    """Streaming-tick synthesis of ALL channels in ONE native call, with the
    mid/side inverse and final left shift fused in (the per-channel variant
    above costs ~10 ctypes casts per call, which dominates 120 Hz ticks).

    residual: (C, n) int32; parcor_coef: (C, p) orders 1..p; stacked state
    arrays as _reset_filter_state lays them out. Mutates the states."""
    lib = _load()
    residual = np.ascontiguousarray(residual, dtype=np.int32)
    C, n = residual.shape
    out = np.empty_like(residual)
    coef = np.ascontiguousarray(parcor_coef, dtype=np.int32)
    ltm = np.ascontiguousarray(ltm_coef, dtype=np.int32)
    rc = int(
        lib.sla_synth_chunk_rows(
            _i32ptr(residual), _i32ptr(out), C, n,
            _i32ptr(coef), coef.shape[1], coef.shape[1],
            _i32ptr(lattice_state),
            _i32ptr(np.ascontiguousarray(pitch, dtype=np.int32)),
            _i32ptr(ltm), ltm.shape[1], num_taps,
            _i32ptr(lt_hist), lt_hist.shape[1], _i32ptr(lt_processed),
            lms_order, _i32ptr(lms_state), _i32ptr(lms_processed),
            _i32ptr(deemph_prev), 1 if ms else 0, int(shift),
        )
    )
    if rc != 0:
        raise ValueError(f"synth_chunk_rows: invalid geometry (rc={rc})")
    return out


class StreamTick:
    """Per-block prebound fused decode tick for the streaming decoder.

    All cursor/state/coefficient pointers are captured once at block start,
    so the 120 Hz hot path costs ONE FFI call (sla_stream_tick: entropy read
    + underrun check with native cursor rollback + all-channel synthesis +
    MS inverse + shift) instead of ~12 ctypes pointer casts, a residual
    round-trip, and a 7-array Python-side snapshot per tick. Arrays must be
    contiguous int32 in the _reset_filter_state layout; the instance keeps
    references so the buffers outlive the bound pointers."""

    def __init__(self, cursor: PayloadCursor,
                 parcor_coef, lattice_state, pitch, ltm_coef, num_taps,
                 lt_hist, lt_processed, lms_order, lms_state, lms_processed,
                 deemph_prev, ms, shift):
        lib = _load()
        self._fn = lib.sla_stream_tick_packed
        self._fn_strided = lib.sla_stream_tick_strided
        coef = np.ascontiguousarray(parcor_coef, dtype=np.int32)
        pit = np.ascontiguousarray(pitch, dtype=np.int32)
        ltm = np.ascontiguousarray(ltm_coef, dtype=np.int32)
        self._scratch = np.empty(0, dtype=np.int32)
        self._scratch_n = 0
        self._keep = (coef, pit, ltm, lattice_state, lt_hist, lt_processed,
                      lms_state, lms_processed, deemph_prev, cursor)
        self.C = int(lattice_state.shape[0])
        # one int64 argument block: ctypes marshals ONE pointer per 120 Hz
        # tick instead of 27 arguments (~18 us -> ~1.5 us measured).
        # Slots 27 (synth scratch) / 28 (out row stride) serve the strided
        # variant only.
        a = np.zeros(29, dtype=np.int64)
        a[2] = ctypes.addressof(cursor.bit_pos)
        a[3] = cursor.param_state.ctypes.data
        a[4] = cursor.eff_params.ctypes.data
        a[5] = cursor.use_golomb
        a[8] = self.C
        a[10] = coef.ctypes.data
        a[11] = coef.shape[1]
        a[12] = coef.shape[1]
        a[13] = lattice_state.ctypes.data
        a[14] = pit.ctypes.data
        a[15] = ltm.ctypes.data
        a[16] = ltm.shape[1]
        a[17] = int(num_taps)
        a[18] = lt_hist.ctypes.data
        a[19] = lt_hist.shape[1]
        a[20] = lt_processed.ctypes.data
        a[21] = int(lms_order)
        a[22] = lms_state.ctypes.data
        a[23] = lms_processed.ctypes.data
        a[24] = deemph_prev.ctypes.data
        a[25] = 1 if ms else 0
        a[26] = int(shift)
        self._args = a
        self._args_ptr = a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        # zero-copy int64 view of the cursor position (ctypes .value
        # attribute access is several times costlier per tick)
        self.bit_pos_view = np.frombuffer(cursor.bit_pos, dtype=np.int64)

    def set_use_golomb(self, v: int) -> None:
        """Per-block rebind: the one argument-block slot that changes when
        the bound cursor is reinit()ed for a new block."""
        self._args[5] = v

    def run(self, buf: np.ndarray, out: np.ndarray) -> int:
        """One fused tick: read C*n symbols from the uint8 feed-buffer view
        `buf` at the bound cursor, synthesize into the contiguous (C, n)
        int32 `out`, mutating the bound states. Returns 0, or 1 on underrun
        (cursor rolled back, filter state untouched — feed and retry)."""
        return self.run_ptr(buf.ctypes.data, buf.size, out)

    def run_ptr(self, buf_ptr: int, buf_len: int, out: np.ndarray) -> int:
        """run() with the feed buffer passed as a raw (pointer, length):
        the streaming decoder's preallocated buffer never moves, so the
        120 Hz path skips the per-call `.ctypes` adapter construction."""
        return self.run_fast(buf_ptr, buf_len, out.ctypes.data, out.shape[1])

    def _grow_scratch(self, n: int) -> None:
        # one block: [0, C*n) residual scratch, [C*n, 2*C*n) synthesis
        # scratch for the strided landing variant
        self._scratch = np.empty(2 * self.C * n, dtype=np.int32)
        self._scratch_n = n
        self._args[6] = self._scratch.ctypes.data
        self._args[27] = self._args[6] + 4 * self.C * n

    def run_fast(self, buf_ptr: int, buf_len: int, out_ptr: int, n: int) -> int:
        """Fully raw-pointer tick: both buffers as (pointer, length) the
        caller has validated/cached — the hot 120 Hz path."""
        if self._scratch_n < n:
            self._grow_scratch(n)
        a = self._args
        a[0] = buf_ptr
        a[1] = buf_len
        a[7] = out_ptr
        a[9] = n
        rc = self._fn(self._args_ptr)
        if rc not in (0, 1):
            raise ValueError(f"stream tick: invalid geometry (rc={rc})")
        return rc

    def run_strided(
        self, buf_ptr: int, buf_len: int, out_ptr: int, n: int, out_stride: int
    ) -> int:
        """run_fast landing the (C, n) result at row stride `out_stride`
        int32 elements — the decode_into(out, offset) hot path."""
        if self._scratch_n < n:
            self._grow_scratch(n)
        a = self._args
        a[0] = buf_ptr
        a[1] = buf_len
        a[7] = out_ptr
        a[9] = n
        a[28] = out_stride
        rc = self._fn_strided(self._args_ptr)
        if rc not in (0, 1):
            raise ValueError(f"stream tick: invalid geometry (rc={rc})")
        return rc


def convert_ms(
    data: np.ndarray,
    shift_a: int,
    shift_b: int | None = None,
    want_double: bool = True,
    ms: bool = False,
) -> tuple[np.ndarray, np.ndarray | None, np.ndarray | None]:
    """Fused whole-file conversion: (data >> shift_a) int32, optionally
    (data >> shift_b) int32, optionally float64 * 2^-31 — each mid/side
    transformed when `ms`. One pass over the source (SLAEncoder.c:381-390,
    :505-512). Returns (out_a, out_b, out_d); out_b is None when shift_b is
    None or equals shift_a (caller reuses out_a — all consumers are
    read-only)."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.int32)
    C, N = data.shape
    out_a = np.empty((C, N), dtype=np.int32)
    need_b = shift_b is not None and shift_b != shift_a
    out_b = np.empty((C, N), dtype=np.int32) if need_b else None
    out_d = np.empty((C, N), dtype=np.float64) if want_double else None
    rc = lib.sla_convert_ms(
        _i32ptr(data),
        C,
        N,
        int(shift_a),
        _i32ptr(out_a),
        int(shift_b) if need_b else 0,
        _i32ptr(out_b) if need_b else None,
        _f64ptr(out_d) if want_double else None,
        1 if ms else 0,
    )
    if rc != 0:
        raise ValueError("convert_ms: mid/side requires exactly 2 channels")
    return out_a, out_b, out_d


def span_autocorr(
    data: np.ndarray, positions: np.ndarray, spans: np.ndarray, order: int
) -> np.ndarray:
    """Partition-search span autocorrelations: data (C, N) float64,
    positions (V,), spans (S, 2) -> (S, C, order+1)."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.float64)
    C, N = data.shape
    pos = np.ascontiguousarray(positions, dtype=np.int64)
    sp = np.ascontiguousarray(spans, dtype=np.int64)
    S = sp.shape[0]
    out = np.empty((S, C, order + 1), dtype=np.float64)
    rc = int(
        lib.sla_span_autocorr(
            _f64ptr(data), C, N,
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), pos.size,
            sp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), S, order, _f64ptr(out),
        )
    )
    if rc != 0:
        raise ValueError(f"span_autocorr: too many spans for native scratch ({S})")
    return out


def span_autocorr_multi(
    data: np.ndarray,
    win_offsets: np.ndarray,
    win_len: int,
    positions: np.ndarray,
    spans: np.ndarray,
    order: int,
) -> np.ndarray:
    """span_autocorr over W same-geometry windows of one (C, N) base
    signal in a single call (per-lag boundary sort and span index lookups
    amortized across windows). Returns (W, S, C, order+1).

    For order <= 19 the one-pass FMA kernel runs: values differ from
    per-window span_autocorr only by float association (~1e-16 relative)
    — this is the fast partition estimator, whose rounding headroom the
    0.25-byte near-tie exact-reprice margin covers by ~10 orders (see
    analysis/partition.py). Higher orders use the per-lag kernel, whose
    values match per-window calls bit for bit."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.float64)
    C, N = data.shape
    off = np.ascontiguousarray(win_offsets, dtype=np.int64)
    pos = np.ascontiguousarray(positions, dtype=np.int64)
    sp = np.ascontiguousarray(spans, dtype=np.int64)
    W, S = off.size, sp.shape[0]
    out = np.empty((W, S, C, order + 1), dtype=np.float64)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    # one sweep accumulating all lags beats the per-lag passes while the
    # striped accumulators stay in registers (17 zmm at order 16); higher
    # orders spill and take the per-lag variant. Values differ between the
    # two only by float association, far inside the near-tie margin.
    fn = (
        lib.sla_span_autocorr_multi_onepass
        if order <= 19
        else lib.sla_span_autocorr_multi
    )
    rc = int(
        fn(
            _f64ptr(data), C, N,
            off.ctypes.data_as(p_i64), W, int(win_len),
            pos.ctypes.data_as(p_i64), pos.size,
            sp.ctypes.data_as(p_i64), S, order, _f64ptr(out),
        )
    )
    if rc != 0:
        raise ValueError(f"span_autocorr_multi: scratch bound exceeded ({S})")
    return out


def span_autocorr_multi_i32(
    data_int32: np.ndarray,
    ms: bool,
    win_offsets: np.ndarray,
    win_len: int,
    positions: np.ndarray,
    spans: np.ndarray,
    order: int,
) -> np.ndarray:
    """span_autocorr_multi reading the ORIGINAL (C, N) canonical int32
    signal: each (window, channel) row converts to float64 on the fly with
    exactly convert_ms's arithmetic (every step exact), so the sums are
    bit-identical to a materialized-double call while the whole-file
    8-byte/sample array never exists. data_int32 rows may be strided
    (segmented-encode views) — the channel stride passes through."""
    lib = _load()
    if data_int32.dtype != np.int32 or data_int32.strides[1] != 4:
        data_int32 = np.ascontiguousarray(data_int32, dtype=np.int32)
    C = data_int32.shape[0]
    cstride = data_int32.strides[0] // 4
    off = np.ascontiguousarray(win_offsets, dtype=np.int64)
    pos = np.ascontiguousarray(positions, dtype=np.int64)
    sp = np.ascontiguousarray(spans, dtype=np.int64)
    W, S = off.size, sp.shape[0]
    out = np.empty((W, S, C, order + 1), dtype=np.float64)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    fn = (
        lib.sla_span_autocorr_multi_onepass_i32
        if order <= 19
        else lib.sla_span_autocorr_multi_i32
    )
    rc = int(
        fn(
            _i32ptr(data_int32), cstride, 1 if ms else 0, C,
            off.ctypes.data_as(p_i64), W, int(win_len),
            pos.ctypes.data_as(p_i64), pos.size,
            sp.ctypes.data_as(p_i64), S, order, _f64ptr(out),
        )
    )
    if rc != 0:
        raise ValueError(f"span_autocorr_multi_i32: invalid geometry ({S})")
    return out


def span_cost(
    R: np.ndarray, span_len: np.ndarray, order: int, bits_per_sample: int,
    with_sens: bool = False,
):
    """Partition fast-path edge costs (code bytes before header/penalty):
    Levinson-Durbin + Laplace code-length estimate per (span, channel),
    summed over channels. R: (S, C, order+1) float64; span_len: (S,).

    with_sens=True additionally returns (sens, e_p), each (S, C) — the
    envelope-theorem gradient scale and final prediction-error energy that
    feed partition.span_cost_error_bound without a second Levinson pass."""
    lib = _load()
    R = np.ascontiguousarray(R, dtype=np.float64)
    S, C, _ = R.shape
    lens = np.ascontiguousarray(span_len, dtype=np.float64)
    out = np.empty(S, dtype=np.float64)
    sens = np.empty((S, C), dtype=np.float64) if with_sens else None
    e_p = np.empty((S, C), dtype=np.float64) if with_sens else None
    rc = int(
        lib.sla_span_cost(
            _f64ptr(R), _f64ptr(lens), S, C, order, bits_per_sample, _f64ptr(out),
            _f64ptr(sens) if with_sens else None,
            _f64ptr(e_p) if with_sens else None,
        )
    )
    if rc != 0:
        raise ValueError(f"span_cost: order out of native scratch range ({order})")
    if with_sens:
        return out, sens, e_p
    return out


def encode_blocks(
    num_samples: np.ndarray,
    block_types: np.ndarray,
    parcor_order: int,
    num_taps: int,
    bits_per_sample: int,
    pitch_threshold: int,
    parcor_code: np.ndarray,
    parcor_rshift: np.ndarray,
    pitch: np.ndarray,
    ltm_coef: np.ndarray,
    init_rice: np.ndarray,
    residual_rows: list[np.ndarray],
    raw_bits,
    prefix_reserve: int = 0,
) -> tuple[bytes, np.ndarray]:
    """Serialize every block of a stream in ONE native call.

    residual_rows: per-block (C, n_b) int32 arrays (row views into the
    batch filter output are fine — base pointer + row stride pass through,
    no gather copies). Returns (whole stream payload bytes, per-block byte
    sizes). Grows the output buffer and retries on overflow.

    With prefix_reserve > 0 the payload starts that many bytes into the
    returned array and the first element of the tuple is a uint8 VIEW into
    a persistent scratch buffer (prefix bytes uninitialized, for the
    caller's header) — consume it before the next call. The persistent
    buffer exists either way: on this host first-touch page faults on a
    fresh ~20 MB output run ~5 us/4 KB, so reallocating per call costs
    more than the serialization itself on early runs."""
    lib = _load()
    W = len(residual_rows)
    C = int(parcor_code.shape[1])
    nsamp = np.ascontiguousarray(num_samples, dtype=np.int32)
    btype = np.ascontiguousarray(block_types, dtype=np.int32)
    code = np.ascontiguousarray(parcor_code, dtype=np.int32)
    rshift = np.ascontiguousarray(parcor_rshift, dtype=np.int32)
    pit = np.ascontiguousarray(pitch, dtype=np.int32)
    ltm = np.ascontiguousarray(ltm_coef, dtype=np.int32)
    ir = np.ascontiguousarray(init_rice, dtype=np.uint32)
    rb = np.ascontiguousarray(raw_bits, dtype=np.int32)
    ptrs = np.empty(W, dtype=np.uint64)
    strides = np.empty(W, dtype=np.int64)
    keep = []  # hold row buffers alive across the call
    for b, rows in enumerate(residual_rows):
        if rows.strides[1] != 4 or rows.strides[0] % 4:
            rows = np.ascontiguousarray(rows, dtype=np.int32)
        keep.append(rows)
        ptrs[b] = rows.ctypes.data
        strides[b] = rows.strides[0] // 4
    sizes = np.empty(W, dtype=np.int64)
    # 2x the PCM bytes plus per-block headroom covers even raw fallbacks;
    # grow-and-retry handles adversarial expansions
    cap = int(2 * 4 * C * int(nsamp.sum(dtype=np.int64)) + 4096 * W + 4096)
    p_u64 = ctypes.POINTER(ctypes.c_uint64)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    while True:
        out = _scratch_u8(prefix_reserve + cap)
        pay = out[prefix_reserve:]
        n = int(
            lib.sla_encode_blocks(
                W, C, parcor_order, num_taps, bits_per_sample, pitch_threshold,
                _i32ptr(nsamp), _i32ptr(btype), _i32ptr(code), _i32ptr(rshift),
                _i32ptr(pit), _i32ptr(ltm), _u32ptr(ir),
                ptrs.ctypes.data_as(p_u64), strides.ctypes.data_as(p_i64),
                _i32ptr(rb), _u8ptr(pay), cap, sizes.ctypes.data_as(p_i64),
            )
        )
        if n >= 0:
            del keep
            if prefix_reserve:
                return out[: prefix_reserve + n], sizes
            return pay[:n].tobytes(), sizes
        if n == -3:
            raise SLAError(
                ApiResult.INVALID_ARGUMENT,
                "pathological static-Golomb run (the reference would emit "
                "a multi-gigabit unary string here)",
            )
        if n == -2:
            raise ValueError(f"encode_blocks: too many channels for native scratch ({C})")
        cap *= 2


_eb_scratch = threading.local()


def _scratch_u8(size: int) -> np.ndarray:
    """Persistent grow-only uint8 scratch (per thread): repeated serialize
    calls reuse the same pages instead of first-touching a fresh multi-MB
    allocation each time."""
    buf = getattr(_eb_scratch, "buf", None)
    if buf is None or buf.size < size:
        buf = np.empty(size, dtype=np.uint8)
        _eb_scratch.buf = buf
    return buf


def encode_block(
    num_samples: int,
    block_type: int,
    parcor_order: int,
    num_taps: int,
    bits_per_sample: int,
    pitch_threshold: int,
    parcor_code: np.ndarray,
    parcor_rshift: np.ndarray,
    pitch: np.ndarray,
    ltm_coef: np.ndarray,
    init_rice,
    residual: np.ndarray,
    raw_bits=None,
) -> bytes:
    """Serialize one whole block (header fields + payload + CRC back-patch),
    the native twin of Encoder._encode_block_payload's framing."""
    lib = _load()
    residual = np.ascontiguousarray(residual, dtype=np.int32)
    C = residual.shape[0]
    code = np.ascontiguousarray(parcor_code, dtype=np.int32)
    rshift = np.ascontiguousarray(parcor_rshift, dtype=np.int32)
    pit = np.ascontiguousarray(pitch, dtype=np.int32)
    ltm = np.ascontiguousarray(ltm_coef, dtype=np.int32)
    ir = np.ascontiguousarray(init_rice, dtype=np.uint32)
    rb = np.ascontiguousarray(
        raw_bits if raw_bits is not None else np.zeros(C), dtype=np.int32
    )
    cap = 8 * residual.nbytes + 4096
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = int(
            lib.sla_encode_block(
                num_samples, block_type, C, parcor_order, num_taps,
                bits_per_sample, pitch_threshold,
                _i32ptr(code), _i32ptr(rshift), _i32ptr(pit), _i32ptr(ltm),
                _u32ptr(ir), _i32ptr(residual), _i32ptr(rb), _u8ptr(out), cap,
            )
        )
        if n >= 0:
            return out[:n].tobytes()
        if n == -3:
            raise SLAError(
                ApiResult.INVALID_ARGUMENT,
                "pathological static-Golomb run (the reference would emit "
                "a multi-gigabit unary string here)",
            )
        if n == -2:
            raise ValueError(f"encode_block: too many channels for native scratch ({C})")
        cap *= 2


def partition_solve(
    costs: np.ndarray,
    spans_cat: np.ndarray,
    span_counts: np.ndarray,
    num_nodes: np.ndarray,
    tie_eps: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Batched partition decisions: reference-tie-breaking Dijkstra + the
    near-tie slack guard for every window in one call.

    costs: concatenated edge costs; spans_cat: (S_total, 2) node pairs;
    span_counts/num_nodes: per window. Returns (hops (W, 32) node-deltas
    -1-terminated, needs_exact (W,) flags)."""
    lib = _load()
    costs = np.ascontiguousarray(costs, dtype=np.float64)
    spans_cat = np.ascontiguousarray(spans_cat, dtype=np.int64)
    counts = np.ascontiguousarray(span_counts, dtype=np.int32)
    nodes = np.ascontiguousarray(num_nodes, dtype=np.int32)
    W = counts.size
    hops = np.full((W, 32), -1, dtype=np.int32)
    needs = np.zeros(W, dtype=np.int32)
    rc = int(
        lib.sla_partition_solve(
            _f64ptr(costs), spans_cat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            _i32ptr(counts), _i32ptr(nodes), W, float(tie_eps),
            _i32ptr(hops), _i32ptr(needs),
        )
    )
    if rc == -3:
        raise ValueError("partition_solve: partition graph has no path to the goal")
    if rc != 0:
        raise ValueError("partition_solve: window exceeds native capacity")
    return hops, needs


def parse_block_headers(
    stream: bytes | memoryview,
    offset: int,
    total_samples: int,
    num_channels: int,
    parcor_order: int,
    num_taps: int,
    bits_per_sample: int,
    enable_crc: bool,
    max_block_samples: int = 0,
):
    """Bulk block-header walk. Returns a dict of per-block arrays, or raises
    SLAError-compatible codes via a (code) int in 'error'."""
    lib = _load()
    buf = np.frombuffer(stream, dtype=np.uint8)
    C = num_channels
    Tdim = max(num_taps, 1)
    p_i64c = ctypes.POINTER(ctypes.c_int64)
    # first guess: conformant encoders emit blocks of >= 2048 samples
    # (SLA_MIN_BLOCK_NUM_SAMPLES), so real streams fit; a crafted-but-valid
    # stream of many tiny blocks grows the arrays on the native -13 signal
    # (blocks have >= 1 sample, so total_samples + 1 slots always suffice)
    max_blocks = max(total_samples // 2048 + 2, 2)
    while True:
        offs = np.zeros(max_blocks, np.int64)
        sizes = np.zeros(max_blocks, np.int64)
        nsamp = np.zeros(max_blocks, np.int32)
        types = np.zeros(max_blocks, np.int32)
        payload_bits = np.zeros(max_blocks, np.int64)
        coef = np.zeros((max_blocks, C, parcor_order + 1), np.int32)
        pitch = np.zeros((max_blocks, C), np.int32)
        ltm = np.zeros((max_blocks, C, Tdim), np.int32)
        init_rice = np.zeros((max_blocks, C), np.uint32)
        nb = int(lib.sla_parse_block_headers(
            _u8ptr(buf), buf.size, offset, total_samples, C, parcor_order,
            num_taps, bits_per_sample, int(enable_crc),
            int(max_block_samples), max_blocks,
            offs.ctypes.data_as(p_i64c), sizes.ctypes.data_as(p_i64c),
            _i32ptr(nsamp), _i32ptr(types), payload_bits.ctypes.data_as(p_i64c),
            _i32ptr(coef), _i32ptr(pitch), _i32ptr(ltm), _u32ptr(init_rice),
        ))
        if nb == -13 and max_blocks <= total_samples:
            max_blocks = min(max_blocks * 8, total_samples + 1)
            continue
        break
    if nb == -13:  # slots exhausted even at the hard cap: corrupt counts
        return {"error": -11}
    if nb < 0:
        return {"error": nb}
    return {
        "error": 0, "num_blocks": nb, "offsets": offs[:nb], "sizes": sizes[:nb],
        "num_samples": nsamp[:nb], "types": types[:nb],
        "payload_bits": payload_bits[:nb], "coef": coef[:nb],
        "pitch": pitch[:nb], "ltm": ltm[:nb], "init_rice": init_rice[:nb],
    }


class StreamHeaderParser:
    """Prebound one-shot block-header parse for the streaming decoder's
    block transitions (sla_parse_stream_block_header): persistent output
    arrays the native parse writes into, one FFI call per block instead of
    ~50 Python-level BitReader reads. The arrays are REUSED across blocks —
    callers must consume (or copy) a block's fields before parsing the next.

    parse(buf_ptr, buf_len) returns 0 (fields valid), or the negative codes
    -12 (bad sync), -11 (corruption), -9 (header extends past the buffered
    bytes — feed more and retry)."""

    def __init__(self, num_channels: int, parcor_order: int, num_taps: int,
                 bits_per_sample: int, enable_crc: bool):
        lib = _load()
        self._fn = lib.sla_parse_stream_block_header
        C = num_channels
        self.meta = np.zeros(4, dtype=np.int64)  # size, nsamp, type, hdr_bytes
        self.coef = np.zeros((C, parcor_order + 1), dtype=np.int32)
        self.pitch = np.zeros(C, dtype=np.int32)
        self.ltm = np.zeros((C, max(num_taps, 1)), dtype=np.int32)
        self.init_rice = np.zeros(C, dtype=np.uint32)
        self._scalars = (C, parcor_order, num_taps, bits_per_sample,
                         1 if enable_crc else 0)
        self._ptrs = (
            self.meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            _i32ptr(self.coef), _i32ptr(self.pitch), _i32ptr(self.ltm),
            _u32ptr(self.init_rice),
        )

    def parse(self, buf_ptr: int, buf_len: int) -> int:
        return int(self._fn(buf_ptr, buf_len, *self._scalars, *self._ptrs))


def find_pitch(ac: np.ndarray, max_pitch: int) -> int:
    """Zero-crossing-bracketed peak search (pitch lag or 0)."""
    lib = _load()
    ac = np.ascontiguousarray(ac, dtype=np.float64)
    return int(lib.sla_find_pitch(_f64ptr(ac), max_pitch))


def lpc_analyze_rows(
    data: np.ndarray,
    order: int,
    bits_per_sample: int,
    window: np.ndarray | None = None,
    emphasis: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact-order LPC analysis per row (the reference's summation order —
    byte-identity depends on the last float64 ulp).

    data: (B, n) float64 rows. When `window`/`emphasis` are given, the
    windowing and double pre-emphasis (SLAEncoder.c:540-543) are fused into
    the native interleave fill — per-element arithmetic identical to
    applying them beforehand.
    Returns (parcor (B, order+1) float64, code length/sample (B,) float64)."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.float64)
    B, n = data.shape
    parcor = np.zeros((B, order + 1), dtype=np.float64)
    lengths = np.zeros((B,), dtype=np.float64)
    if not (1 <= order <= 64):
        raise ValueError(f"lpc_analyze_rows: order out of native scratch range ({order})")
    win_ptr = None
    if window is not None:
        window = np.ascontiguousarray(window, dtype=np.float64)
        win_ptr = _f64ptr(window)
    emph = 1 if emphasis else 0
    # one call: 8-row interleaved groups with a zero-padded tail, sharded
    # across worker threads on multi-core hosts (identical per-row values)
    rc = lib.sla_lpc_analyze_rows_mt(
        _f64ptr(data), B, n, order, bits_per_sample, win_ptr, emph,
        _f64ptr(parcor), _f64ptr(lengths),
    )
    if rc != 0:
        raise ValueError(f"lpc_analyze_rows: native analysis failed ({rc})")
    return parcor, lengths


def lpc_analyze_rows_at(
    base: np.ndarray,
    offsets: np.ndarray,
    n: int,
    order: int,
    bits_per_sample: int,
    window: np.ndarray | None = None,
    emphasis: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """lpc_analyze_rows over rows that live as slices of one contiguous
    float64 buffer: row b = base_flat[offsets[b] : offsets[b] + n]. Skips
    the (B, n) gather copy; per-row arithmetic identical."""
    lib = _load()
    base = np.ascontiguousarray(base, dtype=np.float64)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    B = offs.size
    parcor = np.zeros((B, order + 1), dtype=np.float64)
    lengths = np.zeros((B,), dtype=np.float64)
    if not (1 <= order <= 64):
        raise ValueError(f"lpc_analyze_rows_at: order out of native scratch range ({order})")
    win_ptr = None
    if window is not None:
        window = np.ascontiguousarray(window, dtype=np.float64)
        win_ptr = _f64ptr(window)
    rc = lib.sla_lpc_analyze_rows_off_mt(
        _f64ptr(base), offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        B, n, order, bits_per_sample, win_ptr, 1 if emphasis else 0,
        _f64ptr(parcor), _f64ptr(lengths),
    )
    if rc != 0:
        raise ValueError(f"lpc_analyze_rows_at: native analysis failed ({rc})")
    return parcor, lengths


def lpc_analyze_rows_at_i32(
    data_int32: np.ndarray,
    offsets: np.ndarray,
    modes: np.ndarray,
    n: int,
    order: int,
    bits_per_sample: int,
    window: np.ndarray | None = None,
    emphasis: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """lpc_analyze_rows_at reading the ORIGINAL (C, N) canonical int32
    signal: the interleave fill converts to float64 on the fly with
    exactly convert_ms's arithmetic (every step exact — bit-identical
    doubles, no whole-file float64 array). modes[b]: 0 = raw at
    offsets[b] (offset includes the channel row), 1/2 = MS mid/side from
    the two channel rows at sample offset offsets[b]."""
    lib = _load()
    if data_int32.dtype != np.int32 or data_int32.strides[1] != 4:
        # mode-0 offsets embed ch * (the ORIGINAL row stride) — a copy here
        # would recompute cstride but cannot fix those offsets
        raise ValueError(
            "lpc_analyze_rows_at_i32: signal must be int32 with unit "
            "inner stride (offsets embed its raw layout)")
    cstride = data_int32.strides[0] // 4
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    mds = np.ascontiguousarray(modes, dtype=np.int32)
    B = offs.size
    parcor = np.zeros((B, order + 1), dtype=np.float64)
    lengths = np.zeros((B,), dtype=np.float64)
    if not (1 <= order <= 64):
        raise ValueError(f"lpc_analyze_rows_at_i32: order out of range ({order})")
    win_ptr = None
    if window is not None:
        window = np.ascontiguousarray(window, dtype=np.float64)
        win_ptr = _f64ptr(window)
    rc = lib.sla_lpc_analyze_rows_off_i32_mt(
        _i32ptr(data_int32), cstride,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _i32ptr(mds),
        B, n, order, bits_per_sample, win_ptr, 1 if emphasis else 0,
        _f64ptr(parcor), _f64ptr(lengths),
    )
    if rc != 0:
        raise ValueError(f"lpc_analyze_rows_at_i32: native analysis failed ({rc})")
    return parcor, lengths


def make_window(window_type: int, n: int) -> np.ndarray:
    """Window generation with libm trig (exact reference values)."""
    lib = _load()
    w = np.empty(n, dtype=np.float64)
    rc = lib.sla_make_window(int(window_type), n, _f64ptr(w))
    if rc != 0:
        raise ValueError(f"invalid window function type {window_type}")
    return w


def pack_parts(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate (value, length) bit parts MSB-first (device entropy path)."""
    lib = _load()
    values = np.ascontiguousarray(values, dtype=np.uint32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    cap = int(lengths.clip(min=0).sum()) // 8 + 16
    out = np.empty(cap, dtype=np.uint8)
    n = int(lib.sla_pack_parts(_u32ptr(values), _i32ptr(lengths), values.size,
                               _u8ptr(out), cap))
    if n < 0:
        raise ValueError(f"native bit emission failed (rc={n})")
    return out[:n].tobytes()


def initial_params(data: np.ndarray) -> list[int]:
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.int32)
    C, N = data.shape
    out = np.empty(C, dtype=np.uint32)
    lib.sla_initial_params(_i32ptr(data), C, N, _u32ptr(out))
    return [int(v) for v in out]


def initial_params_rows(rows: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Initial Rice parameter per row of a (B, L) batch with per-row valid
    lengths, in one pass over the rows in place (no per-block copies)."""
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    B, L = rows.shape
    lens = np.ascontiguousarray(lengths, dtype=np.int64)
    out = np.empty(B, dtype=np.uint32)
    lib.sla_initial_params_rows(
        _i32ptr(rows), L, B, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _u32ptr(out),
    )
    return out
