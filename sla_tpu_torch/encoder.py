"""SLA encoder: host analysis + the filter cascade on a torch device + host
entropy stage (counterpart of sla_tpu/encoder.py, copied from it; only the
branches that reached jax differ).

API mirrors the reference encoder handle (src/SLAEncoder.c): create with
capacity config, set wave format / encode parameter, then `encode_whole`.

Orchestration per file (EncodeWhole, SLAEncoder.c:804-932):
  1. compute the global offset left-shift from the OR-mask of all samples
  2. walk search windows of max_num_block_samples; per window run the silent
     fast path or the Dijkstra partition search -> a flat list of blocks
  3. host float64 analysis for all blocks (windowing, pre-emphasis, LPC,
     code-length estimate, quantization), grouped by block length
  4. device stage 1 (pre-emphasis + lattice predict) for ALL blocks at once,
     host pitch analysis on the PARCOR residual, device stage 2 (long-term +
     LMS predict) for all blocks at once
  5. entropy-code each block (on the card with K8 when the filters ran
     there, on the host otherwise), assemble header + blocks with CRC16

The per-block filter work that the reference runs serially per channel
(SLAEncoder.c:531) is a single (blocks x channels, L) batch on device.

Backends: 'host' (native C++ cascade), 'device' (the port's stages on the
encoder's torch device: the CUDA kernels K1 and K2 on a card, their plain
versions on the CPU; entropy coding then runs there too, K8, unless
EncoderConfig.device_entropy='off'), 'mesh' (the same stages with the
rows split over a mesh of devices, parallel/: every CUDA card for a CUDA
device, 8 shards of the CPU for the CPU; K8 then codes the residual
gathered onto the encoder's device), 'auto' (device for big batches when
that device is a CUDA card, mesh when the mesh would span more than one
card, host otherwise). `encode_whole_batch` puts many files' blocks through one
filter batch.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from . import debug, native, pipeline, rice, rice_device
from .analysis.partition import search_optimal_partitions_batch
from .analysis.pitch import longterm_coef_rows
from .bitio import BitWriter, zigzag_encode_array
from .constants import (
    CODER_NUM_RECURSIVE_RICE_PARAMETER,
    LONGTERM_MIN_PITCH_THRESHOLD,
    SLA_BLOCK_CRC16_CALC_START_OFFSET,
    SLA_BLOCK_SYNC_CODE,
    SLA_ESTIMATE_CODELENGTH_THRESHOLD,
    SLA_HEADER_SIZE,
    SLA_MIN_BLOCK_NUM_SAMPLES,
    BlockDataType,
    ChannelProcessMethod,
    parcor_quantize_bit_width,
)
from .crc16 import crc16
from .dsp import windows as win
from .dsp.channel import LazyDoubleSource, lr_to_ms_double, lr_to_ms_int32
from .dsp.lpc import data_bit_width, width_from_maxabs
from .dsp.quantize import quantize_longterm, quantize_parcor, rshift_for_sint32
from .errors import ApiResult, SLAError
from .format import EncodeParameter, HeaderInfo, WaveFormat, encode_header
from .parallel import sharding


@dataclasses.dataclass
class EncoderConfig:
    """Create-time capacity maxima (SLAEncoder.h:14-21).

    `backend` selects where the per-sample filter cascade runs:
    'device' = the batched torch stages on the encoder's device, 'host' =
    native C++ interleaved cascade, 'mesh' = the device stages with the
    rows split over every CUDA card (8 CPU shards for device="cpu";
    parallel.sharding.SHARDS sets the count), 'auto' = device for batches
    big enough to amortize dispatch + transfer when the device is a CUDA
    card, mesh when the mesh would span more than one card
    (pipeline.mesh_cards), host otherwise (threshold in row-samples via
    SLA_TPU_DEVICE_THRESHOLD)."""

    max_num_channels: int = 8
    max_num_block_samples: int = 16384
    max_parcor_order: int = 48
    max_longterm_order: int = 5
    max_lms_order_per_filter: int = 40
    verbose: bool = False
    backend: str = "auto"
    # decode every encoded stream back and compare with the input before
    # returning it (flac -V style self-check; the reference has no
    # equivalent). Decode runs 6-9x faster than encode here, so the
    # overhead is a fraction of the encode cost.
    verify: bool = False
    # entropy coding on the device (rice_device.py, K8): 'auto' = on
    # whenever the filter batch runs on the device backend (the residual is
    # already there; only payload bytes come back), 'off' = always host
    # entropy. SLA_TPU_DEVICE_ENTROPY=1 forces it on, =0 off, on any
    # backend (pipeline.device_entropy_on).
    device_entropy: str = "auto"


@dataclasses.dataclass
class _BlockPlan:
    offset: int  # first sample index in the file
    num_samples: int
    block_type: BlockDataType = BlockDataType.COMPRESSDATA
    # analysis results (per channel), filled progressively:
    parcor_code: np.ndarray | None = None  # (C, p+1) int32 stream codes
    parcor_coef: np.ndarray | None = None  # (C, p+1) int32 filter coefs
    parcor_rshift: np.ndarray | None = None  # (C,) int
    pitch: np.ndarray | None = None  # (C,) int32
    ltm_coef: np.ndarray | None = None  # (C, T) int32 Q31
    init_rice: list[int] | None = None  # (C,) initial Rice params
    residual: np.ndarray | None = None  # (C, n) int32 final residual
    raw_int32: np.ndarray | None = None  # (C, n) int32 (for RAWDATA blocks)
    # in-place source of raw_int32 (the whole-file analysis-scale int32
    # view + this block's sample offset): the host stage-1 kernel reads
    # rows straight from it, skipping the (B, L) batch assembly copy
    raw_base: np.ndarray | None = None
    raw_off: int = 0
    # this block's payload bytes (uint8) when K8 coded them on the device
    # alongside the filters (recursive-Rice blocks only)
    device_parts: np.ndarray | None = None


def resolve_device(device) -> torch.device:
    """The torch device the filter stages use. None means the CUDA card;
    a CUDA device on a machine where torch finds none raises here, before
    any work. The CPU runs only when the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch finds no CUDA device; "
            "pass device='cpu' to run the filter stages on the CPU"
        )
    return device


class Encoder:
    def __init__(self, config: EncoderConfig | None = None, device=None):
        self.config = config or EncoderConfig()
        self.device = resolve_device(device)
        self._wave_format: WaveFormat | None = None
        self._encode_param: EncodeParameter | None = None
        self.stage_times: dict[str, float] = {}  # per-stage seconds, last encode
        # (row-samples, backend) of each filter chunk of the last encode
        # (encode_block, encode_whole, or encode_whole_batch's first encoder)
        self.filter_chunks: list[tuple[int, str]] = []

    # -- parameter setting (SLAEncoder.c:176-224) ---------------------------
    def set_wave_format(self, wf: WaveFormat) -> None:
        if wf.num_channels > self.config.max_num_channels or wf.bit_per_sample > 32:
            raise SLAError(ApiResult.EXCEED_HANDLE_CAPACITY)
        if wf.num_channels <= 0:
            raise SLAError(ApiResult.INVALID_ARGUMENT,
                           "num_channels must be positive")
        self._wave_format = dataclasses.replace(wf)

    def set_encode_parameter(self, ep: EncodeParameter) -> None:
        c = self.config
        if (
            ep.parcor_order > c.max_parcor_order
            or ep.longterm_order > c.max_longterm_order
            or ep.lms_order_per_filter > c.max_lms_order_per_filter
            or ep.max_num_block_samples > c.max_num_block_samples
            or ep.max_num_block_samples < SLA_MIN_BLOCK_NUM_SAMPLES
        ):
            raise SLAError(ApiResult.EXCEED_HANDLE_CAPACITY)
        if ep.longterm_order > 5 or (ep.longterm_order and ep.longterm_order % 2 == 0):
            # the reference requires odd tap counts (SLAPredictor.c:808-810)
            # and caps at 5 (main.c:94-98); the native kernels size their
            # tap scratch accordingly
            raise SLAError(ApiResult.INVALID_ARGUMENT, "longterm_order must be odd and <= 5")
        if ep.ch_process_method == ChannelProcessMethod.STEREO_MS:
            if self._wave_format is not None and self._wave_format.num_channels != 2:
                raise SLAError(ApiResult.INVALID_CHPROCESSMETHOD)
        self._encode_param = dataclasses.replace(ep)

    # -- helpers -------------------------------------------------------------
    def _require_params(self):
        if self._wave_format is None or self._encode_param is None:
            raise SLAError(ApiResult.PARAMETER_NOT_SET)
        if (
            self._encode_param.ch_process_method == ChannelProcessMethod.STEREO_MS
            and self._wave_format.num_channels != 2
        ):
            raise SLAError(ApiResult.INVALID_CHPROCESSMETHOD)

    @staticmethod
    def calculate_left_shift_offset(data: np.ndarray, bit_per_sample: int) -> int:
        """Trailing-zero analysis over the OR-mask (SLAEncoder.c:425-455)."""
        mask = int(np.bitwise_or.reduce(data.view(np.uint32), axis=None)) & 0xFFFFFFFF
        if mask == 0:
            return 0
        ntz = (mask & -mask).bit_length() - 1  # trailing zeros of the OR-mask
        used_width = 32 - ntz  # dynamic-range bits counted from the top
        if bit_per_sample < used_width:
            # caller handed samples with more significant bits than the
            # declared depth — reject instead of emitting a lossy stream
            raise SLAError(
                ApiResult.INVALID_ARGUMENT,
                f"samples use {used_width} bits but bit_per_sample={bit_per_sample}",
            )
        if used_width >= 32:
            # The format cannot encode a full 32-bit dynamic range
            # losslessly: the PARCOR rshift would need 16 (the stream's
            # field is 4 bits, SLAEncoder.c:683) and the MS mid channel
            # loses the 33-bit sum. The reference encodes anyway and
            # corrupts silently (its guarding asserts are compiled out,
            # SLAInternal.h:49-54); we fail loudly instead — a documented
            # deviation (PARITY.md "Known deviations").
            raise SLAError(
                ApiResult.INVALID_ARGUMENT,
                "full 32-bit dynamic range cannot encode losslessly; "
                "reduce to <= 31 effective bits",
            )
        return bit_per_sample - used_width

    def _ms_int32(self, data: np.ndarray, shift: int) -> np.ndarray:
        """(C, N) samples >> shift, MS-transformed when configured.
        Transforms in place on the freshly converted copy — these run on
        whole files, where an extra stack copy is real memory traffic."""
        x = (data >> shift).astype(np.int32)
        if self._encode_param.ch_process_method == ChannelProcessMethod.STEREO_MS:
            x[0], x[1] = lr_to_ms_int32(x[0], x[1])
        return x

    def _ms_double(self, data: np.ndarray) -> np.ndarray:
        """(C, N) samples as float64 in [-1, 1), MS-transformed when
        configured (SLAEncoder.c:381-390 conversion)."""
        d = data.astype(np.float64)
        d *= 2.0 ** -31  # in place: these run on whole files
        if self._encode_param.ch_process_method == ChannelProcessMethod.STEREO_MS:
            d[0], d[1] = lr_to_ms_double(d[0], d[1])
        return d

    def _convert_views(
        self, data: np.ndarray, shift_a: int, shift_b: int
    ) -> tuple[np.ndarray, np.ndarray, LazyDoubleSource]:
        """The whole-file views every encode needs — int32 at two shifts
        (one native pass when available; identical elementwise arithmetic
        to the NumPy forms) plus a LAZY float64 source: the partition and
        analysis consumers convert int32 -> float64 in registers with
        exact arithmetic, so the ~8 bytes/sample whole-file double array
        never materializes (it was ~40 MB of pure memory traffic per CD
        minute). When the shifts match (offset_lshift == 0, the common
        case) the int32 view is shared: every consumer is read-only."""
        ms = self._encode_param.ch_process_method == ChannelProcessMethod.STEREO_MS
        dbl = LazyDoubleSource(data, ms)
        if native.available():
            out_a, out_b, _ = native.convert_ms(
                data, shift_a, shift_b, want_double=False, ms=ms
            )
            return out_a, out_b if out_b is not None else out_a, dbl
        int32_a = self._ms_int32(data, shift_a)
        int32_b = int32_a if shift_b == shift_a else self._ms_int32(data, shift_b)
        return int32_a, int32_b, dbl

    # -- public block-level API (SLAEncoder.h:42-49) ---------------------------
    def encode_header(self, header: HeaderInfo) -> bytes:
        """Serialize the 43-byte file header (SLAEncoder_EncodeHeader,
        SLAEncoder.c:227-292). encode_whole calls this twice — provisional,
        then final with the block statistics; a caller-driven flow does the
        same: encode_header + encode_block per block + header rewrite."""
        return encode_header(header)

    def encode_block(self, data: np.ndarray) -> bytes:
        """Encode ONE block from caller-owned samples
        (SLAEncoder_EncodeBlock, SLAEncoder.c:458-801): the full per-block
        pipeline — analysis, silent/raw fallback, filters, entropy payload,
        CRC — using the caller-set wave format including its offset_lshift
        (encode_whole overwrites that field from the data; this API, like
        the reference, trusts the caller; see calculate_left_shift_offset)."""
        self._require_params()
        wf, ep = self._wave_format, self._encode_param
        if data.shape[0] != wf.num_channels:
            raise SLAError(ApiResult.INVALID_ARGUMENT, "channel count mismatch")
        n = data.shape[1]
        if n > self.config.max_num_block_samples:
            raise SLAError(ApiResult.EXCEED_HANDLE_CAPACITY)
        if n < 1:  # an empty block has no wire representation
            raise SLAError(ApiResult.INVALID_ARGUMENT, "empty block")
        data = np.ascontiguousarray(data, dtype=np.int32)
        shift = 32 - wf.bit_per_sample + wf.offset_lshift
        plan = _BlockPlan(0, n)
        self.filter_chunks = []
        int32_blk, _, dbl = self._convert_views(data, shift, shift)
        self._analyze_blocks(int32_blk, dbl, [plan])
        self._run_filters([plan])
        self._check_init_rice([plan])
        return self._encode_block_payload(plan)

    # -- whole-file encode ----------------------------------------------------
    def encode_whole(self, data: np.ndarray) -> bytes:
        """data: (num_channels, num_samples) canonical left-justified int32.

        Long streams encode in segments of whole search windows so peak
        memory stays O(segment) instead of O(file); segment boundaries
        never change a window or silent-run decision (planning carries the
        tail into the next segment), so the bytes are identical to the
        one-shot path. SLA_TPU_SEGMENT_SAMPLES tunes the threshold."""
        self.filter_chunks = []
        seg = self._segment_samples()
        if data.shape[1] > seg:
            blob = self._encode_whole_segmented(
                np.ascontiguousarray(data, dtype=np.int32), seg
            )
            self._maybe_verify(blob, data)
            return blob
        num_samples, plans = self._stage_encode(data)
        t0 = time.perf_counter()
        self._run_filters(plans)
        self.stage_times["filters"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        blob = self._finalize_encode(num_samples, plans)
        self.stage_times["entropy"] = time.perf_counter() - t0
        if self.config.verbose:
            st = self.stage_times
            total = sum(st.values())
            print(
                "stages: "
                + "  ".join(f"{k} {v * 1e3:.1f}ms" for k, v in st.items())
                + f"  total {total * 1e3:.1f}ms"
            )
        self._maybe_verify(blob, data)
        return blob

    def _maybe_verify(self, blob: bytes, data: np.ndarray) -> None:
        """config.verify: decode the finished stream back, on the same
        backend and device, and require the exact input PCM (encode-time
        self-check, flac -V style)."""
        if not self.config.verify:
            return
        from .decoder import Decoder, DecoderConfig

        c = self.config
        dec = Decoder(DecoderConfig(max_num_channels=c.max_num_channels,
                                    max_num_block_samples=c.max_num_block_samples,
                                    max_parcor_order=c.max_parcor_order,
                                    max_longterm_order=c.max_longterm_order,
                                    max_lms_order_per_filter=c.max_lms_order_per_filter,
                                    backend=c.backend),
                      device=self.device)
        err = SLAError(
            ApiResult.DETECT_DATA_CORRUPTION,
            "encode verification failed: decoded stream differs from the input",
        )
        data = np.asarray(data, dtype=np.int32)
        seg = self._segment_samples()
        if data.shape[1] <= seg:
            _, out = dec.decode_whole(blob)
            if out.shape != data.shape or not np.array_equal(out, data):
                raise err
            return
        # long streams verify in segment-sized decode_range windows so the
        # check keeps the segmented encode's O(segment) peak memory instead
        # of re-materializing the whole file's PCM a second time
        from .format import decode_header

        header, _ = decode_header(blob)
        if (header.num_samples != data.shape[1]
                or header.wave_format.num_channels != data.shape[0]):
            raise err
        # one CRC-verified header walk, reused across every window —
        # without the index each decode_range call re-walks (and re-CRCs)
        # the whole stream, turning the verify pass O(segments * blocks)
        idx = dec.build_index(blob)
        pos = 0
        while pos < data.shape[1]:
            take = min(seg, data.shape[1] - pos)
            _, win = dec.decode_range(blob, pos, take, index=idx)
            if (win.shape != (data.shape[0], take)
                    or not np.array_equal(win, data[:, pos : pos + take])):
                raise err
            pos += take

    def _segment_samples(self) -> int:
        """Samples per encode segment: a multiple of the window size, from
        SLA_TPU_SEGMENT_SAMPLES (default ~16.7M samples/channel — about six
        minutes of 44.1 kHz audio; at least four windows)."""
        self._require_params()
        m = self._encode_param.max_num_block_samples
        v = int(os.environ.get("SLA_TPU_SEGMENT_SAMPLES", 1 << 24))
        return max(4 * m, (v // m) * m)

    def _encode_whole_segmented(self, data: np.ndarray, seg: int) -> bytes:
        """Rolling-window encode for long streams (see encode_whole)."""
        self._require_params()
        wf, ep = self._wave_format, self._encode_param
        if data.shape[0] != wf.num_channels:
            raise SLAError(ApiResult.INVALID_ARGUMENT, "channel count mismatch")
        num_samples = data.shape[1]
        wf.offset_lshift = self.calculate_left_shift_offset(data, wf.bit_per_sample)
        shift_a = 32 - wf.bit_per_sample
        shift_b = shift_a + wf.offset_lshift
        self.stage_times = {"partition": 0.0, "analysis": 0.0,
                            "filters": 0.0, "entropy": 0.0}
        payloads: list[bytes] = []
        total_blocks = 0
        max_block_size = 0
        max_bps = 0
        offset = 0
        while offset < num_samples:
            seg_end = min(offset + seg, num_samples)
            final = seg_end == num_samples
            t0 = time.perf_counter()
            sdata = np.ascontiguousarray(data[:, offset:seg_end])
            int32_plan, int32_blk, dbl = self._convert_views(sdata, shift_a, shift_b)
            plans, consumed = self._plan_blocks(
                int32_plan, dbl, seg_end - offset, final=final
            )
            del int32_plan
            if consumed <= 0:  # unreachable while seg >= 4 windows; keep loud
                raise SLAError(
                    ApiResult.NG, "segmented planning made no progress"
                )
            self.stage_times["partition"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            self._analyze_blocks(int32_blk, dbl, plans)
            del dbl
            self.stage_times["analysis"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            self._run_filters(plans)
            self.stage_times["filters"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            self._check_init_rice(plans)  # same gate as the one-shot path
            use_native = (
                native.available()
                and not os.environ.get("SLA_TPU_DEVICE_ENTROPY")
                and not getattr(self, "_device_entropy_active", False)
            )
            if use_native:
                payload, sizes, nsamp = self._serialize_blocks_native(plans)
                payloads.append(payload)
                bs, bb = self._header_stats(sizes, nsamp)
            else:
                blobs = [self._encode_block_payload(plan) for plan in plans]
                payloads.extend(blobs)
                bs, bb = self._header_stats(
                    [len(b) for b in blobs], [p.num_samples for p in plans]
                )
            max_block_size = max(max_block_size, bs)
            max_bps = max(max_bps, bb)
            self.stage_times["entropy"] += time.perf_counter() - t0
            total_blocks += len(plans)
            offset += consumed
            if self.config.verbose:
                print(
                    f"progress:{100 * offset // num_samples:2d}%",
                    end="\r",
                    flush=True,
                )
        if self.config.verbose:
            st = self.stage_times
            print(
                "stages: "
                + "  ".join(f"{k} {v * 1e3:.1f}ms" for k, v in st.items())
                + f"  total {sum(st.values()) * 1e3:.1f}ms"
            )
        header = HeaderInfo(
            wave_format=wf,
            encode_param=ep,
            num_samples=num_samples,
            num_blocks=total_blocks,
            max_block_size=max_block_size,
            max_bit_per_second=max_bps,
        )
        return encode_header(header) + b"".join(payloads)

    def _stage_encode(self, data: np.ndarray) -> tuple[int, list["_BlockPlan"]]:
        """Checks + left-shift detection + block planning + float64 analysis
        (everything before the batched filter stage)."""
        self._require_params()
        wf = self._wave_format
        if data.shape[0] != wf.num_channels:
            raise SLAError(ApiResult.INVALID_ARGUMENT, "channel count mismatch")
        data = np.ascontiguousarray(data, dtype=np.int32)
        num_samples = data.shape[1]
        wf.offset_lshift = self.calculate_left_shift_offset(data, wf.bit_per_sample)
        self.stage_times = {}
        t0 = time.perf_counter()
        # whole-file conversions computed once (elementwise, so identical to
        # the per-window/per-block versions they replace): the MS-transformed
        # float64 signal feeds both partition search and block analysis; the
        # two int32 views differ in shift (the silence scan uses no lshift,
        # SLAEncoder.c:381-390, while block analysis removes the offset,
        # SLAEncoder.c:505-512). Peak memory is unchanged — the partition
        # windows already materialized the float64 signal in full.
        int32_plan, int32_blk, dbl = self._convert_views(
            data, 32 - wf.bit_per_sample, 32 - wf.bit_per_sample + wf.offset_lshift
        )
        plans, _ = self._plan_blocks(int32_plan, dbl, num_samples)
        del int32_plan  # planning view done; frees ~N*C*4 bytes when lshift != 0
        self.stage_times["partition"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._analyze_blocks(int32_blk, dbl, plans)
        self.stage_times["analysis"] = time.perf_counter() - t0
        return num_samples, plans

    def _check_init_rice(self, plans: list["_BlockPlan"]) -> None:
        """Reference defect gate (assert compiled out under NDEBUG,
        SLACoder.c:402): a block mean zigzag magnitude that does not fit
        the bit_per_sample-wide initial-Rice-parameter field writes
        TRUNCATED bits, and the reference's own decoder then desyncs and
        silently corrupts the block. Like the 32-bit full-scale case
        (PARITY.md known deviations), raise a structured error instead of
        emitting a stream nothing can decode losslessly. Checked per
        encoder — mixed-depth batched jobs each use THEIR field width —
        and on BOTH the one-shot and segmented paths."""
        init_limit = 1 << self._wave_format.bit_per_sample
        for pl in plans:
            if pl.init_rice is not None and any(
                int(v) >= init_limit for v in pl.init_rice
            ):
                raise SLAError(
                    ApiResult.INVALID_ARGUMENT,
                    "block residual magnitude exceeds the initial Rice "
                    "parameter field (the reference silently corrupts here)",
                )

    def _finalize_encode(self, num_samples: int, plans: list["_BlockPlan"]) -> bytes:
        """Entropy-code all blocks and assemble the container."""
        wf, ep = self._wave_format, self._encode_param
        self._check_init_rice(plans)
        if (
            native.available()
            and not os.environ.get("SLA_TPU_DEVICE_ENTROPY")
            and not getattr(self, "_device_entropy_active", False)
            and not self.config.verbose  # per-block progress stays on the loop
        ):
            return self._finalize_encode_native(num_samples, plans)
        # entropy-code blocks (the semantic-reference per-block loop)
        blobs: list[bytes] = []
        done_samples = 0
        out_size = 0
        for plan in plans:
            blob = self._encode_block_payload(plan)
            blobs.append(blob)
            if self.config.verbose:
                # progress display (SLAEncoder.c:903-911)
                done_samples += plan.num_samples
                out_size += len(blob)
                orig = done_samples * wf.num_channels * wf.bit_per_sample // 8
                print(
                    f"progress:{100 * done_samples // num_samples:2d}% "
                    f"(compress ratio:{100.0 * out_size / max(orig, 1):.1f} %)",
                    end="\r",
                    flush=True,
                )
        max_block_size, max_bps = self._header_stats(
            [len(b) for b in blobs], [p.num_samples for p in plans]
        )
        header = HeaderInfo(
            wave_format=wf,
            encode_param=ep,
            num_samples=num_samples,
            num_blocks=len(plans),
            max_block_size=max_block_size,
            max_bit_per_second=max_bps,
        )
        return encode_header(header) + b"".join(blobs)

    def _header_stats(self, sizes, nsamp) -> tuple[int, int]:
        """(max_block_size, max_bit_per_second) from per-block byte sizes
        and sample counts — the reference's uint32-wrapping arithmetic
        (SLAEncoder.c:895), the single authoritative copy."""
        sizes = np.asarray(sizes, dtype=np.int64)
        nsamp = np.asarray(nsamp, dtype=np.int64)
        if sizes.size == 0:
            return 0, 0
        bps = ((8 * sizes * self._wave_format.sampling_rate) & 0xFFFFFFFF) // nsamp
        return int(sizes.max()), int(bps.max())

    def _serialize_blocks_native(
        self, plans: list["_BlockPlan"], prefix_reserve: int = 0
    ) -> tuple[bytes, np.ndarray, np.ndarray]:
        """One native call serializes every block back to back (identical
        bytes to the per-block path — blocks are byte-aligned). Returns
        (payload, per-block byte sizes, per-block sample counts)."""
        wf, ep = self._wave_format, self._encode_param
        C, p, T = wf.num_channels, ep.parcor_order, ep.longterm_order
        W = len(plans)
        nsamp = np.empty(W, dtype=np.int32)
        btype = np.empty(W, dtype=np.int32)
        code = np.zeros((W, C, p + 1), dtype=np.int32)
        rshift = np.zeros((W, C), dtype=np.int32)
        pitch = np.zeros((W, C), dtype=np.int32)
        ltm = np.zeros((W, C, max(T, 1)), dtype=np.int32)
        init = np.zeros((W, C), dtype=np.uint32)
        silent_rows = np.zeros((C, 1), dtype=np.int32)
        rows: list[np.ndarray] = []
        for b, plan in enumerate(plans):
            nsamp[b] = plan.num_samples
            btype[b] = int(plan.block_type)
            if plan.block_type == BlockDataType.COMPRESSDATA:
                code[b] = plan.parcor_code
                rshift[b] = plan.parcor_rshift
                pitch[b] = plan.pitch
                ltm[b] = plan.ltm_coef
                init[b] = plan.init_rice
                rows.append(plan.residual)
            elif plan.block_type == BlockDataType.RAWDATA:
                rows.append(plan.raw_int32)
            else:
                rows.append(silent_rows)
        raw_bits = [wf.bit_per_sample - wf.offset_lshift] * C
        if ep.ch_process_method == ChannelProcessMethod.STEREO_MS:
            raw_bits[1] += 1
        payload, sizes = native.encode_blocks(
            nsamp, btype, p, T, wf.bit_per_sample, LONGTERM_MIN_PITCH_THRESHOLD,
            code, rshift, pitch, ltm, init, rows, raw_bits,
            prefix_reserve=prefix_reserve,
        )
        return payload, sizes, nsamp

    def _finalize_encode_native(
        self, num_samples: int, plans: list["_BlockPlan"]
    ) -> bytes:
        wf, ep = self._wave_format, self._encode_param
        # Reserve the 43-byte header slot in the serialization buffer so
        # the stream materializes with ONE copy (header patched in place)
        # instead of tobytes() followed by header+payload concatenation —
        # both full-stream copies on fresh pages (~5us/4KB fault here).
        stream, sizes, nsamp = self._serialize_blocks_native(
            plans, prefix_reserve=SLA_HEADER_SIZE
        )
        max_block_size, max_bps = self._header_stats(sizes, nsamp)
        header = HeaderInfo(
            wave_format=wf,
            encode_param=ep,
            num_samples=num_samples,
            num_blocks=len(plans),
            max_block_size=max_block_size,
            max_bit_per_second=max_bps,
        )
        stream[:SLA_HEADER_SIZE] = np.frombuffer(
            encode_header(header), dtype=np.uint8
        )
        return stream.tobytes()

    # -- step 2: block planning ----------------------------------------------
    def _plan_blocks(
        self, int32_ms: np.ndarray, dbl_src: LazyDoubleSource, num_samples: int,
        final: bool = True,
    ) -> tuple[list[_BlockPlan], int]:
        """Two-phase planning: a cheap sequential pass fixes the window
        boundaries (they depend only on the silence scan), then ALL
        partition-search windows analyze in one batched pass.

        int32_ms: (C, N) MS-transformed samples at the no-lshift scale (the
        silence scan's view, SLAEncoder.c:381-408); dbl_src: the lazy
        float64 MS source (LazyDoubleSource).

        When `final` is False (a segment of a longer stream), planning
        stops before any window that would not see a full
        max_num_block_samples of data — the tail carries into the next
        segment, so segment boundaries can never change a window or
        silent-run decision. Returns (plans, samples consumed)."""
        wf, ep = self._wave_format, self._encode_param
        plans: list = []
        windows: list[tuple[int, int, int]] = []  # (offset, window_len, min_block)
        offset = 0
        while offset < num_samples:
            remain = num_samples - offset
            if not final and remain < ep.max_num_block_samples:
                break  # next segment sees the full window
            window_len = min(ep.max_num_block_samples, remain)
            min_block = min(SLA_MIN_BLOCK_NUM_SAMPLES, remain)
            int32 = int32_ms[:, offset : offset + window_len]
            # probe the first min_block samples first: any nonzero there
            # means silent_run < min_block, so the exact first-nonzero
            # index is never needed (the common case for real audio —
            # skips the full-window scan)
            probe = int32[:, :min_block]
            if probe.any():
                silent_run = 0  # stands for "< min_block"; exact value unused
            else:
                nonzero = np.nonzero(np.any(int32 != 0, axis=0))[0]
                silent_run = int(nonzero[0]) if nonzero.size else window_len
            if silent_run >= min_block:
                plans.append(_BlockPlan(offset, silent_run))
                offset += silent_run
                continue
            windows.append((offset, window_len, min_block))
            plans.append(None)  # placeholder, expanded below
            offset += window_len
        consumed = offset
        if not windows:
            return plans, consumed

        # lazy window data: thunks materialize float64 MS slices only on
        # the rare paths that need them (exact re-price, no-native); the
        # fast path reads the int32 signal through `base` directly
        wdata = [
            (lambda off=off, wl=wl: dbl_src.materialize(off, off + wl))
            for off, wl, _ in windows
        ]
        sizes_list = search_optimal_partitions_batch(
            wdata,
            [w[1] for w in windows],
            [w[2] for w in windows],
            [w[1] for w in windows],
            ep.parcor_order,
            wf.bit_per_sample,
            base=dbl_src,
            base_offsets=[w[0] for w in windows],
        )
        out: list[_BlockPlan] = []
        wi = 0
        for pl in plans:
            if pl is not None:
                out.append(pl)
                continue
            off = windows[wi][0]
            for n in sizes_list[wi]:
                out.append(_BlockPlan(off, n))
                off += n
            wi += 1
        return out, consumed

    # -- step 3: per-block float64 analysis -----------------------------------
    def _analyze_blocks(
        self, int32_ms: np.ndarray, dbl_src: LazyDoubleSource,
        plans: list[_BlockPlan]
    ) -> None:
        """int32_ms: (C, N) MS-transformed samples at the block-analysis
        scale (offset lshift removed); dbl_src: the lazy float64 MS source
        (LazyDoubleSource over the original int32 signal)."""
        wf, ep = self._wave_format, self._encode_param
        C = wf.num_channels
        p = ep.parcor_order

        # group by block length so windowing/LPC vectorize over same-shape rows
        by_len: dict[int, list[int]] = {}
        for i, plan in enumerate(plans):
            by_len.setdefault(plan.num_samples, []).append(i)

        # bound the float64 analysis buffer for long files (~100 MB cap)
        max_group = max(1, (100 << 20) // (C * ep.max_num_block_samples * 8))
        grouped = [
            (n, idxs[i : i + max_group])
            for n, idxs in by_len.items()
            for i in range(0, len(idxs), max_group)
        ]
        for n, idxs in grouped:
            stats = None
            if native.available():
                # one native pass per group: per-channel max/min feed both
                # the silence scan and the bit-width -> rshift derivation
                stats = native.block_stats(
                    int32_ms,
                    np.asarray([plans[i].offset for i in idxs]),
                    np.full(len(idxs), n),
                )
            for row, i in enumerate(idxs):
                plan = plans[i]
                plan.raw_int32 = int32_ms[:, plan.offset : plan.offset + n]
                plan.raw_base = int32_ms
                plan.raw_off = plan.offset
                if stats is not None:
                    if not (stats[0][row].any() or stats[1][row].any()):
                        plan.block_type = BlockDataType.SILENT
                elif not np.any(plan.raw_int32):
                    plan.block_type = BlockDataType.SILENT
            # the expensive exact-order float64 analysis only runs for rows
            # that can still become COMPRESSDATA — silent blocks discard it
            # (the reference skips them the same way, SLAEncoder.c:519-528)
            live_rows = [
                row for row, i in enumerate(idxs)
                if plans[i].block_type != BlockDataType.SILENT
            ]
            live = [idxs[r] for r in live_rows]
            if not live:
                continue
            window = win.make_window(ep.window_function_type, n)
            if native.available() and p >= 1:
                # exact-order analysis: byte-identity needs the reference's
                # float64 summation order (see native sla_lpc_analyze).
                # (order 0 — passthrough lattice — takes the exact-twin
                # branch below: the native scratch kernels need order >= 1
                # and the order-0 estimate is trivial)
                # Windowing + double pre-emphasis (SLAEncoder.c:540-543)
                # fuse into the native interleave fill, which reads the
                # ORIGINAL int32 rows in place and converts to float64 on
                # the fly (exact arithmetic — identical doubles, and the
                # whole-file float64 signal never materializes).
                cstride = dbl_src.data.strides[0] // 4
                if dbl_src.ms:
                    offs = np.asarray(
                        [plans[i].offset for i in live for _ in range(C)],
                        dtype=np.int64,
                    )
                    modes = np.asarray([1, 2] * len(live), dtype=np.int32)
                else:
                    offs = np.asarray(
                        [
                            ch * cstride + plans[i].offset
                            for i in live
                            for ch in range(C)
                        ],
                        dtype=np.int64,
                    )
                    modes = np.zeros(len(live) * C, dtype=np.int32)
                parcor_r, len_r = native.lpc_analyze_rows_at_i32(
                    dbl_src.data, offs, modes, n, p, wf.bit_per_sample,
                    window=window, emphasis=True,
                )
                parcor = parcor_r.reshape((len(live), C, p + 1))
                code_len = len_r.reshape((len(live), C))
            else:
                batch_dbl = np.empty((len(live), C, n), dtype=np.float64)
                for k, i in enumerate(live):
                    batch_dbl[k] = dbl_src.materialize(
                        plans[i].offset, plans[i].offset + n
                    )
                # toolchain-free exact path: pure-Python twins of the exact
                # windowed + pre-emphasized analysis (sla_tpu.exact),
                # bit-identical to the native rows — slow, per row
                from . import exact

                flat = batch_dbl.reshape(-1, n)
                parcor = np.zeros((flat.shape[0], p + 1), dtype=np.float64)
                code_len = np.zeros(flat.shape[0], dtype=np.float64)
                for r in range(flat.shape[0]):
                    parcor[r], code_len[r] = exact.lpc_analyze(
                        flat[r], p, wf.bit_per_sample, window=window, emphasis=True
                    )
                parcor = parcor.reshape(batch_dbl.shape[:-1] + (p + 1,))
                code_len = code_len.reshape(batch_dbl.shape[:-1])
            ratio = 8.0 * code_len / wf.bit_per_sample
            comp_rows: list[int] = []
            comp_plans: list[_BlockPlan] = []
            rshifts: list[np.ndarray] = []
            for k, (row, i) in enumerate(zip(live_rows, live)):
                plan = plans[i]
                # raw fallback when prediction will not compress
                # (per-channel check in channel order, SLAEncoder.c:553-565)
                if np.any(ratio[k] >= SLA_ESTIMATE_CODELENGTH_THRESHOLD):
                    plan.block_type = BlockDataType.RAWDATA
                    continue
                if stats is not None:
                    # bit width from the group stats pass (shared formula)
                    bw = width_from_maxabs(
                        np.maximum(
                            stats[0][row].astype(np.int64),
                            -stats[1][row].astype(np.int64),
                        )
                    )
                else:
                    bw = data_bit_width(plan.raw_int32)  # (C,)
                plan.parcor_rshift = np.asarray(
                    rshift_for_sint32(bw), dtype=np.int32
                )
                comp_rows.append(k)
                comp_plans.append(plan)
                rshifts.append(plan.parcor_rshift)
            if comp_plans:
                # one batched quantization for the whole group (identical
                # elementwise arithmetic to per-block calls)
                code_b, coef_b = quantize_parcor(
                    parcor[comp_rows], p, np.stack(rshifts)
                )
                for j, plan in enumerate(comp_plans):
                    plan.parcor_code = code_b[j]
                    plan.parcor_coef = coef_b[j]

    def _select_backend(self, row_samples: int) -> str:
        return pipeline.select_backend(self.config.backend, row_samples, self.device)

    # -- step 4: filters + pitch analysis --------------------------------------
    def _run_filters(self, plans: list[_BlockPlan]) -> None:
        """Filters read each plan's raw_int32 view — no whole-file input."""
        self._device_entropy_active = False  # set per run by attach step
        comp = [pl for pl in plans if pl.block_type == BlockDataType.COMPRESSDATA]
        if comp:
            self._run_filter_groups([(self._wave_format.num_channels, comp)])

    def _run_filter_groups(self, groups: list[tuple[int, list[_BlockPlan]]]) -> None:
        """Batched filter + pitch stage over many streams at once.

        groups: (num_channels, compress_plans) per stream. Every stream must
        share this encoder's filter orders and max block size (one preset);
        channel counts may differ. This is the seam corpus batching uses to
        fuse many small files' blocks into ONE (rows, L) batch — the batch
        axis the device and mesh backends parallelize (see
        encode_whole_batch)."""
        ep = self._encode_param
        flat = [(pl, C) for C, comp in groups for pl in comp]
        if not flat:
            return
        # bound the filter working set for very long streams: three (B, L)
        # int32 buffers (input batch + two residual stages) live at once, so
        # cap B to ~SLA_TPU_FILTER_CHUNK_MB across them. Blocks are fully
        # independent (the format resets filters at block start), so
        # chunking cannot change any output byte.
        L = ep.max_num_block_samples
        budget_mb = int(os.environ.get("SLA_TPU_FILTER_CHUNK_MB", 256))
        budget_rows = max(8, (budget_mb << 20) // (L * 4 * 3))
        chunk: list[tuple[_BlockPlan, int]] = []
        count = 0
        for pl, C in flat:
            if chunk and count + C > budget_rows:
                self._run_filter_chunk(chunk)
                chunk, count = [], 0
            chunk.append((pl, C))
            count += C
        if chunk:
            self._run_filter_chunk(chunk)

    def _run_filter_chunk(self, plan_rows: list[tuple[_BlockPlan, int]]) -> None:
        """One bounded (rows, L) batch through stage1 -> pitch -> stage2."""
        ep = self._encode_param
        p = ep.parcor_order
        T = ep.longterm_order
        rows_meta: list[tuple[_BlockPlan, int, int]] = []  # (plan, C, row0)
        rows = 0
        for pl, C in plan_rows:
            rows_meta.append((pl, C, rows))
            rows += C
        row_samples = sum(pl.num_samples * C for pl, C, _ in rows_meta)
        backend = self._select_backend(row_samples)
        if backend == "mesh" and debug.asserts_enabled():
            # the mesh functions refuse assert mode, as sla_tpu's do
            # (checkify cannot cross shard_map); assert mode runs the
            # checked single-device stages instead
            backend = "device"
        self.filter_chunks.append((row_samples, backend))
        # the host path pads L to the stream's max block size; the device
        # and mesh stages take exact rows with L the chunk's longest block
        # (the kernels accept any (B, L))
        L = (
            ep.max_num_block_samples if backend == "host"
            else max(pl.num_samples for pl, _, _ in rows_meta)
        )
        B = rows
        coefs = np.zeros((B, p), dtype=np.int32)
        lengths = np.zeros((B,), dtype=np.int64)
        for pl, C, r0 in rows_meta:
            coefs[r0 : r0 + C] = pl.parcor_coef[:, 1:]
            lengths[r0 : r0 + C] = pl.num_samples
        # host backend reads its input rows IN PLACE from the whole-file
        # int32 view (one shared base, contiguous) — the (B, L) batch
        # materializes only for the device path (which uploads it)
        base0 = rows_meta[0][0].raw_base
        in_place = (
            backend == "host"
            and base0 is not None
            and base0.flags.c_contiguous
            and all(pl.raw_base is base0 for pl, _, _ in rows_meta)
        )
        batch = None
        if not in_place:
            # np.empty + explicit tail zeroing: the data region is
            # overwritten right below, and a full-batch np.zeros memset
            # costs ~2 ms per 10 MB in first-touch page faults
            batch = np.empty((B, L), dtype=np.int32)
            for pl, C, r0 in rows_meta:
                batch[r0 : r0 + C, : pl.num_samples] = pl.raw_int32
                if pl.num_samples < L:
                    batch[r0 : r0 + C, pl.num_samples :] = 0

        res1_dev = None
        res2_dev = None
        if backend == "mesh":
            # the rows split over the mesh's devices (parallel/); stage 1
            # stays on the shards for stage 2, and pitch analysis reads a
            # host copy
            mesh = sharding.make_mesh(sharding.mesh_devices(self.device))
            d_batch, d_coefs = sharding.shard_batch(mesh, batch, coefs)
            res1_dev = sharding.sharded_encode_stage1(d_batch, d_coefs, p)
            residual1 = sharding.gather(res1_dev)
        elif backend == "host":
            if in_place:
                cstride = base0.strides[0] // 4
                offs = np.empty((B,), dtype=np.int64)
                for pl, C, r0 in rows_meta:
                    for ch in range(C):
                        offs[r0 + ch] = ch * cstride + pl.raw_off
                residual1 = native.predict_stage1_rows_at(
                    base0, offs, coefs, lengths, L
                )
            else:
                residual1 = native.predict_stage1_rows(batch, coefs, lengths)
        else:
            # keep the device-resident residual: pitch analysis needs a host
            # copy, but stage 2 consumes the on-device value directly (no
            # re-upload)
            res1_dev = pipeline.encode_stage1(
                pipeline.to_rows(batch, self.device),
                pipeline.to_rows(coefs, self.device), p,
            )
            residual1 = pipeline.fetch_int32(res1_dev)

        # host pitch analysis on the PARCOR residual, per (block, channel)
        pitches = np.zeros((B,), dtype=np.int32)
        ltm = np.zeros((B, max(T, 1)), dtype=np.int32)
        if T > 0:
            fft_size = 1 << (2 * self.config.max_num_block_samples - 1).bit_length()
            # group rows by length for the FFT batch
            rows_by_len: dict[int, list[int]] = {}
            for pl, C, r0 in rows_meta:
                for ch in range(C):
                    rows_by_len.setdefault(pl.num_samples, []).append(r0 + ch)
            for n, row_ids in rows_by_len.items():
                i0 = row_ids[0]
                if row_ids == list(range(i0, i0 + len(row_ids))):
                    # consecutive rows (the common case: uniform block
                    # lengths): a basic slice is a view — fancy indexing
                    # would copy ~4 bytes/row-sample
                    rows_in = residual1[i0 : i0 + len(row_ids), :n]
                else:
                    rows_in = residual1[row_ids, :n]
                res = longterm_coef_rows(rows_in, n, T, fft_size)
                keep = [
                    (r, lt)
                    for r, lt in zip(row_ids, res)
                    if lt.pitch_period >= LONGTERM_MIN_PITCH_THRESHOLD
                ]
                if keep:
                    rs = [r for r, _ in keep]
                    pitches[rs] = [lt.pitch_period for _, lt in keep]
                    # one batched Q15 quantization for all kept rows
                    ltm[rs] = quantize_longterm(
                        np.stack([lt.coef for _, lt in keep])
                    )
        if backend == "mesh":
            res2_mesh = sharding.sharded_encode_stage2(
                res1_dev, pitches, ltm, T, ep.lms_order_per_filter
            )
            residual2 = sharding.gather(res2_mesh)
            if native.available() and self._device_entropy_on(backend):
                # K8 codes a block's channels together, and a block's
                # channels may lie on two shards: one copy of the residual
                # on the encoder's device, gathered device to device
                res2_dev = sharding.gather_to(res2_mesh, self.device)
        elif backend == "host":
            residual2 = native.predict_stage2_rows(
                residual1, pitches, ltm, T, ep.lms_order_per_filter, lengths
            )
        else:
            res2_dev = pipeline.encode_stage2(
                res1_dev, pitches, ltm, T, ep.lms_order_per_filter
            )
            residual2 = pipeline.fetch_int32(res2_dev)
        init_all = (
            native.initial_params_rows(residual2, lengths)
            if native.available()
            else None
        )
        for pl, C, r0 in rows_meta:
            pl.pitch = pitches[r0 : r0 + C]
            pl.ltm_coef = ltm[r0 : r0 + C]
            pl.residual = residual2[r0 : r0 + C, : pl.num_samples]
            pl.init_rice = (
                [int(v) for v in init_all[r0 : r0 + C]]
                if init_all is not None
                else rice.calculate_initial_params(list(pl.residual))
            )
        if init_all is not None and self._device_entropy_on(backend):
            # pass the LIVE device residual when the filter batch ran
            # on-chip — the symbol pass reads it from HBM with no re-upload
            # over PCIe (the host copy is only for the part-less fallbacks)
            self._attach_device_parts(
                rows_meta, residual2 if res2_dev is None else res2_dev, init_all
            )

    def _device_entropy_on(self, backend: str) -> bool:
        """Device entropy policy: on-card symbol coding is the default
        whenever the filter batch already ran on the device backend (the
        residual is on the card and only payload bytes come back);
        SLA_TPU_DEVICE_ENTROPY forces it regardless. One shared definition
        with the decoder: pipeline.device_entropy_on."""
        return pipeline.device_entropy_on(self.config, backend)

    def _attach_device_parts(self, rows_meta, residual2, init_all) -> None:
        """ONE batched K8 pass for the whole filter chunk
        (rice_device.encode_blocks_device over the residual rows where they
        lie): each recursive-Rice COMPRESSDATA block gets its payload bytes
        for payload time. Static-Golomb blocks keep the host coder and get
        none. A host residual (forced device entropy on the host backend)
        is uploaded to the encoder's device first."""
        res = (residual2 if isinstance(residual2, torch.Tensor)
               else pipeline.to_rows(residual2, self.device))
        by_channels: dict[int, list[tuple[_BlockPlan, int]]] = {}
        for pl, C, r0 in rows_meta:
            if (pl.block_type == BlockDataType.COMPRESSDATA
                    and not rice_device.is_golomb_block(init_all[r0 : r0 + C])):
                by_channels.setdefault(C, []).append((pl, r0))
        for C, blocks in by_channels.items():
            payload, offsets, sizes = rice_device.encode_blocks_device(
                res, [r0 for _, r0 in blocks], [pl.num_samples for pl, _ in blocks],
                np.stack([np.asarray(init_all[r0 : r0 + C], dtype=np.uint32)
                          for _, r0 in blocks]),
                C,
            )
            for (pl, _), off, size in zip(blocks, offsets, sizes):
                pl.device_parts = payload[off : off + size]
        self._device_entropy_active = True

    # -- step 5: block serialization (SLAEncoder.c:458-801) -------------------
    def _encode_block_payload(self, plan: _BlockPlan) -> bytes:
        wf, ep = self._wave_format, self._encode_param
        C = wf.num_channels
        if (
            native.available()
            and not os.environ.get("SLA_TPU_DEVICE_ENTROPY")
            and plan.device_parts is None
        ):
            # whole-block framing + payload + CRC in one native call; the
            # Python writer below stays as the semantic reference/fallback
            p, T = ep.parcor_order, ep.longterm_order
            if plan.block_type == BlockDataType.RAWDATA:
                bits = [wf.bit_per_sample - wf.offset_lshift] * C
                if ep.ch_process_method == ChannelProcessMethod.STEREO_MS:
                    bits[1] += 1
                return native.encode_block(
                    plan.num_samples, 2, p, T, wf.bit_per_sample,
                    LONGTERM_MIN_PITCH_THRESHOLD,
                    np.zeros((C, p + 1), np.int32), np.zeros(C, np.int32),
                    np.zeros(C, np.int32), np.zeros((C, max(T, 1)), np.int32),
                    np.zeros(C, np.uint32), plan.raw_int32, bits,
                )
            if plan.block_type == BlockDataType.SILENT:
                return native.encode_block(
                    plan.num_samples, 1, p, T, wf.bit_per_sample,
                    LONGTERM_MIN_PITCH_THRESHOLD,
                    np.zeros((C, p + 1), np.int32), np.zeros(C, np.int32),
                    np.zeros(C, np.int32), np.zeros((C, max(T, 1)), np.int32),
                    np.zeros(C, np.uint32), np.zeros((C, 1), np.int32),
                )
            return native.encode_block(
                plan.num_samples, 0, p, T, wf.bit_per_sample,
                LONGTERM_MIN_PITCH_THRESHOLD,
                plan.parcor_code, plan.parcor_rshift, plan.pitch,
                plan.ltm_coef, plan.init_rice, plan.residual,
            )
        w = BitWriter()
        w.put(SLA_BLOCK_SYNC_CODE, 16)
        w.put(0, 32)  # next-block offset placeholder
        w.put(0, 16)  # CRC16 placeholder
        w.put(plan.num_samples, 16)
        w.put(int(plan.block_type), 2)
        if plan.block_type == BlockDataType.COMPRESSDATA:
            for ch in range(C):
                w.put(int(plan.parcor_rshift[ch]), 4)
                for ord_ in range(1, ep.parcor_order + 1):
                    w.put(
                        rice.sint32_to_uint32(int(plan.parcor_code[ch, ord_])),
                        parcor_quantize_bit_width(ord_),
                    )
                if plan.pitch[ch] >= LONGTERM_MIN_PITCH_THRESHOLD:
                    w.put(1, 1)
                    w.put(int(plan.pitch[ch]), 10)
                    for t in range(ep.longterm_order):
                        q15 = int(plan.ltm_coef[ch, t]) >> 16
                        w.put(rice.sint32_to_uint32(q15), 16)
                else:
                    w.put(0, 1)
                w.put(rice.effective_init_param(plan.init_rice[ch]), wf.bit_per_sample)
        w.flush()
        use_native = native.available()
        if plan.block_type == BlockDataType.RAWDATA:
            bits = [wf.bit_per_sample - wf.offset_lshift] * C
            if ep.ch_process_method == ChannelProcessMethod.STEREO_MS:
                bits[1] += 1
            if use_native:
                w.put_bytes(native.put_raw(plan.raw_int32, bits))
            else:
                zz = [zigzag_encode_array(plan.raw_int32[ch]) for ch in range(C)]
                for s in range(plan.num_samples):
                    for ch in range(C):
                        w.put(int(zz[ch][s]), bits[ch])
        elif plan.block_type == BlockDataType.COMPRESSDATA:
            if plan.device_parts is not None or os.environ.get("SLA_TPU_DEVICE_ENTROPY"):
                # the payload K8 coded with the filter chunk, or this block
                # alone on the encoder's device; byte-identical to the host
                # coder (a set SLA_TPU_DEVICE_ENTROPY, whatever its value,
                # takes this writer, as in the reference)
                w.put_bytes(
                    rice_device.encode_block_payload_device(
                        plan.residual, plan.init_rice, parts=plan.device_parts,
                        device=self.device,
                    )
                )
            elif use_native:
                w.put_bytes(native.put_data_array(plan.residual, plan.init_rice))
            else:
                rice.put_data_array(w, plan.init_rice, list(plan.residual), plan.num_samples)
        w.flush()
        size = w.tell()
        crc_region = w.getvalue()[SLA_BLOCK_CRC16_CALC_START_OFFSET:]
        crc = crc16(crc_region)
        w.write_bytes_at(2, (size - 6).to_bytes(4, "big"))
        w.write_bytes_at(6, crc.to_bytes(2, "big"))
        return w.getvalue()


def encode_whole_batch(
    jobs: list[tuple["WaveFormat", "EncodeParameter", np.ndarray]],
    config: EncoderConfig | None = None,
    device=None,
) -> list[bytes]:
    """Encode many files with ONE fused filter batch.

    jobs: (wave_format, encode_param, pcm) per file. All encode parameters
    must share the filter orders and max block size (one preset); channel
    counts, rates, and depths may differ. Per-file planning/analysis and
    container emission stay per file (streams are byte-identical to
    per-file `encode_whole`), but every file's blocks go through the filter
    + pitch stage as a single (rows, L) batch: the corpus-scale batch axis
    the device backend parallelizes. `device` is every job's encoder
    device, as in `Encoder` (None: the CUDA card)."""
    if not jobs:
        return []
    config = config or EncoderConfig()
    device = resolve_device(device)
    encs: list[Encoder] = []
    staged: list[tuple[int, list[_BlockPlan]]] = []
    ref_ep = jobs[0][1]
    for wf, ep, data in jobs:
        if (
            ep.parcor_order != ref_ep.parcor_order
            or ep.longterm_order != ref_ep.longterm_order
            or ep.lms_order_per_filter != ref_ep.lms_order_per_filter
            or ep.max_num_block_samples != ref_ep.max_num_block_samples
        ):
            raise SLAError(
                ApiResult.INVALID_ARGUMENT,
                "batched encode requires one preset's filter orders across jobs",
            )
        enc = Encoder(config, device=device)
        enc.set_wave_format(wf)
        enc.set_encode_parameter(ep)
        encs.append(enc)
        staged.append(enc._stage_encode(data))
    groups = [
        (
            enc._wave_format.num_channels,
            [pl for pl in plans if pl.block_type == BlockDataType.COMPRESSDATA],
        )
        for enc, (_, plans) in zip(encs, staged)
    ]
    # the batch bypasses _run_filters, which resets the mode per run; the
    # attach step sets it when K8 coded this batch's payloads
    encs[0]._device_entropy_active = False
    encs[0].filter_chunks = []  # the batch's chunks, recorded on encs[0]
    encs[0]._run_filter_groups(groups)
    # the filter run (and a possible device-entropy attach) happened on
    # encs[0]; every job's finalize must observe the same mode so attached
    # parts are consumed instead of re-coded by the native path
    for enc in encs[1:]:
        enc._device_entropy_active = encs[0]._device_entropy_active
    blobs = [
        enc._finalize_encode(num_samples, plans)
        for enc, (num_samples, plans) in zip(encs, staged)
    ]
    # config.verify applies to the fused path too, as encode_whole runs it
    for enc, blob, (_, _, data) in zip(encs, blobs, jobs):
        enc._maybe_verify(blob, data)
    return blobs
