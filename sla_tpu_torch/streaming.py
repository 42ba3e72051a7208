"""Streaming decoder: incremental, fixed-rate playback decode.

Mirrors the reference streaming API (src/SLADecoder.c:752-1123): the caller
appends data fragments, asks for size/sample estimates, and pulls
``ceil(1.05 * rate / interval_hz)`` samples per ``decode()`` call. Decoding
crosses block boundaries; filter and entropy state persist across calls and
reset only at block starts (the resumability invariant, SLADecoder.c:637-639).

The per-chunk synthesis runs through the native C++ filter chain
(sla_native.cpp `sla_synth_chunk`) with explicit carried state — the
low-latency host path of the TPU split (the batched device path is for bulk
decode; a ~370-sample tick is latency-bound, not throughput-bound).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import hostref, native
from .bitio import BitReader, uint32_to_sint32
from .constants import (
    LONGTERM_MAX_PERIOD,
    LONGTERM_PERIOD_NUM_BITS,
    SLA_BLOCK_CRC16_CALC_START_OFFSET,
    SLA_BLOCK_SYNC_CODE,
    SLA_MIN_BLOCK_NUM_SAMPLES,
    BlockDataType,
    ChannelProcessMethod,
    parcor_quantize_bit_width,
)
from .crc16 import crc16
from .dsp.channel import ms_to_lr_int32
from .errors import ApiResult, SLAError
from .format import EncodeParameter, WaveFormat

from .constants import (  # noqa: E402  (canonical copies, SLAInternal.h:21-26)
    SLA_MINIMUM_BLOCK_HEADER_SIZE,
    STREAMING_DECODE_MAX_NUM_PACKETS,
    STREAMING_DECODE_NUM_SAMPLES_MARGIN,
)

_LT_HIST_LEN = LONGTERM_MAX_PERIOD + 2


def _payload_cursor(init_params, num_channels, bit_offset):
    """Native resumable entropy cursor, or the pure-Python twin when the
    native library is unavailable (reference streaming decode is portable C,
    src/SLADecoder.c:752-1123 — no toolchain dependency)."""
    if native.available():
        return native.PayloadCursor(init_params, num_channels, bit_offset)
    return hostref.PyPayloadCursor(init_params, num_channels, bit_offset)


def _get_raw(stream, bit_offset, C, N, bits_per_ch):
    if native.available():
        return native.get_raw(stream, bit_offset, C, N, bits_per_ch)
    return hostref.py_get_raw(stream, bit_offset, C, N, bits_per_ch)


def _synth_chunk_rows(*args, **kw):
    if native.available():
        return native.synth_chunk_rows(*args, **kw)
    return hostref.py_synth_chunk_rows(*args, **kw)


def calculate_sufficient_block_size(
    num_channels: int, num_samples: int, bit_per_sample: int
) -> int:
    """SLA_CalculateSufficientBlockSize (include/public/SLA.h:22-23):
    2 * channels * samples * (bps / 8), integer division as in the macro."""
    return 2 * num_channels * num_samples * (bit_per_sample // 8)


class DataPacketQueue:
    """Fixed-capacity queue of borrowed data fragments with three cursors
    (write/read/collect), zero-copy semantics mapped to Python
    (reference: SLADataPacketQueue_*, src/SLAUtility.c:699-897).

    Fragments are enqueued whole, consumed (`get_fragment`) in bounded
    bites, and reclaimed (`dequeue`) once fully consumed.
    """

    def __init__(self, capacity: int = STREAMING_DECODE_MAX_NUM_PACKETS):
        self.capacity = capacity
        self._packets: list[list] = []  # [data, used]
        self._remaining = 0  # running sum of unconsumed bytes (O(1) queries)

    def enqueue(self, data: bytes) -> None:
        if len(self._packets) >= self.capacity:
            raise SLAError(ApiResult.EXCEED_HANDLE_CAPACITY, "packet queue full")
        self._packets.append([data, 0])
        self._remaining += len(data)

    def enqueue_consumed(self, data: bytes) -> None:
        """Enqueue a packet the caller has already copied out in full, so
        only the collect cursor ever sees it (the zero-copy fast path of
        append_data_fragment)."""
        if len(self._packets) >= self.capacity:
            raise SLAError(ApiResult.EXCEED_HANDLE_CAPACITY, "packet queue full")
        self._packets.append([data, len(data)])

    def get_fragment(self, max_size: int) -> bytes | None:
        """Consume up to max_size bytes from the oldest unconsumed packet."""
        for pkt in self._packets:
            data, used = pkt
            if used < len(data):
                take = min(max_size, len(data) - used)
                if take == 0:
                    return None
                pkt[1] = used + take
                self._remaining -= take
                return data[used : used + take]
        return None

    def dequeue(self) -> bytes | None:
        """Reclaim the oldest fully-consumed packet."""
        if self._packets and self._packets[0][1] >= len(self._packets[0][0]):
            return self._packets.pop(0)[0]
        return None

    def remaining_size(self) -> int:
        return self._remaining


@dataclasses.dataclass
class StreamingDecoderConfig:
    """Create-time config (SLADecoder.h:29-35)."""

    core: "DecoderConfig" = None  # type: ignore[assignment]
    decode_interval_hz: float = 120.0
    max_bit_per_sample: int = 32

    def __post_init__(self):
        from .decoder import DecoderConfig

        if self.core is None:
            self.core = DecoderConfig()
        if self.decode_interval_hz <= 0.0:
            raise SLAError(ApiResult.INVALID_ARGUMENT, "bad decode interval")
        # < 8 makes the bytes/sample estimate 0 (ZeroDivision in
        # estimate_decodable_num_samples) and a zero-size feed buffer
        if not 8 <= self.max_bit_per_sample <= 32:
            raise SLAError(
                ApiResult.INVALID_ARGUMENT, "max_bit_per_sample must be in [8, 32]"
            )


@dataclasses.dataclass
class _BlockHeader:
    block_size: int
    num_samples: int
    block_type: BlockDataType
    parcor_coef: np.ndarray | None = None
    pitch: np.ndarray | None = None
    ltm_coef: np.ndarray | None = None
    init_rice: "list[int] | np.ndarray | None" = None
    header_bytes: int = 0  # bytes consumed by the header incl. alignment
    coef_body: np.ndarray | None = None  # memoized contiguous coef[:, 1:]


class StreamingDecoder:
    def __init__(self, config: StreamingDecoderConfig | None = None):
        self.config = config or StreamingDecoderConfig()
        self._wave_format: WaveFormat | None = None
        self._encode_param: EncodeParameter | None = None
        self.queue = DataPacketQueue()
        cc = self.config.core
        self._buffer_size = 2 * calculate_sufficient_block_size(
            cc.max_num_channels, cc.max_num_block_samples, self.config.max_bit_per_sample
        )
        # fixed-capacity feed buffer: a preallocated uint8 array with an
        # explicit fill length. Unlike a bytearray it never reallocates, so
        # its data pointer is stable for the native tick's lifetime and no
        # per-tick frombuffer/export bookkeeping exists; block-end trims
        # memmove the (small) unconsumed tail down once per block.
        self._buf_arr = np.empty(self._buffer_size, dtype=np.uint8)
        self._buf_mv = memoryview(self._buf_arr)  # cheap memcpy writes
        self._buf_ptr = self._buf_arr.ctypes.data
        self._buf_len = 0
        self._estimated_bytes_per_sample = float(
            cc.max_num_channels * (self.config.max_bit_per_sample // 8)
        )
        self._min_need_cache: int | None = None  # estimate_minimum_… memo
        self._samples_per_decode = 0
        self._block: _BlockHeader | None = None
        self._block_sample_offset = 0
        self._pending_drop = 0  # unreceived tail bytes of a finished block
        self._consumed_bits = 0  # payload cursor within the current block
        self._filter_state: dict | None = None
        self._payload_cursor: native.PayloadCursor | None = None
        self._tick = None  # prebound per-block native synth (native.StreamTick)
        # persistent cross-block objects (native path): the one-FFI-call
        # header parser with reused field arrays, the entropy cursor
        # (reinit()ed in place each block), the StreamTick bound once to the
        # parser/cursor/filter-state storage, and its contiguous coef copy
        self._hdr_parser: native.StreamHeaderParser | None = None
        self._cursor_obj: native.PayloadCursor | None = None
        self._tick_obj = None
        self._tick_coef: np.ndarray | None = None
        # decode(out=) validation memo: a strong reference to the last
        # caller buffer plus its (width, data pointer | -1 when rows are
        # not inner-contiguous, row stride in elements) — the held
        # reference keeps the pointer valid
        self._out_cache: np.ndarray | None = None
        self._out_cache_w = 0
        self._out_cache_ptr = -1
        self._out_cache_stride = 0
        self._out_cache_shape: tuple = ()
        self._out_cache_strides: tuple = ()

    def seek(self, index, sample: int, *, data=None) -> tuple[int, int]:
        """Position streaming playback at `sample` using a StreamIndex
        (Decoder.build_index or StreamIndex.from_bytes — beyond the
        reference, which can only play a stream from the top).

        Adopts the index's wave format / encode parameters, resets the
        decoder (queued packets drop), and returns (byte_offset,
        samples_to_skip): feed the stream's bytes from `byte_offset` — a
        block boundary, since every filter/entropy state resets there
        (SLADecoder.c:569-581) — and discard the first `samples_to_skip`
        decoded samples to land exactly on `sample`. A seek at/past the
        stream end returns (stream_size, 0) with nothing to decode.

        `data` (optional): the stream bytes (or any >=43-byte prefix of
        them) the caller will feed from. When given, the index's recorded
        stream size and 43-byte header must match or
        SLAError(INVALID_ARGUMENT) is raised — the same identity check Decoder.decode_range performs.
        Without it the caller is responsible for pairing the index with its
        own stream: a mismatched pair yields a byte offset into the wrong
        file (block sync/CRC on feed catches most, but not all with
        enable_crc_check=False)."""
        if data is not None:
            h = len(index.header_bytes)
            mv = memoryview(data)
            full = len(mv) >= index.stream_size
            if (len(mv) < h
                    or bytes(mv[:h]) != index.header_bytes
                    or (full and len(mv) != index.stream_size)):
                raise SLAError(
                    ApiResult.INVALID_ARGUMENT,
                    "seek: StreamIndex does not match this stream "
                    "(header/size mismatch)")
        self.set_wave_format(index.header.wave_format)
        self.set_encode_parameter(index.header.encode_param)
        self.reset()
        starts = index.sample_starts
        total = int(starts[-1])
        sample = max(0, min(int(sample), total))
        if sample >= total:
            return index.stream_size, 0
        i = int(np.searchsorted(starts, sample, side="right")) - 1
        if index.blocks is not None:
            off = int(index.blocks[i].data_offset)
        else:
            off = int(index.block_offsets[i])
        return off, sample - int(starts[i])

    def reset(self) -> None:
        """Reset stream position and buffers (SLAStreamingDecoder_Reset,
        SLADecoder.c:735-749). Queued packets are dropped."""
        self._buf_len = 0
        self._block = None
        self._block_sample_offset = 0
        self._pending_drop = 0
        self._consumed_bits = 0
        self._filter_state = None
        self._payload_cursor = None
        self._tick = None
        self._cursor_obj = None
        self._tick_obj = None
        self.queue = DataPacketQueue()
        self._drop_out_cache()

    def _drop_out_cache(self) -> None:
        self._out_cache = None
        self._out_cache_w = 0
        self._out_cache_ptr = -1
        self._out_cache_stride = 0

    def _invalidate_stream_objects(self) -> None:
        """Drop every cross-block cached object whose shape/binding depends
        on the wave format or encode parameters — including any IN-FLIGHT
        block: a reconfiguration mid-block cannot resume it (the filter
        state and cursor bindings are gone), so the block/cursor state must
        go too or the next decode() would synthesize with None state."""
        self._hdr_parser = None
        self._cursor_obj = None
        self._tick_obj = None
        self._tick_coef = None
        self._filter_state = None
        self._tick = None
        self._block = None
        self._block_sample_offset = 0
        self._consumed_bits = 0
        self._pending_drop = 0
        self._payload_cursor = None
        # the decode(out=) memo is format-dependent too: its row-count
        # check (shape[0] == C) ran against the OLD channel count, so a
        # cached buffer must be re-validated before its raw pointer is
        # written through again
        self._drop_out_cache()

    # -- parameter setting ---------------------------------------------------
    def set_wave_format(self, wf: WaveFormat) -> None:
        cc = self.config.core
        if wf.num_channels > cc.max_num_channels or wf.bit_per_sample > 32:
            raise SLAError(ApiResult.EXCEED_HANDLE_CAPACITY)
        if wf.bit_per_sample > self.config.max_bit_per_sample:
            raise SLAError(ApiResult.EXCEED_HANDLE_CAPACITY)
        # reference debug-assert made load-bearing (SLADecoder.c:464,549-550):
        # out-of-range lshift from a corrupt header must fail structurally,
        # not shift by >=32 in the synthesis assembly
        if wf.num_channels <= 0:
            raise SLAError(ApiResult.INVALID_ARGUMENT,
                           "num_channels must be positive")
        if (wf.bit_per_sample <= 0 or wf.offset_lshift < 0
                or wf.offset_lshift >= wf.bit_per_sample):
            raise SLAError(ApiResult.INVALID_ARGUMENT,
                           "offset_lshift must be < bit_per_sample")
        self._wave_format = dataclasses.replace(wf)
        self._invalidate_stream_objects()
        self._samples_per_decode = int(
            math.ceil(
                STREAMING_DECODE_NUM_SAMPLES_MARGIN
                * float(wf.sampling_rate)
                / self.config.decode_interval_hz
            )
        )
        self._min_need_cache = None

    def set_encode_parameter(self, ep: EncodeParameter) -> None:
        cc = self.config.core
        if (
            ep.parcor_order > cc.max_parcor_order
            or ep.longterm_order > cc.max_longterm_order
            or ep.lms_order_per_filter > cc.max_lms_order_per_filter
            or ep.max_num_block_samples > cc.max_num_block_samples
            or ep.max_num_block_samples < SLA_MIN_BLOCK_NUM_SAMPLES
        ):
            raise SLAError(ApiResult.EXCEED_HANDLE_CAPACITY)
        if ep.longterm_order > 5 or (ep.longterm_order and ep.longterm_order % 2 == 0):
            # same structural reject as Decoder.set_encode_parameter: the
            # reference requires odd tap counts <= 5 (SLAPredictor.c:808-810,
            # main.c:94-98) and the native kernels size their scratch by it
            raise SLAError(ApiResult.INVALID_ARGUMENT,
                           "longterm_order must be odd and <= 5")
        self._encode_param = dataclasses.replace(ep)
        self._invalidate_stream_objects()

    def _require_params(self) -> None:
        if self._wave_format is None or self._encode_param is None:
            raise SLAError(ApiResult.PARAMETER_NOT_SET)
        if (
            self._encode_param.ch_process_method == ChannelProcessMethod.STEREO_MS
            and self._wave_format.num_channels != 2
        ):
            # crafted mono+MS headers must fail structurally, not IndexError
            # in the RAWDATA bits table / geometry-reject in the native tick
            raise SLAError(ApiResult.INVALID_CHPROCESSMETHOD)

    # -- estimates (SLADecoder.c:863-935) ------------------------------------
    def output_samples_per_decode(self) -> int:
        return self._samples_per_decode

    def estimate_minimum_necessary_data_size(self) -> int:
        # memoized: the inputs change only at set_wave_format / block parse
        est = self._min_need_cache
        if est is None:
            est = int(
                math.ceil(self._estimated_bytes_per_sample * self._samples_per_decode)
            )
            est = max(est, SLA_MINIMUM_BLOCK_HEADER_SIZE)
            self._min_need_cache = est
        return est

    def estimate_decodable_num_samples(self) -> int:
        return int(self.remaining_data_size() / self._estimated_bytes_per_sample)

    def remaining_data_size(self) -> int:
        buffer_remain = self._buf_len
        if self._block is not None:
            buffer_remain -= self._block.header_bytes + (self._consumed_bits + 7) // 8
        return self.queue.remaining_size() + max(buffer_remain, 0)


    def _buffer_view(self) -> np.ndarray:
        """Zero-copy uint8 view of the buffered bytes (reads only; the
        backing array is preallocated and never reallocates)."""
        return self._buf_arr[: self._buf_len]

    def _buffer_trim(self, take: int) -> None:
        """Drop the first `take` buffered bytes (block-end advance), then
        pull queued backlog into the freed space — without the drain, a
        burst-fed stream (one huge fragment) livelocks: the caller follows
        the reference's feed contract (append only while
        remaining_data_size() < estimate), the queue still holds bytes the
        contract counts, but nothing ever moves them into the feed buffer
        (the reference pulls fragments during Decode the same way,
        SLADecoder.c:1076-1089)."""
        keep = self._buf_len - take
        if keep > 0:
            # same-buffer overlap: route through a bytes copy (slice
            # assignment does not guarantee memmove semantics)
            self._buf_mv[:keep] = bytes(self._buf_mv[take : self._buf_len])
        self._buf_len = keep
        if self.queue._remaining:
            self._drain_queue()

    def _drain_queue(self) -> None:
        """Move queued fragment bytes into the feed buffer's free space."""
        q = self.queue
        while True:
            frag = q.get_fragment(self._buffer_size - self._buf_len)
            if frag is None:
                break
            k = len(frag)
            self._buf_mv[self._buf_len : self._buf_len + k] = frag
            self._buf_len += k

    # -- data supply ----------------------------------------------------------
    def append_data_fragment(self, data: bytes) -> None:
        n = len(data)
        q = self.queue
        if q._remaining == 0 and n <= self._buffer_size - self._buf_len:
            # fast path (the steady 120 Hz case): no queued backlog and the
            # fragment fits whole — one memcpy into the feed buffer, packet
            # recorded as already-consumed for collect_data_fragments
            q.enqueue_consumed(data)
            end = self._buf_len + n
            self._buf_mv[self._buf_len : end] = data
            self._buf_len = end
            return
        q.enqueue(data)
        self._drain_queue()

    def collect_data_fragments(self) -> list[bytes]:
        out = []
        while True:
            pkt = self.queue.dequeue()
            if pkt is None:
                break
            out.append(pkt)
        return out

    # -- block header parse (streaming variant of Decoder.parse_block_header) --
    def _parse_block_header(self) -> _BlockHeader:
        wf, ep = self._wave_format, self._encode_param
        if native.available():
            # one FFI call reading straight from the feed buffer (the
            # pure-Python parse below is its bit-exact twin, kept for the
            # toolchain-free path); field arrays are the parser's persistent
            # storage, overwritten at the next block transition
            hp = self._hdr_parser
            if hp is None:
                hp = self._hdr_parser = native.StreamHeaderParser(
                    wf.num_channels, ep.parcor_order, ep.longterm_order,
                    wf.bit_per_sample, self.config.core.enable_crc_check,
                )
            rc = hp.parse(self._buf_ptr, self._buf_len)
            if rc == -9:
                # header extends past the buffered bytes: wait for more
                # (decode() catches IndexError exactly like the Python
                # parse's BitReader over-read)
                raise IndexError("block header extends past buffered data")
            if rc == -12:
                raise SLAError(ApiResult.FAILED_TO_FIND_SYNC_CODE)
            if rc != 0:
                raise SLAError(ApiResult.DETECT_DATA_CORRUPTION)
            m = hp.meta
            blk = _BlockHeader(
                int(m[0]), int(m[1]), BlockDataType(int(m[2])),
                header_bytes=int(m[3]),
            )
            if blk.block_type == BlockDataType.COMPRESSDATA:
                blk.parcor_coef = hp.coef
                blk.pitch = hp.pitch
                blk.ltm_coef = hp.ltm
                blk.init_rice = hp.init_rice
            return blk
        data = self._buf_arr[: self._buf_len].tobytes()
        r = BitReader(data)
        sync = r.get(16)
        if sync != SLA_BLOCK_SYNC_CODE:
            raise SLAError(ApiResult.FAILED_TO_FIND_SYNC_CODE)
        next_offset = r.get(32)
        block_size = next_offset + 6
        stored_crc = r.get(16)
        if self.config.core.enable_crc_check and block_size <= len(data):
            calc = crc16(memoryview(data)[SLA_BLOCK_CRC16_CALC_START_OFFSET:block_size])
            if calc != stored_crc:
                raise SLAError(ApiResult.DETECT_DATA_CORRUPTION)
        num_samples = r.get(16)
        type_bits = r.get(2)
        if type_bits > 2:  # only COMPRESS/SILENT/RAW exist (SLAInternal.h:67-72)
            raise SLAError(ApiResult.DETECT_DATA_CORRUPTION)
        if num_samples == 0:  # no real encoder emits empty blocks
            raise SLAError(ApiResult.DETECT_DATA_CORRUPTION)
        btype = BlockDataType(type_bits)
        blk = _BlockHeader(block_size, num_samples, btype)
        if btype == BlockDataType.COMPRESSDATA:
            C, p, T = wf.num_channels, ep.parcor_order, ep.longterm_order
            coef = np.zeros((C, p + 1), dtype=np.int32)
            pitch = np.zeros(C, dtype=np.int32)
            ltm = np.zeros((C, max(T, 1)), dtype=np.int32)
            init_rice: list[int] = []
            for ch in range(C):
                rshift = r.get(4)
                for ord_ in range(1, p + 1):
                    qbits = parcor_quantize_bit_width(ord_)
                    v = uint32_to_sint32(r.get(qbits))
                    coef[ch, ord_] = (np.int32(v) << (16 - qbits)) >> rshift
                if r.get(1):
                    pitch[ch] = r.get(LONGTERM_PERIOD_NUM_BITS)
                    if pitch[ch] < T // 2 + 1 or pitch[ch] > 256:
                        # out of any real encoder's range (same verdict as
                        # Decoder.parse_block_header / the native twin)
                        raise SLAError(ApiResult.DETECT_DATA_CORRUPTION)
                    for t in range(T):
                        q15 = uint32_to_sint32(r.get(16))
                        ltm[ch, t] = np.int32(q15) << 16
                init_rice.append(r.get(wf.bit_per_sample))
            blk.parcor_coef = coef
            blk.pitch = pitch
            blk.ltm_coef = ltm
            blk.init_rice = init_rice
        r.flush()
        blk.header_bytes = r.tell()
        if blk.header_bytes > blk.block_size:
            # header larger than its own declared block (native twin: -11)
            raise SLAError(ApiResult.DETECT_DATA_CORRUPTION)
        return blk

    def _reset_filter_state(self) -> None:
        """Block-start synthesizer reset (SLADecoder.c:569-581, mandatory).

        Zeroes IN PLACE when the dict exists: a prebound StreamTick holds
        raw pointers into these arrays, so their storage must stay put
        across blocks (shape-changing reconfiguration goes through
        _invalidate_stream_objects, which drops the dict)."""
        st = self._filter_state
        if st is not None:
            for a in st.values():
                a.fill(0)
            return
        wf, ep = self._wave_format, self._encode_param
        C, p, M = wf.num_channels, ep.parcor_order, ep.lms_order_per_filter
        self._filter_state = {
            "lattice": np.zeros((C, p + 1), dtype=np.int32),
            "lt_hist": np.zeros((C, _LT_HIST_LEN), dtype=np.int32),
            "lt_processed": np.zeros((C, 1), dtype=np.int32),
            "lms": np.zeros((C, 4 * M), dtype=np.int32),
            "lms_processed": np.zeros((C, 1), dtype=np.int32),
            "deemph": np.zeros((C, 1), dtype=np.int32),
        }

    def _bind_tick(self) -> None:
        """Prebind the native fused decode tick for the current block
        (native.StreamTick: cursor + state pointers captured once, one FFI
        call per tick doing read + underrun rollback + synthesis). None on
        the pure-Python path and for RAWDATA/SILENT blocks.

        The StreamTick object itself is built ONCE per stream: it binds the
        persistent header-parser field arrays, the reinit()able cursor, and
        the in-place-reset filter state, so a block transition costs one
        small coef copy plus the use_golomb slot update."""
        self._tick = None
        blk = self._block
        if (
            blk.block_type != BlockDataType.COMPRESSDATA
            or not isinstance(self._payload_cursor, native.PayloadCursor)
            or self._hdr_parser is None
        ):
            return
        tick = self._tick_obj
        if tick is None:
            wf, ep = self._wave_format, self._encode_param
            hp = self._hdr_parser
            st = self._filter_state
            self._tick_coef = np.zeros(
                (wf.num_channels, ep.parcor_order), dtype=np.int32
            )
            tick = self._tick_obj = native.StreamTick(
                self._payload_cursor,
                self._tick_coef,  # contiguous persistent copy target
                st["lattice"],
                hp.pitch,
                hp.ltm,
                ep.longterm_order,
                st["lt_hist"],
                st["lt_processed"],
                ep.lms_order_per_filter,
                st["lms"],
                st["lms_processed"],
                st["deemph"],
                ms=ep.ch_process_method == ChannelProcessMethod.STEREO_MS,
                shift=32 - wf.bit_per_sample + wf.offset_lshift,
            )
        self._tick_coef[:] = blk.parcor_coef[:, 1:]
        tick.set_use_golomb(self._payload_cursor.use_golomb)
        self._tick = tick

    def _snapshot_state(self) -> dict:
        # cursor-only: every _decode_wave_data path checks for underrun
        # BEFORE running the filter cascade, so on the rollback exception
        # only the entropy cursor and consumed-bits count have been mutated
        snap: dict = {"consumed_bits": self._consumed_bits}
        if self._payload_cursor is not None:
            snap["cursor_pos"] = int(self._payload_cursor.bit_pos.value)
            snap["cursor_params"] = self._payload_cursor.param_state.copy()
        return snap

    def _restore_state(self, snap: dict) -> None:
        self._consumed_bits = snap["consumed_bits"]
        if self._payload_cursor is not None and "cursor_pos" in snap:
            self._payload_cursor.bit_pos.value = snap["cursor_pos"]
            # copy INTO the live array (not a rebind): the native reader is
            # bound to its data pointer
            self._payload_cursor.param_state[:] = snap["cursor_params"]

    def _worst_case_header_bytes(self) -> int:
        """Upper bound on a COMPRESSDATA block header's byte size for the
        configured stream parameters."""
        wf, ep = self._wave_format, self._encode_param
        per_ch = 4 + sum(parcor_quantize_bit_width(o) for o in range(1, ep.parcor_order + 1))
        per_ch += 1 + LONGTERM_PERIOD_NUM_BITS + 16 * ep.longterm_order
        per_ch += wf.bit_per_sample
        # fixed prefix: sync 16 + next-offset 32 + crc 16 + num_samples 16
        # + block-type 2 = 82 bits (SLAEncoder.c:685-737 layout)
        bits = 82 + wf.num_channels * per_ch
        return (bits + 7) // 8

    # -- core decode -----------------------------------------------------------
    def decode(
        self, max_samples: int | None = None, out: np.ndarray | None = None
    ) -> np.ndarray:
        """Decode the next batch; returns (C, n) canonical int32 PCM with
        n = min(max_samples, samples-per-decode, what's decodable).

        `out`, when given, is a caller-owned (C, >= n) int32 buffer the
        samples land in (the return value is a view of it) — the
        reference's Decode writes into a caller buffer the same way
        (SLADecoder.h:92-101); omitting it allocates per call.

        Like the reference (SLADecoder.c:1008-1097), decoding proceeds
        through *partially buffered* blocks: the caller keeps the buffer fed
        per `estimate_minimum_necessary_data_size`, and an actual underrun
        raises INSUFFICIENT_DATA_SIZE."""
        self._require_params()
        wf = self._wave_format
        C = wf.num_channels
        goal = self._samples_per_decode
        if max_samples is not None:
            goal = min(goal, max_samples)
        if out is None:
            out = np.empty((C, goal), dtype=np.int32)  # [:progress] written
            out_w, out_ptr, out_stride = goal, out.ctypes.data, goal
        elif out is self._out_cache:
            out_w, out_ptr, out_stride = self._cached_out(out, C, goal)
        else:
            out_w, out_ptr, out_stride = self._validate_out(out, C, goal)
        if out_w < goal:
            raise SLAError(
                ApiResult.INVALID_ARGUMENT, f"out must be int32 ({C}, >={goal})"
            )
        # fast path — the steady mid-block 120 Hz tick: prebound native
        # tick, whole request inside the current block, caller rows
        # inner-contiguous. One native call; on underrun nothing was
        # mutated.
        if out_ptr > 0:
            n = self._tick_fast(out_ptr, goal, out_stride)
            if n is not None:
                if n == 0:
                    return out[:, :0]  # underrun: caller feeds and retries
                return out if out_w == goal else out[:, :goal]
        progress = 0
        while progress < goal:
            if self._pending_drop:
                take = min(self._pending_drop, self._buf_len)
                self._buffer_trim(take)
                self._pending_drop -= take
                if self._pending_drop:
                    if self._buf_len == 0:
                        break  # still waiting for the previous block's tail
                    continue  # the trim drained more queued bytes: keep going
            if self._block is None:
                if self._buf_len < SLA_MINIMUM_BLOCK_HEADER_SIZE:
                    break  # not even a block header yet
                # block size is in bytes 2..5; require the (bounded) header
                bsize = int.from_bytes(self._buf_arr[2:6].tobytes(), "big") + 6
                if self._buf_len < min(bsize, self._worst_case_header_bytes()):
                    break
                # header parse gets the same wait-and-resume discipline as
                # payload decode: an over-read (only possible if the
                # worst-case bound were ever violated) waits for more data
                # instead of corrupting state — nothing is mutated until
                # the parse returns
                try:
                    self._block = self._parse_block_header()
                except IndexError:
                    break
                self._block_sample_offset = 0
                self._consumed_bits = 0
                self._reset_filter_state()
                if self._block.block_type == BlockDataType.COMPRESSDATA:
                    cur = self._cursor_obj
                    if cur is not None:
                        # persistent native cursor: reseed in place so the
                        # prebound StreamTick's pointers stay valid
                        cur.reinit(
                            self._block.init_rice, self._block.header_bytes * 8
                        )
                        self._payload_cursor = cur
                    else:
                        self._payload_cursor = _payload_cursor(
                            self._block.init_rice, C, self._block.header_bytes * 8
                        )
                        if isinstance(self._payload_cursor, native.PayloadCursor):
                            self._cursor_obj = self._payload_cursor
                self._bind_tick()
                # update the bytes/sample estimate from real block stats
                # (SLADecoder.c:1042-1044)
                self._estimated_bytes_per_sample = (
                    float(self._block.block_size) / self._block.num_samples
                )
                self._min_need_cache = None
            blk = self._block
            n = min(goal - progress, blk.num_samples - self._block_sample_offset)
            if n == 0:
                break
            # snapshot the entropy cursor so a mid-chunk underrun can be
            # rolled back instead of corrupting the decode (the fused native
            # tick rolls itself back, so the fast path skips this)
            snap = None if self._tick is not None else self._snapshot_state()
            # common tick shape (whole call served by one mid-block chunk):
            # the native tick lands straight in the caller's buffer
            dest = (
                out
                if progress == 0 and n == out_w and out_stride == n and out_ptr > 0
                else None
            )
            try:
                chunk = self._decode_wave_data(n, dest)
            except SLAError as e:
                if e.result == ApiResult.INSUFFICIENT_DATA_SIZE:
                    if snap is not None:
                        self._restore_state(snap)
                    break  # caller feeds more data and retries
                raise
            if chunk is not dest:
                out[:, progress : progress + n] = chunk
            progress += n
            self._block_sample_offset += n
            if self._block_sample_offset >= blk.num_samples:
                self._end_block(blk)
        return out[:, :progress]

    def _validate_out(self, out: np.ndarray, C: int, goal: int) -> tuple:
        """Validate a caller decode buffer and memoize (width, base pointer
        or -1 when rows are not inner-contiguous, row stride in elements)."""
        if (
            out.dtype != np.int32
            or out.ndim != 2
            or out.shape[0] != C
            or out.shape[1] < goal
            or not out.flags.writeable
        ):
            raise SLAError(
                ApiResult.INVALID_ARGUMENT,
                f"out must be a writeable int32 ({C}, >={goal})",
            )
        out_w = out.shape[1]
        st = out.strides
        if st[1] == 4 and st[0] % 4 == 0 and st[0] >= 0:
            out_ptr = out.ctypes.data
            out_stride = st[0] // 4
        else:
            out_ptr, out_stride = -1, 0
        self._out_cache = out
        self._out_cache_w = out_w
        self._out_cache_ptr = out_ptr
        self._out_cache_stride = out_stride
        self._out_cache_shape = out.shape
        self._out_cache_strides = st
        return out_w, out_ptr, out_stride

    def _cached_out(self, out: np.ndarray, C: int, goal: int) -> tuple:
        """Memoized validation lookup, re-checking the properties the
        caller can legally mutate IN PLACE between calls: writability
        (a frozen buffer must not be written through its raw pointer) and
        the shape/strides metadata (numpy allows `out.shape = ...`
        reassignment on the same object — a stale layout would scatter the
        strided native writes). Any layout change falls back to full
        validation and re-memoizes. Residual trust: resize(refcheck=False)
        swapping the allocation while restoring an identical layout is
        undetectable without re-reading the data pointer every call."""
        if not out.flags.writeable:
            raise SLAError(
                ApiResult.INVALID_ARGUMENT, "out buffer is no longer writeable"
            )
        if (out.dtype != np.int32
                or out.shape != self._out_cache_shape
                or out.strides != self._out_cache_strides):
            # dtype included: numpy allows in-place same-itemsize dtype
            # reassignment on the cached object (out.dtype = np.float32),
            # which would misinterpret the raw int32 writes
            return self._validate_out(out, C, goal)
        return self._out_cache_w, self._out_cache_ptr, self._out_cache_stride

    def _tick_fast(self, out_ptr: int, goal: int, out_stride: int) -> int | None:
        """Shared steady-tick body for decode()/decode_into(): one native
        strided call landing `goal` samples at `out_ptr`, advancing the
        cursor and block state. Returns goal, 0 on underrun (nothing was
        mutated), or None when the fast path does not apply (no prebound
        tick, block boundary inside the request, pending drop)."""
        blk = self._block
        tick = self._tick
        if (
            tick is None
            or blk is None
            or self._pending_drop
            or blk.num_samples - self._block_sample_offset < goal
        ):
            return None
        if tick.run_strided(self._buf_ptr, self._buf_len, out_ptr, goal, out_stride):
            return 0
        self._consumed_bits = int(tick.bit_pos_view[0]) - blk.header_bytes * 8
        off = self._block_sample_offset + goal
        if off >= blk.num_samples:
            self._end_block(blk)
        else:
            self._block_sample_offset = off
        return goal

    def decode_into(
        self, out: np.ndarray, offset: int = 0, max_samples: int | None = None
    ) -> int:
        """decode() landing the samples at COLUMN `offset` of the caller's
        (C, >= offset+n) int32 array, returning the sample count — the
        zero-copy whole-stream loop (the reference's Decode writes through
        a `buffer + offset` pointer the same way, SLADecoder.h:92-101).
        On the steady mid-block tick this is one native call writing the
        rows at the array's own stride; underrun returns 0 with nothing
        consumed, exactly like decode() returning an empty chunk."""
        self._require_params()
        if offset < 0:
            raise SLAError(ApiResult.INVALID_ARGUMENT, "offset must be non-negative")
        wf = self._wave_format
        C = wf.num_channels
        goal = self._samples_per_decode
        if max_samples is not None:
            goal = min(goal, max_samples)
        if out is self._out_cache:
            out_w, out_ptr, out_stride = self._cached_out(out, C, goal + offset)
        else:
            out_w, out_ptr, out_stride = self._validate_out(out, C, goal + offset)
        if out_w - offset < goal:
            raise SLAError(
                ApiResult.INVALID_ARGUMENT,
                f"out must be int32 ({C}, >={offset + goal})",
            )
        if out_ptr > 0:
            n = self._tick_fast(out_ptr + 4 * offset, goal, out_stride)
            if n is not None:
                return n  # 0 = underrun: caller feeds and retries
        # general path (block boundaries, RAW/SILENT blocks, no native,
        # non-contiguous rows): decode into a fresh chunk and copy
        chunk = self.decode(max_samples=goal)
        n = chunk.shape[1]
        if n:
            out[:, offset : offset + n] = chunk
        return n

    def _end_block(self, blk: _BlockHeader) -> None:
        """Finished block: drop its bytes (any unreceived tail is skipped
        as it arrives via _pending_drop), then the next decode re-parses."""
        take = min(blk.block_size, self._buf_len)
        self._buffer_trim(take)
        self._pending_drop = blk.block_size - take
        self._block = None
        self._block_sample_offset = 0
        self._payload_cursor = None
        self._tick = None

    def _decode_wave_data(
        self, n: int, dest: np.ndarray | None = None
    ) -> np.ndarray:
        """Resumable mid-block decode of n samples (SLADecoder_DecodeWaveData).

        `dest`: optional contiguous (C, n) landing buffer for the fused
        native tick (the caller skips its copy when the return IS dest)."""
        wf, ep = self._wave_format, self._encode_param
        C = wf.num_channels
        blk = self._block
        shift = 32 - wf.bit_per_sample + wf.offset_lshift

        if self._tick is not None:
            # prebound fast path: the WHOLE tick (entropy read + underrun
            # check/rollback + synthesis) is one native call; on underrun
            # nothing was mutated, so decode() needs no snapshot here.
            # The (C, n) landing buffer is an internal scratch (its contents
            # are copied into the caller's array immediately by decode());
            # the native tick needs CONTIGUOUS rows, so carve (C, n) from a
            # flat pool rather than column-slicing a wider 2-D array
            if dest is not None and dest.shape == (C, n):
                out = dest
            else:
                scr = getattr(self, "_tick_scratch", None)
                if scr is None or scr.size < C * n:
                    scr = np.empty(C * max(n, self._samples_per_decode),
                                   dtype=np.int32)
                    self._tick_scratch = scr
                out = scr[: C * n].reshape(C, n)
            status = self._tick.run_ptr(self._buf_ptr, self._buf_len, out)
            if status:
                raise SLAError(ApiResult.INSUFFICIENT_DATA_SIZE, "streaming underrun")
            self._consumed_bits = int(self._payload_cursor.bit_pos.value) - blk.header_bytes * 8
            return out

        if blk.block_type == BlockDataType.SILENT:
            # the cascade maps zero residual + zero state to zero output and
            # leaves the state zero (state reset at block start), so silent
            # ticks short-circuit — bit-identical to running the filters
            return np.zeros((C, n), dtype=np.int32)
        if blk.block_type == BlockDataType.RAWDATA:
            bits = [wf.bit_per_sample - wf.offset_lshift] * C
            if ep.ch_process_method == ChannelProcessMethod.STEREO_MS:
                bits[1] += 1
            start_bit = blk.header_bytes * 8 + self._consumed_bits
            # zero-copy view, same as the COMPRESSDATA branch below — the
            # per-tick bytes() copy was O(buffer) at 120 Hz
            residual = _get_raw(self._buffer_view(), start_bit, C, n, bits)
            self._consumed_bits += n * sum(bits)
            if blk.header_bytes * 8 + self._consumed_bits > 8 * self._buf_len:
                raise SLAError(ApiResult.INSUFFICIENT_DATA_SIZE, "streaming underrun")
            pcm = residual
            if ep.ch_process_method == ChannelProcessMethod.STEREO_MS:
                left, right = ms_to_lr_int32(pcm[0], pcm[1])
                pcm = np.stack([left, right])
            return (pcm.astype(np.int32) << shift).astype(np.int32)
        else:
            # zero-copy view of the feed buffer for the native read (the
            # per-tick bytes() copy was O(buffer) every 120 Hz tick); the
            # view must not outlive this call — the bytearray is resized by
            # append/advance and an open export would make those raise
            residual = self._payload_cursor.read(self._buffer_view(), n)
            self._consumed_bits = int(self._payload_cursor.bit_pos.value) - blk.header_bytes * 8

        # underrun detection: the bit reader zero-fills past the buffered
        # end, so consuming beyond it means the feed contract was violated
        if blk.header_bytes * 8 + self._consumed_bits > 8 * self._buf_len:
            raise SLAError(ApiResult.INSUFFICIENT_DATA_SIZE, "streaming underrun")

        st = self._filter_state
        # COMPRESSDATA always carries coef/pitch/ltm (parse sets them);
        # memoize the contiguous coefficient body once per block instead of
        # re-slicing it every 120 Hz tick
        if blk.coef_body is None:
            blk.coef_body = np.ascontiguousarray(blk.parcor_coef[:, 1:])
        # ONE fused call for every channel's cascade + MS inverse + shift:
        # per-channel FFI crossings dominate small 120 Hz tick chunks
        return _synth_chunk_rows(
            residual,
            blk.coef_body,
            st["lattice"],
            blk.pitch,
            blk.ltm_coef,
            ep.longterm_order,
            st["lt_hist"],
            st["lt_processed"],
            ep.lms_order_per_filter,
            st["lms"],
            st["lms_processed"],
            st["deemph"],
            ms=ep.ch_process_method == ChannelProcessMethod.STEREO_MS,
            shift=shift,
        )
