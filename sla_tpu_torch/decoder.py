"""SLA decoder: host entropy stage + the synthesis cascade on a torch device
(counterpart of sla_tpu/decoder.py, copied from it; only the branches that
reached jax differ).

Decode strategy (vs. the strictly sequential reference, SLADecoder.c:660-732):

1. Walk the stream once using each block header's next-block offset field —
   O(num_blocks) header peeks give every block's byte extent up front.
2. Entropy-decode all block payloads (independent per block — the format
   byte-aligns and CRC-frames each block): on the host, or on the card with
   K9 straight into the synthesis rows when the synthesis runs there.
3. Run the whole synthesis chain (LMS -> long-term -> lattice -> de-emphasis)
   as ONE batched device stage over (blocks x channels, L): the reference
   resets all synthesizers at every block start (SLADecoder.c:637-639), which
   is exactly what makes blocks independent and batchable.
4. Inverse MS + final left shift, vectorized.

Backends as in sla_tpu_torch.encoder: the device branch of step 3 is the
port's decode stage (K3) on the decoder's torch device, and step 2 then
runs there too (K9) unless DecoderConfig.device_entropy='off'. The mesh
branch splits step 3's rows over a mesh of devices (parallel/), K3 on
every shard; K9 still decodes on the decoder's device, and its rows go
to the shards device to device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import native, pipeline, rice, rice_device
from .bitio import BitReader, uint32_to_sint32
from .constants import (
    CODER_LOW_THRESHOLD_PARAMETER,
    LONGTERM_PERIOD_NUM_BITS,
    SLA_BLOCK_CRC16_CALC_START_OFFSET,
    SLA_MINIMUM_BLOCK_HEADER_SIZE,
    SLA_BLOCK_SYNC_CODE,
    SLA_HEADER_SIZE,
    SLA_MIN_BLOCK_NUM_SAMPLES,
    BlockDataType,
    ChannelProcessMethod,
    parcor_quantize_bit_width,
)
from .crc16 import crc16
from .dsp.channel import ms_to_lr_int32
from .errors import ApiResult, SLAError
from .encoder import resolve_device
from .format import EncodeParameter, HeaderInfo, WaveFormat, decode_header
from .parallel import sharding


@dataclasses.dataclass
class DecoderConfig:
    """Create-time capacity maxima (SLADecoder.h:14-25)."""

    max_num_channels: int = 8
    max_num_block_samples: int = 16384
    max_parcor_order: int = 48
    max_longterm_order: int = 5
    max_lms_order_per_filter: int = 40
    enable_crc_check: bool = True
    verbose: bool = False
    backend: str = "auto"  # 'auto' | 'device' | 'mesh' | 'host' (see EncoderConfig)
    # on-card entropy decode (mirror of EncoderConfig.device_entropy): when
    # the synthesis batch runs on the device backend, the recursive-Rice
    # payloads decode there too (K9), into the rows the synthesis reads.
    # 'off' disables; SLA_TPU_DEVICE_ENTROPY forces it on any backend.
    device_entropy: str = "auto"


@dataclasses.dataclass
class _Block:
    data_offset: int  # byte offset of the block in the stream
    block_size: int  # total bytes
    num_samples: int
    block_type: BlockDataType
    parcor_coef: np.ndarray | None = None  # (C, p+1) int32
    pitch: np.ndarray | None = None  # (C,) int32
    ltm_coef: np.ndarray | None = None  # (C, T) int32 Q31
    init_rice: list[int] | None = None
    payload_bit_offset: int = 0  # absolute bit offset of the residual payload


@dataclasses.dataclass
class StreamIndex:
    """Reusable random-access index over one stream (Decoder.build_index).

    Holds every block's parsed header plus cumulative sample offsets, so a
    seek costs one binary search instead of re-walking (and re-CRC-verifying)
    the whole stream. Valid only for the exact byte string it was built
    from: decode_range rejects a different length or stream header, and —
    with CRC checking enabled — re-verifies the CRCs of just the blocks the
    window touches (O(window)), so in-body corruption past the cheap
    identity check still raises DETECT_DATA_CORRUPTION.

    An index persists across processes via to_bytes()/from_bytes(): the
    sidecar stores only each block's byte extent and sample count, and a
    loaded index carries `blocks=None` — decode_range then re-parses JUST
    the window's block headers from the stream (O(window)), so a seek
    server skips the whole-stream walk entirely at startup."""

    header: HeaderInfo
    blocks: list[_Block] | None  # None for an index loaded via from_bytes
    sample_starts: np.ndarray  # (num_blocks + 1,) int64 cumulative samples
    stream_size: int
    header_bytes: bytes  # the 43-byte stream header, for mismatch detection
    block_offsets: np.ndarray | None = None  # (n,) int64 byte offsets (lazy)
    block_sizes: np.ndarray | None = None  # (n,) int64 byte sizes (lazy)

    _MAGIC = b"SLIX"
    _VERSION = 1

    def to_bytes(self) -> bytes:
        """Compact sidecar serialization (big-endian like the codec):
        magic, version, stream size, the 43-byte stream header, and per
        block (byte offset u64, byte size u32, sample count u32), closed
        by the format's CRC16 over everything before it."""
        if self.blocks is not None:
            offs = [b.data_offset for b in self.blocks]
            sizes = [b.block_size for b in self.blocks]
        else:
            offs = [int(v) for v in self.block_offsets]
            sizes = [int(v) for v in self.block_sizes]
        ns = np.diff(self.sample_starts)
        parts = [
            self._MAGIC,
            bytes([self._VERSION]),
            int(self.stream_size).to_bytes(8, "big"),
            self.header_bytes,
            len(offs).to_bytes(4, "big"),
            np.asarray(offs, dtype=">u8").tobytes(),
            np.asarray(sizes, dtype=">u4").tobytes(),
            ns.astype(">u4").tobytes(),
        ]
        body = b"".join(parts)
        return body + crc16(body).to_bytes(2, "big")

    @classmethod
    def from_bytes(
        cls, blob: bytes, data: bytes, enable_crc_check: bool = True
    ) -> "StreamIndex":
        """Load a to_bytes() sidecar for the stream `data`, validating the
        sidecar CRC, the stream identity (length + 43-byte header), and
        the block extents (contiguous from the stream header, in-bounds,
        sample counts summing to the header total). The returned index is
        lazy (`blocks=None`). enable_crc_check=False tolerates a damaged
        stream-header CRC, matching DecoderConfig.enable_crc_check.

        Trust model: the CRC frame catches accidental corruption (storage
        rot, truncation), and decode_range cross-checks every parsed
        block against the recorded extents — a bad sidecar cannot crash,
        read out of bounds, or return PCM from the wrong bytes. It CANNOT
        authenticate a deliberately forged sidecar: per-block sample
        counts are only verifiable for blocks a window actually parses,
        so treat sidecar files with exactly the same trust as the stream
        bytes they index."""
        h = SLA_HEADER_SIZE
        if len(blob) < 4 + 1 + 8 + h + 4 + 2:
            raise SLAError(ApiResult.INSUFFICIENT_DATA_SIZE, "index too short")
        if blob[:4] != cls._MAGIC or blob[4] != cls._VERSION:
            raise SLAError(ApiResult.INVALID_ARGUMENT, "not a stream index")
        if crc16(blob[:-2]) != int.from_bytes(blob[-2:], "big"):
            raise SLAError(ApiResult.DETECT_DATA_CORRUPTION, "index CRC mismatch")
        stream_size = int.from_bytes(blob[5:13], "big")
        header_bytes = blob[13 : 13 + h]
        n = int.from_bytes(blob[13 + h : 17 + h], "big")
        need = 17 + h + 16 * n + 2
        if len(blob) != need:
            raise SLAError(ApiResult.INVALID_ARGUMENT, "index length mismatch")
        p = 17 + h
        offs = np.frombuffer(blob, dtype=">u8", count=n, offset=p).astype(np.int64)
        sizes = np.frombuffer(blob, dtype=">u4", count=n, offset=p + 8 * n).astype(np.int64)
        ns = np.frombuffer(blob, dtype=">u4", count=n, offset=p + 12 * n).astype(np.int64)
        if stream_size != len(data) or bytes(data[:h]) != header_bytes:
            raise SLAError(
                ApiResult.INVALID_ARGUMENT, "index does not match this stream"
            )
        header, status = decode_header(data)
        if status == ApiResult.DETECT_DATA_CORRUPTION and enable_crc_check:
            raise SLAError(ApiResult.DETECT_DATA_CORRUPTION, "header CRC mismatch")
        ends = offs + sizes
        # the sum check runs even for n == 0 (a zero-block sidecar for a
        # non-empty stream must be rejected, not crash decode_range later);
        # extents must be CONTIGUOUS from the stream header — gaps would
        # let a corrupt sidecar silently omit blocks
        if int(ns.sum()) != header.num_samples:
            raise SLAError(ApiResult.INVALID_ARGUMENT, "index extents invalid")
        if n and (
            offs[0] != h
            or np.any(offs[1:] != ends[:-1])
            or np.any(ends > stream_size)
            or np.any(sizes <= 0)
        ):
            raise SLAError(ApiResult.INVALID_ARGUMENT, "index extents invalid")
        starts = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(ns, out=starts[1:])
        return cls(
            header=header,
            blocks=None,
            sample_starts=starts,
            stream_size=stream_size,
            header_bytes=bytes(header_bytes),
            block_offsets=offs,
            block_sizes=sizes,
        )


@dataclasses.dataclass
class SalvageSegment:
    """One contiguous run of intact blocks recovered by decode_salvage."""

    byte_offset: int  # where the run starts in the stream
    gap_before_bytes: int  # corrupt bytes skipped to reach it (0 for first)
    sample_offset: int | None  # exact only when known (first intact run)
    pcm: np.ndarray  # (C, n) canonical int32


def _block_crc_ok(data, offset: int, block_size: int) -> bool:
    """Verify one block's CRC16: stored big-endian at bytes offset+6..8,
    computed from SLA_BLOCK_CRC16_CALC_START_OFFSET to the block end — the
    single wire-format CRC layout (SLAEncoder.c:787-795), shared by the
    header parse and the index-reuse re-verification."""
    stored = int.from_bytes(bytes(data[offset + 6 : offset + 8]), "big")
    calc = crc16(
        memoryview(data)[
            offset + SLA_BLOCK_CRC16_CALC_START_OFFSET : offset + block_size
        ]
    )
    return calc == stored


def _synth_group_rows(C: int, L: int) -> int:
    """Blocks per bounded synthesis group (~100 MB of (rows, L) int32):
    shared by the grouped entropy decode and the synthesis batching so the
    premade zero-copy layout always matches."""
    return max(1, (100 << 20) // (C * L * 4))


def _fill_block_filter_rows(blk, bi: int, C: int, coef, pitch, ltm, lengths):
    """One block's C rows of the batched synthesis parameters — the single
    layout both the fused and general decode paths consume (keeping them
    bit-identical to each other)."""
    coef[bi * C : (bi + 1) * C] = blk.parcor_coef[:, 1:]
    pitch[bi * C : (bi + 1) * C] = blk.pitch
    ltm[bi * C : (bi + 1) * C] = blk.ltm_coef
    lengths[bi * C : (bi + 1) * C] = blk.num_samples


class Decoder:
    def __init__(self, config: DecoderConfig | None = None, device=None):
        self.config = config or DecoderConfig()
        self.device = resolve_device(device)
        self._wave_format: WaveFormat | None = None
        self._encode_param: EncodeParameter | None = None

    def set_wave_format(self, wf: WaveFormat) -> None:
        if wf.num_channels > self.config.max_num_channels or wf.bit_per_sample > 32:
            raise SLAError(ApiResult.EXCEED_HANDLE_CAPACITY)
        # the reference only debug-asserts these (SLADecoder.c:549-550,
        # compiled out under NDEBUG); a corrupt header with a re-stamped CRC
        # would otherwise drive an out-of-range left shift (UB) through the
        # final `<< (32 - bps + lshift)` assembly — found by UBSan fuzzing
        if wf.num_channels <= 0:
            raise SLAError(ApiResult.INVALID_ARGUMENT,
                           "num_channels must be positive")
        if (wf.bit_per_sample <= 0 or wf.offset_lshift < 0
                or wf.offset_lshift >= wf.bit_per_sample):
            raise SLAError(ApiResult.INVALID_ARGUMENT,
                           "offset_lshift must be < bit_per_sample")
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
        self._encode_param = dataclasses.replace(ep)

    def _require_params(self):
        if self._wave_format is None or self._encode_param is None:
            raise SLAError(ApiResult.PARAMETER_NOT_SET)
        if (
            self._encode_param.ch_process_method == ChannelProcessMethod.STEREO_MS
            and self._wave_format.num_channels != 2
        ):
            raise SLAError(ApiResult.INVALID_CHPROCESSMETHOD)

    # -- block header parsing (SLADecoder.c:309-420) ---------------------------
    def parse_block_header(self, data: bytes, offset: int) -> _Block:
        try:
            return self._parse_block_header_impl(data, offset)
        except IndexError:
            # the bit reader ran off the end of a truncated buffer
            raise SLAError(ApiResult.INSUFFICIENT_DATA_SIZE) from None

    def _parse_block_header_impl(self, data: bytes, offset: int) -> _Block:
        wf, ep = self._wave_format, self._encode_param
        r = BitReader(data)
        r.seek_bytes(offset)
        sync = r.get(16)
        if sync != SLA_BLOCK_SYNC_CODE:
            raise SLAError(ApiResult.FAILED_TO_FIND_SYNC_CODE)
        next_offset = r.get(32)
        block_size = next_offset + 6
        r.get(16)  # stored CRC16 (verified from the raw bytes below)
        if self.config.enable_crc_check and offset + block_size <= len(data):
            if not _block_crc_ok(data, offset, block_size):
                raise SLAError(ApiResult.DETECT_DATA_CORRUPTION)
        num_samples = r.get(16)
        type_bits = r.get(2)
        if type_bits > 2:  # only COMPRESS/SILENT/RAW exist
            raise SLAError(ApiResult.DETECT_DATA_CORRUPTION)
        if num_samples == 0:  # no real encoder emits empty blocks
            raise SLAError(ApiResult.DETECT_DATA_CORRUPTION)
        if num_samples > ep.max_num_block_samples:
            # a (re-stampable) CRC cannot protect against crafted counts:
            # an oversized one would overflow the (C, max_block) synthesis
            # batch fill with a bare ValueError instead of a structured
            # reject — and crash decode_salvage, which only catches SLAError
            raise SLAError(ApiResult.DETECT_DATA_CORRUPTION)
        btype = BlockDataType(type_bits)
        blk = _Block(offset, block_size, num_samples, btype)
        if btype == BlockDataType.COMPRESSDATA:
            C = wf.num_channels
            p = ep.parcor_order
            T = ep.longterm_order
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
                        # out of any real encoder's range: corruption (and a
                        # non-positive feedback lag would stall synthesis)
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
        blk.payload_bit_offset = r.tell() * 8
        # a block whose declared size cannot hold its own header would put
        # the payload cursor into the next block's bytes (native twin
        # returns -11 at the same program point)
        if r.tell() - offset > blk.block_size:
            raise SLAError(ApiResult.DETECT_DATA_CORRUPTION)
        return blk

    def scan_blocks(self, data: bytes, num_samples: int) -> list[_Block]:
        """Walk the stream once, collecting every block's header."""
        wf, ep = self._wave_format, self._encode_param
        if native.available():
            res = native.parse_block_headers(
                data, SLA_HEADER_SIZE, num_samples, wf.num_channels,
                ep.parcor_order, ep.longterm_order, wf.bit_per_sample,
                self.config.enable_crc_check,
                max_block_samples=ep.max_num_block_samples,
            )
            err = res["error"]
            if err == -12:
                raise SLAError(ApiResult.FAILED_TO_FIND_SYNC_CODE)
            if err == -11:
                raise SLAError(ApiResult.DETECT_DATA_CORRUPTION)
            if err < 0:
                raise SLAError(ApiResult.INSUFFICIENT_DATA_SIZE)
            blocks = []
            for i in range(res["num_blocks"]):
                blk = _Block(
                    int(res["offsets"][i]), int(res["sizes"][i]),
                    int(res["num_samples"][i]), BlockDataType(int(res["types"][i])),  # native parser rejects type 3
                )
                if blk.block_type == BlockDataType.COMPRESSDATA:
                    blk.parcor_coef = res["coef"][i]
                    blk.pitch = res["pitch"][i]
                    blk.ltm_coef = res["ltm"][i]
                    blk.init_rice = [int(v) for v in res["init_rice"][i]]
                blk.payload_bit_offset = int(res["payload_bits"][i])
                blocks.append(blk)
            return blocks
        blocks: list[_Block] = []
        offset = SLA_HEADER_SIZE
        done = 0
        while done < num_samples:
            if offset + SLA_MINIMUM_BLOCK_HEADER_SIZE > len(data):
                raise SLAError(ApiResult.INSUFFICIENT_DATA_SIZE)
            blk = self.parse_block_header(data, offset)
            if blk.block_size > len(data) - offset:
                raise SLAError(ApiResult.INSUFFICIENT_DATA_SIZE)
            blocks.append(blk)
            offset += blk.block_size
            done += blk.num_samples
        return blocks

    # -- payload entropy decode ------------------------------------------------
    def _decode_payload(self, data: bytes, blk: _Block) -> np.ndarray:
        """Returns (C, n) int32: residual for COMPRESSDATA, samples for
        RAWDATA, zeros for SILENT."""
        try:
            return self._decode_payload_impl(data, blk)
        except IndexError:
            # pure-Python bit reader ran off a truncated/corrupt payload;
            # the native reader zero-fills and reports the over-read —
            # surface the same structured error here
            raise SLAError(ApiResult.INSUFFICIENT_DATA_SIZE) from None

    def _decode_payload_impl(self, data: bytes, blk: _Block) -> np.ndarray:
        wf, ep = self._wave_format, self._encode_param
        C = wf.num_channels
        n = blk.num_samples
        if blk.block_type == BlockDataType.SILENT:
            return np.zeros((C, n), dtype=np.int32)
        use_native = native.available()
        if blk.block_type == BlockDataType.RAWDATA:
            bits = [wf.bit_per_sample - wf.offset_lshift] * C
            if ep.ch_process_method == ChannelProcessMethod.STEREO_MS:
                bits[1] += 1
            if use_native:
                return native.get_raw(data, blk.payload_bit_offset, C, n, bits)
            r = BitReader(data, bit_offset=blk.payload_bit_offset)
            out = np.empty((C, n), dtype=np.int32)
            for s in range(n):
                for ch in range(C):
                    out[ch, s] = uint32_to_sint32(r.get(bits[ch]))
            return out
        if use_native:
            return native.get_data_array(data, blk.payload_bit_offset, C, n, blk.init_rice)
        r = BitReader(data, bit_offset=blk.payload_bit_offset)
        res = rice.get_data_array(r, blk.init_rice, C, n)
        return np.stack(res)

    def _select_backend(self, row_samples: int) -> str:
        return pipeline.select_backend(self.config.backend, row_samples, self.device)

    def _device_entropy_on(self, backend: str) -> bool:
        """Decode twin of Encoder._device_entropy_on: on-card symbol decode
        whenever the synthesis batch runs on the device backend;
        SLA_TPU_DEVICE_ENTROPY forces it regardless (the batch then lands
        on the host once for the host synthesis cascade — see
        _decode_blocks). One shared definition with the encoder:
        pipeline.device_entropy_on."""
        return pipeline.device_entropy_on(self.config, backend)

    def _device_entropy_group(
        self, data: bytes, grp: list, comp: list[int], L: int,
        words: torch.Tensor | None = None,
    ) -> torch.Tensor | None:
        """On-card entropy decode of one synthesis group's COMPRESSDATA
        payloads (K9, rice_device.decode_blocks_payload_device): returns the
        (rows, L) residual batch on the decoder's device in the synthesis
        layout, or None when the host coder should take the whole group
        (most of its blocks sit on the static-Golomb branch — cross-channel
        mean effective parameter <= 8, the split the encoder uses).
        Straggler blocks — a minority of Golomb blocks, or any payload that
        K9 flagged (only corrupt streams do) — are decoded on the host and
        scattered into the device batch with one index_copy_, so one quiet
        passage does not knock the whole group off the card.

        words: rice_device.upload_stream(data, device), uploaded once per
        decode call by _decode_blocks and shared across its groups."""
        C = self._wave_format.num_channels
        nb = len(comp)
        inits = np.asarray([grp[i].init_rice for i in comp], dtype=np.uint32).reshape(nb, C)
        golomb = np.asarray([rice_device.is_golomb_block(grp[i].init_rice) for i in comp])
        rice_j = np.flatnonzero(~golomb)
        if 2 * len(rice_j) < nb:
            return None  # mostly static-Golomb content: the host coder takes it
        offs = np.asarray([grp[i].payload_bit_offset for i in comp], dtype=np.int64)
        bits = np.asarray(
            [(grp[i].data_offset + grp[i].block_size) * 8 - grp[i].payload_bit_offset
             for i in comp],
            dtype=np.int64,
        )
        counts = np.asarray([grp[i].num_samples for i in comp], dtype=np.int32)
        if words is None:
            words = rice_device.upload_stream(data, self.device)
        # every block rides K9, the Golomb ones too: their rows are
        # overwritten below, and B stays the group's block count
        res, bad = rice_device.decode_blocks_payload_device(
            data, offs, bits, counts, inits, C, L, words_arr=words,
        )
        host_j = np.concatenate([np.flatnonzero(golomb), rice_j[bad[rice_j]]])
        if host_j.size:
            # the host coder's rows for the stragglers, in one scatter: a
            # flagged block gets the reference's output for a corrupt payload
            hb = np.zeros((host_j.size, C, L), dtype=np.int32)
            for k, j in enumerate(host_j):
                blk = grp[comp[int(j)]]
                hb[k, :, : blk.num_samples] = self._decode_payload(data, blk)
            res.index_copy_(0, torch.from_numpy(host_j).to(res.device),
                            torch.from_numpy(hb).to(res.device))
        return res.view(nb * C, L)

    # -- whole-stream decode -----------------------------------------------------
    def decode_block(self, data: bytes, offset: int = 0) -> tuple[np.ndarray, int]:
        """Decode ONE block starting at byte `offset` (SLADecoder_DecodeBlock,
        SLADecoder.c:584-657): block-header parse (sync + CRC verify),
        payload decode, full synthesis chain, MS inverse, final left shift.
        The caller owns the wave format / encode parameters (set_* first),
        exactly like the reference's block-level API. Returns
        ((C, n) canonical int32 PCM, bytes consumed)."""
        self._require_params()
        blk = self.parse_block_header(data, offset)
        if blk.block_size > len(data) - offset:
            # the declared size is NOT covered by the block CRC (it sits in
            # bytes 2..6, before the CRC's own field): an inflated value
            # would skip CRC verification above (parse only CRCs when the
            # range fits) and return a consumed count past the buffer
            raise SLAError(ApiResult.INSUFFICIENT_DATA_SIZE)
        payload = self._decode_payload(data, blk)
        pcm = self.synthesize_blocks([blk], [payload])[0]
        return pcm, blk.block_size

    def _open_stream(self, data: bytes) -> HeaderInfo:
        """Shared preamble of every whole-stream decode entry point:
        parse + CRC-gate the 43-byte stream header, adopt its format and
        encode parameters."""
        header, status = decode_header(data)
        if status == ApiResult.DETECT_DATA_CORRUPTION and self.config.enable_crc_check:
            raise SLAError(ApiResult.DETECT_DATA_CORRUPTION, "header CRC mismatch")
        self.set_wave_format(header.wave_format)
        self.set_encode_parameter(header.encode_param)
        self._require_params()
        return header

    def decode_whole(
        self, data: bytes, out: np.ndarray | None = None
    ) -> tuple[HeaderInfo, np.ndarray]:
        """Returns (header, (C, num_samples) canonical int32 PCM).

        out: optional preallocated (C, num_samples) C-contiguous writable
        int32 buffer the PCM lands in directly — the bulk twin of
        StreamingDecoder.decode_into for servers that decode into a reused
        arena instead of allocating hundreds of MB per call. The returned
        PCM array IS `out` when given."""
        header = self._open_stream(data)
        if out is not None:
            expect = (self._wave_format.num_channels, header.num_samples)
            if (
                not isinstance(out, np.ndarray)
                or out.dtype != np.int32
                or out.shape != expect
                or not out.flags.c_contiguous
                or not out.flags.writeable
            ):
                raise SLAError(
                    ApiResult.INVALID_ARGUMENT,
                    f"out must be a writable C-contiguous int32 {expect} array",
                )

        import time

        self.stage_times: dict[str, float] = {}
        t0 = time.perf_counter()
        blocks = self.scan_blocks(data, header.num_samples)
        self.stage_times["headers"] = time.perf_counter() - t0
        out = self._decode_blocks(data, blocks, header.num_samples, out)
        if self.config.verbose:
            st = self.stage_times
            print(
                "stages: "
                + "  ".join(f"{k} {v * 1e3:.1f}ms" for k, v in st.items())
                + f"  total {sum(st.values()) * 1e3:.1f}ms"
            )
        return header, out

    def build_index(self, data: bytes) -> StreamIndex:
        """One header walk (sync + CRC verify per block under the config's
        CRC setting) producing a reusable StreamIndex: repeated
        decode_range calls over the same stream then seek by binary search
        instead of re-scanning the whole stream each time."""
        header = self._open_stream(data)
        blocks = self.scan_blocks(data, header.num_samples)
        starts = np.zeros(len(blocks) + 1, dtype=np.int64)
        np.cumsum([b.num_samples for b in blocks], out=starts[1:])
        return StreamIndex(
            header=header,
            blocks=blocks,
            sample_starts=starts,
            stream_size=len(data),
            header_bytes=bytes(data[:SLA_HEADER_SIZE]),
        )

    def decode_range(
        self,
        data: bytes,
        start_sample: int,
        num_samples: int,
        index: StreamIndex | None = None,
    ) -> tuple[HeaderInfo, np.ndarray]:
        """Random-access decode: (header, (C, n) PCM) for the sample window
        [start_sample, start_sample + num_samples), clamped to the stream.

        Blocks are independent (every filter/entropy state resets at a
        block start, SLADecoder.c:569-581), so only the blocks overlapping
        the window are entropy-decoded and synthesized — a seek into an
        hour-long stream costs one header walk plus O(window) work, and
        with a prebuilt `index` (build_index) the walk drops to one binary
        search. The reference API has no equivalent (whole-stream or
        120 Hz streaming only); bytes produced are identical to the
        decode_whole slice."""
        if start_sample < 0 or num_samples < 0:
            raise SLAError(ApiResult.INVALID_ARGUMENT, "negative range")

        import time

        reused_index = index is not None
        if reused_index:
            if len(data) != index.stream_size or bytes(
                data[:SLA_HEADER_SIZE]
            ) != index.header_bytes:
                raise SLAError(
                    ApiResult.INVALID_ARGUMENT, "index does not match this stream"
                )
            self.set_wave_format(index.header.wave_format)
            self.set_encode_parameter(index.header.encode_param)
            self._require_params()
            self.stage_times = {"headers": 0.0}
        else:
            t0 = time.perf_counter()
            index = self.build_index(data)
            self.stage_times = {"headers": time.perf_counter() - t0}
        header, blocks, starts = index.header, index.blocks, index.sample_starts
        start = min(start_sample, header.num_samples)
        end = min(start_sample + num_samples, header.num_samples)
        C = self._wave_format.num_channels
        if start >= end:
            return header, np.empty((C, 0), dtype=np.int32)
        # covering block run: block i spans [starts[i], starts[i+1])
        i0 = int(np.searchsorted(starts, start, side="right")) - 1
        i1 = int(np.searchsorted(starts, end, side="left"))
        if blocks is not None:
            sel = blocks[i0:i1]
        else:
            # lazy index (StreamIndex.from_bytes): parse JUST the window's
            # block headers from the stream (sync + CRC verified under this
            # decoder's config by parse_block_header), cross-checking each
            # against the sidecar's recorded extent/sample count
            sel = []
            for k in range(i0, i1):
                blk = self.parse_block_header(data, int(index.block_offsets[k]))
                if blk.block_size != int(index.block_sizes[k]) or (
                    blk.num_samples != int(starts[k + 1] - starts[k])
                ):
                    raise SLAError(
                        ApiResult.DETECT_DATA_CORRUPTION,
                        "stream disagrees with the loaded index",
                    )
                sel.append(blk)
        if not sel:
            return header, np.empty((C, 0), dtype=np.int32)
        if blocks is not None and reused_index and self.config.enable_crc_check:
            # the cheap identity check above cannot see in-body mutations,
            # and the index may have been built by a CRC-off decoder —
            # re-verify the selected blocks under THIS decoder's config
            # (O(window), the whole point of the index is skipping the
            # O(stream) walk)
            for b in sel:
                if not _block_crc_ok(data, b.data_offset, b.block_size):
                    raise SLAError(ApiResult.DETECT_DATA_CORRUPTION)
        first_pos = int(starts[i0])
        covered = sum(b.num_samples for b in sel)
        out = self._decode_blocks(data, sel, covered)
        lo = start - first_pos
        return header, out[:, lo : lo + (end - start)]

    def decode_salvage(
        self, data: bytes
    ) -> tuple[HeaderInfo, list["SalvageSegment"]]:
        """Best-effort decode of a DAMAGED stream: parse blocks until one
        fails (bad sync / CRC mismatch / truncation), then hunt forward for
        the next block whose sync code parses — and, with CRC checking on,
        whose block CRC verifies — and keep decoding from there. The
        reference aborts at the first corrupt block (SLADecoder.c:660-732);
        this recovers every intact block after the damage.

        Returns (header, segments): each segment's `pcm` is bit-exact with
        the originally encoded blocks it covers. `sample_offset` is exact
        for the first segment (0) and None after a gap — block headers
        carry no absolute positions, so later anchors are unknowable in
        general. With a SINGLE gap the tail anchor is recoverable as
        header.num_samples - last_segment_samples. A fully intact stream
        returns one segment equal to decode_whole's PCM."""
        header = self._open_stream(data)
        segments: list[SalvageSegment] = []
        run: list[_Block] = []
        run_start = SLA_HEADER_SIZE
        gap_before = 0
        offset = SLA_HEADER_SIZE
        done = 0
        # undecodable bytes at the TAIL of a flushed run (payload-damaged
        # blocks with nothing after them in the run): they belong to the
        # NEXT segment's gap_before_bytes, or are simply trailing damage
        carry_gap = [0]

        def flush() -> None:
            if not run:
                return
            try:
                total = sum(b.num_samples for b in run)
                segments.append(
                    SalvageSegment(
                        byte_offset=run_start,
                        gap_before_bytes=gap_before,
                        sample_offset=0 if not segments and gap_before == 0 else None,
                        pcm=self._decode_blocks(data, run, total),
                    )
                )
                return
            except SLAError:
                pass
            # a false-sync anchor (or payload damage block CRC checking was
            # disabled for) can poison the grouped decode — salvage must
            # not drop the intact blocks around it. Decode block-by-block,
            # coalescing consecutive successes.
            sub_pcms: list[np.ndarray] = []
            sub_start = run_start
            sub_gap = gap_before
            pending_gap = 0
            pos_b = run_start

            def emit() -> None:
                nonlocal sub_pcms, sub_gap
                if sub_pcms:
                    segments.append(
                        SalvageSegment(
                            byte_offset=sub_start,
                            gap_before_bytes=sub_gap,
                            sample_offset=0 if not segments and sub_gap == 0 else None,
                            pcm=np.concatenate(sub_pcms, axis=1),
                        )
                    )
                    sub_pcms = []
                    sub_gap = 0

            for b in run:
                try:
                    one = self._decode_blocks(data, [b], b.num_samples)
                except SLAError:
                    one = None
                if one is not None:
                    if not sub_pcms:
                        sub_start = pos_b
                        sub_gap += pending_gap
                        pending_gap = 0
                    sub_pcms.append(one)
                else:
                    emit()
                    pending_gap += b.block_size
                pos_b += b.block_size
            emit()
            carry_gap[0] += pending_gap  # tail damage: next segment's gap

        while done < header.num_samples and (
            offset + SLA_MINIMUM_BLOCK_HEADER_SIZE <= len(data)
        ):
            try:
                blk = self.parse_block_header(data, offset)
                if blk.block_size > len(data) - offset:
                    raise SLAError(ApiResult.INSUFFICIENT_DATA_SIZE)
            except SLAError:
                # resync: scan for the next parseable (and CRC-valid, when
                # checking) block header — payload bytes can contain false
                # 0xFFFF syncs, so each candidate must fully validate
                flush()
                run, found = [], None
                pos = offset + 1
                # each candidate validation can CRC up to its declared
                # block size, so cap the attempts per gap — crafted
                # sync-dense junk must not turn recovery quadratic
                budget = 65536
                while found is None and budget > 0:
                    pos = data.find(b"\xff\xff", pos)
                    if pos < 0 or pos + SLA_MINIMUM_BLOCK_HEADER_SIZE > len(data):
                        break
                    budget -= 1
                    try:
                        cand = self.parse_block_header(data, pos)
                        if cand.block_size <= len(data) - pos:
                            found = cand
                    except SLAError:
                        pass
                    pos += 1 if found is None else 0
                if found is None:
                    break  # no further intact block (or hunt budget spent)
                gap_before = carry_gap[0] + (pos - offset)
                carry_gap[0] = 0
                run_start = pos
                offset = pos
                blk = found
            run.append(blk)
            offset += blk.block_size
            done += blk.num_samples
        flush()
        return header, segments

    def _decode_blocks(
        self, data: bytes, blocks: list, total: int,
        out: np.ndarray | None = None,
    ) -> np.ndarray:
        """Entropy-decode + synthesize a run of blocks into a (C, total)
        canonical int32 PCM array (total = sum of their sample counts) —
        a fresh allocation, or the caller's pre-validated `out` buffer;
        the grouped native pipeline when available."""
        import time

        wf, ep = self._wave_format, self._encode_param
        total_samples = total
        if not hasattr(self, "stage_times"):
            self.stage_times = {}
        if native.available():
            # bounded groups: entropy-decode, synthesize, and assemble each
            # group of blocks before touching the next, so peak memory is
            # O(group) (~100 MB of synthesis rows) even for hour-long
            # streams; per-block arithmetic is untouched (blocks are
            # independent), so bytes/PCM are identical to one-shot decode
            C = wf.num_channels
            L = ep.max_num_block_samples
            group = _synth_group_rows(C, L)
            if out is None:
                out = np.empty((C, total_samples), dtype=np.int32)
            t_ent = t_syn = 0.0
            off = 0
            ent_words = None  # the stream on the device, uploaded on first use
            for g0 in range(0, len(blocks), group):
                grp = blocks[g0 : g0 + group]
                t0 = time.perf_counter()
                comp = [
                    i for i, b in enumerate(grp)
                    if b.block_type == BlockDataType.COMPRESSDATA
                ]
                payloads: list[np.ndarray | None] = [None] * len(grp)
                premade = None
                dev_premade = None
                if comp:
                    rs = sum(grp[i].num_samples for i in comp) * C
                    backend = self._select_backend(rs)
                    if self._device_entropy_on(backend):
                        # K9 straight into the (rows, L) synthesis layout; the
                        # batch stays on the device for the synthesis stage
                        if ent_words is None:
                            ent_words = rice_device.upload_stream(data, self.device)
                        dev_premade = self._device_entropy_group(
                            data, grp, comp, L, ent_words
                        )
                    if dev_premade is not None and backend == "host":
                        # forced device entropy (SLA_TPU_DEVICE_ENTROPY) with
                        # host synthesis: land the batch once as a writable
                        # array and take the host premade fast paths;
                        # dev_premade stays set so the payload loop skips the
                        # COMPRESSDATA blocks (their rows live in `premade`)
                        premade = dev_premade.cpu().numpy()
                    if dev_premade is None:
                        # decode straight into the (rows, L) synthesis batch
                        # layout: the synthesis stage consumes it zero-copy
                        batch, decoded = native.get_data_arrays_strided(
                            data,
                            np.asarray([grp[i].payload_bit_offset for i in comp]),
                            np.asarray([grp[i].num_samples for i in comp]),
                            np.asarray([grp[i].init_rice for i in comp]),
                            L,
                        )
                        for i, rows in zip(comp, decoded):
                            payloads[i] = rows
                        premade = batch
                for i, b in enumerate(grp):
                    if payloads[i] is None and (
                        dev_premade is None
                        or b.block_type != BlockDataType.COMPRESSDATA
                    ):
                        payloads[i] = self._decode_payload(data, b)
                t_ent += time.perf_counter() - t0
                t0 = time.perf_counter()
                offs = np.empty(len(grp), dtype=np.int64)
                ns = np.empty(len(grp), dtype=np.int32)
                for i, b in enumerate(grp):
                    # bound every native write: a malformed stream whose
                    # block sample counts overrun the header total must
                    # fail loudly, not scribble past the PCM buffer
                    if off + b.num_samples > total_samples:
                        raise SLAError(
                            ApiResult.DETECT_DATA_CORRUPTION,
                            "block sample counts exceed the header total",
                        )
                    offs[i] = off
                    ns[i] = b.num_samples
                    off += b.num_samples
                shift = 32 - wf.bit_per_sample + wf.offset_lshift
                ms = ep.ch_process_method == ChannelProcessMethod.STEREO_MS
                if self._synth_group_fused(
                    grp, comp, payloads, premade, out, offs, shift, ms
                ):
                    t_syn += time.perf_counter() - t0
                    if self.config.verbose:
                        print(
                            f"progress:{100 * off // max(total_samples, 1):2d}%",
                            end="\r",
                            flush=True,
                        )
                    continue
                outputs = self._synth_outputs(
                    grp, payloads,
                    premade=dev_premade if premade is None else premade,
                )
                srcs: list[np.ndarray] = []
                for i, b in enumerate(grp):
                    src = outputs.get(i)
                    srcs.append(payloads[i] if src is None else src)
                native.ms_shift_blocks(srcs, offs, ns, out, shift, ms)
                t_syn += time.perf_counter() - t0
                if self.config.verbose:
                    # progress per group (SLADecoder.c:721-725 prints per
                    # block; the grouped pipeline reports at group bounds)
                    print(
                        f"progress:{100 * off // max(total_samples, 1):2d}%",
                        end="\r",
                        flush=True,
                    )
            self.stage_times["entropy"] = t_ent
            self.stage_times["synthesis"] = t_syn
        else:
            t0 = time.perf_counter()
            payloads = []
            done = 0
            for b in blocks:
                payloads.append(self._decode_payload(data, b))
                if self.config.verbose:
                    # progress display (SLADecoder.c:721-725, main.c:406-409)
                    done += b.num_samples
                    print(
                        f"progress:{100 * done // max(total_samples, 1):2d}%",
                        end="\r",
                        flush=True,
                    )
            self.stage_times["entropy"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            # same overrun bound as the native path above: sample counts
            # past the header total are corruption, not extra output
            if sum(b.num_samples for b in blocks) > total_samples:
                raise SLAError(
                    ApiResult.DETECT_DATA_CORRUPTION,
                    "block sample counts exceed the header total",
                )
            pcm = self.synthesize_blocks(blocks, payloads)
            if pcm:
                if out is not None:
                    np.concatenate(pcm, axis=1, out=out)
                else:
                    out = np.concatenate(pcm, axis=1)
            elif out is None:  # zero-block stream: native path returns (C, 0)
                out = np.empty((wf.num_channels, 0), dtype=np.int32)
            self.stage_times["synthesis"] = time.perf_counter() - t0
        return out

    def synthesize_blocks(
        self, blocks: list[_Block], payloads: list[np.ndarray]
    ) -> list[np.ndarray]:
        """Batched synthesis of all blocks; returns per-block (C, n) PCM."""
        wf, ep = self._wave_format, self._encode_param
        shift = 32 - wf.bit_per_sample + wf.offset_lshift
        outputs = self._synth_outputs(blocks, payloads)
        result: list[np.ndarray] = []
        for i, blk in enumerate(blocks):
            out = outputs.get(i)
            if out is None:  # SILENT or RAWDATA pass through the filter chain
                out = payloads[i]
            if ep.ch_process_method == ChannelProcessMethod.STEREO_MS:
                left, right = ms_to_lr_int32(out[0], out[1])
                out = np.stack([left, right])
            result.append((out.astype(np.int32) << shift).astype(np.int32))
        return result

    def _synth_group_fused(
        self,
        grp: list[_Block],
        comp: list[int],
        payloads: list[np.ndarray],
        premade: np.ndarray | None,
        out: np.ndarray,
        offs: np.ndarray,
        shift: int,
        ms: bool,
    ) -> bool:
        """Host fast path for one block group: the synthesis cascade's
        lattice pass stores STRAIGHT into the (C, N) PCM buffer with the
        MS inverse and left shift fused (native.synth_rows_fused over the
        premade residual batch) — no whole-batch ms_shift pass. RAW/SILENT
        blocks scatter through ms_shift_blocks as before. Returns False
        when ineligible (caller runs the general path)."""
        wf, ep = self._wave_format, self._encode_param
        C = wf.num_channels
        p, T = ep.parcor_order, ep.longterm_order
        if (
            premade is None
            or p <= 0
            or not native.available()
            or premade.shape[0] != len(comp) * C
        ):
            return False
        total_row_samples = sum(grp[i].num_samples for i in comp) * C
        if self._select_backend(total_row_samples) != "host":
            return False
        B = len(comp) * C
        coef = np.zeros((B, p), dtype=np.int32)
        pitch = np.zeros((B,), dtype=np.int32)
        ltm = np.zeros((B, max(T, 1)), dtype=np.int32)
        lengths = np.zeros((B,), dtype=np.int64)
        dest_offs = np.zeros((B,), dtype=np.int64)
        N = out.shape[-1]
        for bi, i in enumerate(comp):
            blk = grp[i]
            _fill_block_filter_rows(blk, bi, C, coef, pitch, ltm, lengths)
            for ch in range(C):
                dest_offs[bi * C + ch] = ch * N + offs[i]
        native.synth_rows_fused(
            premade, coef, pitch, ltm, T, ep.lms_order_per_filter,
            lengths, out, dest_offs, ms, shift,
        )
        rest = [
            i for i, b in enumerate(grp)
            if b.block_type != BlockDataType.COMPRESSDATA
        ]
        if rest:
            native.ms_shift_blocks(
                [payloads[i] for i in rest],
                offs[rest], np.asarray([grp[i].num_samples for i in rest],
                                       dtype=np.int32),
                out, shift, ms,
            )
        return True

    def _synth_outputs(self, blocks, payloads, premade=None) -> dict[int, np.ndarray]:
        """Run the synthesis chain for every COMPRESSDATA block; returns
        block index -> (C, n) rows (before the MS inverse / left shift).

        premade: optional (n_comp*C, L) residual batch already laid out in
        block order: a numpy array (native.get_data_arrays_strided), which
        either backend takes without assembling the batch, or a tensor on
        the decoder's device (K9's output), which the device synthesis
        takes where it lies, with no upload. The kernels take exact rows,
        so neither is padded."""
        wf, ep = self._wave_format, self._encode_param
        C = wf.num_channels
        p, T, M = ep.parcor_order, ep.longterm_order, ep.lms_order_per_filter
        comp_all = [
            i for i, b in enumerate(blocks) if b.block_type == BlockDataType.COMPRESSDATA
        ]
        outputs: dict[int, np.ndarray] = {}
        L = ep.max_num_block_samples
        backend = self._select_backend(sum(blocks[i].num_samples for i in comp_all) * C)
        # bound the synthesis batch buffer (~100 MB) for very long streams
        max_group = _synth_group_rows(C, L)
        use_premade = (
            isinstance(premade, np.ndarray)
            and len(comp_all) <= max_group
            and premade.shape == (len(comp_all) * C, L)
        )
        use_dev = (
            isinstance(premade, torch.Tensor)
            and backend != "host"
            and len(comp_all) <= max_group
            and tuple(premade.shape) == (len(comp_all) * C, L)
        )
        for g in range(0, len(comp_all), max_group):
            comp_idx = comp_all[g : g + max_group]
            B = len(comp_idx) * C
            coef = np.zeros((B, p), dtype=np.int32)
            pitch = np.zeros((B,), dtype=np.int32)
            ltm = np.zeros((B, max(T, 1)), dtype=np.int32)
            lengths = np.zeros((B,), dtype=np.int64)
            residual = premade if use_premade or use_dev else np.zeros((B, L), dtype=np.int32)
            for bi, i in enumerate(comp_idx):
                blk = blocks[i]
                if not (use_premade or use_dev):
                    residual[bi * C : (bi + 1) * C, : blk.num_samples] = payloads[i]
                _fill_block_filter_rows(blk, bi, C, coef, pitch, ltm, lengths)
            if backend == "mesh":
                # the rows split over the mesh's devices (see the Encoder's
                # mesh branch); K9's rows go from the decoder's device to
                # the shards without a trip through the host
                mesh = sharding.make_mesh(sharding.mesh_devices(self.device))
                d_res, d_coef = sharding.shard_batch(mesh, residual, coef)
                synth = sharding.gather(
                    sharding.sharded_decode_step(d_res, d_coef, pitch, ltm, p, T, M)
                )
            elif backend == "host":
                synth = native.synth_rows(residual, coef, pitch, ltm, T, M, lengths)
            else:
                dev = self.device
                synth = pipeline.decode_stage(
                    residual if use_dev else pipeline.to_rows(residual, dev),
                    pipeline.to_rows(coef, dev), pitch, ltm, p, T, M,
                ).cpu().numpy()
            for bi, i in enumerate(comp_idx):
                outputs[i] = synth[bi * C : (bi + 1) * C, : blocks[i].num_samples]
        return outputs
