"""Wrappers of the two entropy kernels (csrc/entropy.cu), each beside its
plain PyTorch version.

    rice_encode_blocks  K8  COMPRESSDATA payloads of a filter chunk's
                            recursive-Rice blocks: a chain pass (the
                            parameters, a record a symbol, the sizes),
                            an exclusive sum on the card, an emit pass
    rice_decode_blocks  K9  a synthesis group's payloads, read from the
                            whole stream, into (blocks x channels, n_max)
                            rows, with the reference's `bad` flag

They replace sla_tpu/rice_device.py rice_encode_parts (with the host pack,
native sla_pack_parts, after it) and rice_decode_blocks: two `lax.scan`s
under XLA, not Pallas kernels. The plain versions are those scans
(sla_tpu_torch/rice_device.py) with a plain PyTorch pack for K8 and the
reference's per-block window gather for K9.

K8 writes block j's payload at payload[offsets[j]:] with offsets 4-byte
aligned (each payload zero-padded to a whole 32-bit word), so the plain
version and the kernel give the same buffer byte for byte. K9 and its
plain version flag the same blocks and stop each at the same symbol, so
their rows are equal too; sla_tpu's scan decodes on past a flag, so
against it only the flags and the unflagged rows are held equal
(`decode_agrees`), as the caller uses nothing else.

For a tensor on the CPU a wrapper runs the plain version. For a CUDA tensor
it launches the kernel on the current stream or raises; it never falls
back. `launches` counts the kernel runs of each wrapper, and only those
(K8's count and emit launches are one run); it is a dict of its own, apart
from cuda_filters.launches.
"""

from __future__ import annotations

import torch

from .. import rice_device
from .build import cuda_library

MAX_CHANNELS = 8  # entropy.cuh kMaxChannels
# K9's cursor is a 32-bit bit count from a block's first word, and a symbol
# reads at most 103 bits (entropy.cuh kMaxSymbolBits)
MAX_DECODE_SYMBOLS = (2**31 - 1 - 31) // 103

launches = {"rice_encode_blocks": 0, "rice_decode_blocks": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


# -- plain versions ------------------------------------------------------------


def _stream_parts(values, lengths, counts, C: int):
    """(L, B*C, 4) parts -> (B, L*C*4) in each block's stream order
    (sample-major, channel-minor), with the parts past a block's count
    emptied."""
    L, R, _ = values.shape
    B = R // C
    alive = torch.arange(L, device=values.device)[:, None] < counts.repeat_interleave(C)[None, :]
    lengths = lengths.to(torch.int64) * alive.unsqueeze(-1)
    v = values.view(L, B, C, 4).permute(1, 0, 2, 3).reshape(B, L * C * 4)
    n = lengths.view(L, B, C, 4).permute(1, 0, 2, 3).reshape(B, L * C * 4)
    return v, n


def pack_parts_plain(values, lengths, counts, C: int, chunk: int = 16):
    """The pack of K8's emit pass in plain PyTorch: (value, length) parts
    (L, B*C, 4) of B blocks -> (payload uint8, offsets, sizes), each
    payload MSB-first at a 4-byte aligned offset and zero-padded to a whole
    32-bit word (what native sla_pack_parts writes per block, plus that
    padding). Blocks expand to bits `chunk` at a time."""
    v, n = _stream_parts(values, lengths, counts.to(torch.int64), C)
    bits = n.sum(1)
    pad = (-bits) % 32
    v = torch.cat([v, torch.zeros_like(v[:, :1])], dim=1)
    n = torch.cat([n, pad[:, None]], dim=1)
    j = torch.arange(32, device=v.device)
    weights = torch.bitwise_left_shift(torch.ones((), dtype=torch.int64, device=v.device),
                                       torch.arange(7, -1, -1, device=v.device))
    out = []
    for b0 in range(0, v.shape[0], chunk):
        vv, nn = v[b0 : b0 + chunk, :, None], n[b0 : b0 + chunk, :, None]
        bit = (vv >> torch.clamp_min(nn - 1 - j, 0)) & 1
        stream_bits = bit[j < nn]  # every block's bits in order, word-padded
        out.append((stream_bits.view(-1, 8) * weights).sum(1).to(torch.uint8))
    padded = (bits + pad) // 8
    return torch.cat(out), torch.cumsum(padded, 0) - padded, (bits + 7) // 8


def rice_encode_blocks_plain(rows, row0, counts, init, C: int):
    """K8's function in plain PyTorch: rice_device.rice_encode_parts over
    the blocks' rows, then the pack."""
    idx = (row0.to(torch.int64)[:, None] + torch.arange(C, device=rows.device)).reshape(-1)
    n_max = int(counts.max())
    values, lengths = rice_device.encode_parts64(rows.index_select(0, idx)[:, :n_max],
                                                 init.reshape(-1))
    return pack_parts_plain(values, lengths, counts, C)


def stream_words_plain(stream: torch.Tensor) -> torch.Tensor:
    """The uint8 stream as big-endian 32-bit words, in int64."""
    s = stream.view(-1, 4).to(torch.int64)
    return (s[:, 0] << 24) | (s[:, 1] << 16) | (s[:, 2] << 8) | s[:, 3]


def rice_decode_blocks_plain(stream, bit_offsets, W: int, counts, init, C: int, n_max: int):
    """K9's function in plain PyTorch: each block's window of W words (the
    reference's gather, indexes past the stream clamped to its last word),
    then rice_device.rice_decode_blocks."""
    words = stream_words_plain(stream)
    offs = bit_offsets.to(torch.int64)
    word_start = offs >> 5
    idx = torch.clamp_max(word_start[:, None] + torch.arange(W, device=offs.device),
                          words.numel() - 1)
    res, bad = rice_device.rice_decode_blocks(words[idx], offs - 32 * word_start, counts, init,
                                              C, n_max)
    return res.view(-1, n_max), bad


def decode_agrees(rows_a, bad_a, rows_b, bad_b, C: int) -> tuple[bool, int]:
    """(equal, max |difference|) of two K9 results: the flags, and the rows
    of every block that neither flagged."""
    if not torch.equal(bad_a.bool(), bad_b.bool()):
        return False, -1
    keep = (~bad_a.bool()).repeat_interleave(C)
    a, b = rows_a[keep].to(torch.int64), rows_b[keep].to(torch.int64)
    err = int((a - b).abs().max()) if a.numel() else 0
    return err == 0, err


# -- kernel wrappers -----------------------------------------------------------


def _check(name: str, t: torch.Tensor, dims: int, device) -> None:
    if t.dim() != dims:
        raise ValueError(f"{name} must have {dims} dimensions, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _launch_check(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")


def rice_encode_blocks(rows, row0, counts, init, C: int):
    """K8. rows: (R, L) int32 residual rows; row0, counts: (B,) int32 (block
    j's channels are rows row0[j] .. row0[j] + C - 1, its samples the first
    counts[j]); init: (B, C) int64 initial parameters (uint32 values).
    Returns (payload uint8, offsets (B,) int64, sizes (B,) int64) on the
    rows' device: block j's payload is payload[offsets[j] : offsets[j] +
    sizes[j]]."""
    dev = rows.device
    if rows.dtype != torch.int32:
        raise ValueError(f"rows must be int32, got {rows.dtype}")
    _check("rows", rows, 2, dev)
    for name, t in (("row0", row0), ("counts", counts)):
        _check(name, t, 1, dev)
    _check("init", init, 2, dev)
    B = row0.shape[0]
    if counts.shape[0] != B or tuple(init.shape) != (B, C) or not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"row0 {tuple(row0.shape)}, counts {tuple(counts.shape)} and init "
                         f"{tuple(init.shape)} do not describe blocks of 1-8 channels (C {C})")
    if B == 0:
        z = torch.zeros((0,), dtype=torch.int64, device=dev)
        return torch.zeros((0,), dtype=torch.uint8, device=dev), z, z
    R, L = rows.shape
    if bool(((row0 < 0) | (row0 + C > R) | (counts < 0) | (counts > L)).any()):
        raise ValueError(f"a block's rows or samples lie outside the ({R}, {L}) rows")
    if dev.type == "cpu":
        return rice_encode_blocks_plain(rows, row0, counts, init, C)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    with torch.cuda.device(dev):
        x = rows.contiguous()
        r0 = row0.to(torch.int32).contiguous()
        cnt = counts.to(torch.int32).contiguous()
        ini = init.to(torch.int64).contiguous()
        sizes = torch.empty((B,), dtype=torch.int64, device=dev)
        # the chain pass's record of every symbol (uint16 bit patterns), read
        # by the emit pass
        recs = torch.empty((max(B * L * C, 1),), dtype=torch.int16, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = cuda_library()
        args = (x.data_ptr(), L, r0.data_ptr(), cnt.data_ptr(), ini.data_ptr(), B, C)
        _launch_check(lib.sla_rice_encode_blocks(*args, None, None, sizes.data_ptr(),
                                                 recs.data_ptr(), 0, stream),
                      "sla_rice_encode_blocks (count)")
        padded = (sizes + 3) & ~3
        offsets = torch.cumsum(padded, 0) - padded
        total = int(padded.sum())  # the one small copy to the host
        payload = torch.empty((max(total, 4),), dtype=torch.uint8, device=dev)
        _launch_check(lib.sla_rice_encode_blocks(*args, offsets.data_ptr(), payload.data_ptr(),
                                                 sizes.data_ptr(), recs.data_ptr(), 1, stream),
                      "sla_rice_encode_blocks (emit)")
        launches["rice_encode_blocks"] += 1
        return payload[:total], offsets, sizes


def rice_decode_blocks(stream, bit_offsets, W: int, counts, init, C: int, n_max: int):
    """K9. stream: the whole stream as uint8, a whole number of 32-bit
    words with the last one zero (rice_device.upload_stream); bit_offsets:
    (B,) int64 payload starts; W: the group's window width in words (the
    cursor limit, rice_device.window_width); counts: (B,) int32 samples;
    init: (B, C) int64 initial parameters (uint32 values); n_max: samples a
    row. Returns (rows (B * C, n_max) int32, bad (B,) bool): row b * C + c
    is block b's channel c, the synthesis layout."""
    dev = stream.device
    if stream.dtype != torch.uint8 or stream.dim() != 1 or stream.numel() % 4 or not stream.numel():
        raise ValueError("stream must be a non-empty uint8 vector of whole 32-bit words")
    for name, t in (("bit_offsets", bit_offsets), ("counts", counts)):
        _check(name, t, 1, dev)
    _check("init", init, 2, dev)
    B = bit_offsets.shape[0]
    if counts.shape[0] != B or tuple(init.shape) != (B, C) or not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"bit_offsets {tuple(bit_offsets.shape)}, counts "
                         f"{tuple(counts.shape)} and init {tuple(init.shape)} do not describe "
                         f"blocks of 1-8 channels (C {C})")
    if B == 0:
        return (torch.zeros((0, n_max), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.bool, device=dev))
    if bool(((bit_offsets < 0) | (counts < 0) | (counts > n_max)).any()) or W < 1:
        raise ValueError("a payload offset, sample count or window width is out of range")
    if dev.type == "cpu":
        return rice_decode_blocks_plain(stream, bit_offsets, W, counts, init, C, n_max)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if n_max * C > MAX_DECODE_SYMBOLS:
        raise ValueError(f"{n_max} samples x {C} channels a block exceed the kernel's 32-bit "
                         f"cursor ({MAX_DECODE_SYMBOLS} symbols)")
    with torch.cuda.device(dev):
        offs = bit_offsets.to(torch.int64).contiguous()
        cnt = counts.to(torch.int32).contiguous()
        ini = init.to(torch.int64).contiguous()
        rows = torch.empty((B * C, n_max), dtype=torch.int32, device=dev)
        bad = torch.empty((B,), dtype=torch.uint8, device=dev)
        err = cuda_library().sla_rice_decode_blocks(
            stream.data_ptr(), stream.numel() // 4, offs.data_ptr(), W, cnt.data_ptr(),
            ini.data_ptr(), B, C, n_max, rows.data_ptr(), bad.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _launch_check(err, "sla_rice_decode_blocks")
        launches["rice_decode_blocks"] += 1
        return rows, bad.bool()
