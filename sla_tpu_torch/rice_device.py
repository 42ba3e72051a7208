"""On-card recursive-Rice coding (counterpart of sla_tpu/rice_device.py).

The two scans of the reference, written here as plain PyTorch over int64
tensors, with the same names and contracts:

    rice_encode_parts   (B, L) residual -> per-symbol (value, length) parts
    rice_decode_blocks  B block payloads -> (B, C, n_max) residual + `bad`

Both are vectorised over rows (blocks for decode) with a Python loop over
samples, as the reference's `lax.scan` is. The reference's uint64 state
(two fixed-point parameters per row, a 64-bit bit window) lives in int64:
parameter values stay under 2^33, and a window keeps its bit pattern, with
shifts that would be logical on uint64 masked explicitly. PyTorch has no
count-leading-zeros, so a bit length is one lookup in a table of every
value's bit length below 2^23 (the Rice-parameter indexes, and the top 17
bits of a window for the unary run).

They are the plain versions that the tests hold against sla_tpu, and that
the kernel wrappers (kernels/cuda_entropy.py) run for tensors on the CPU.
On a CUDA device the payload functions below launch the hand-written
kernels instead: K8 codes whole COMPRESSDATA payloads, bytes and all, and
K9 decodes them straight into the (blocks x channels, L) synthesis rows.
Static-Golomb blocks (cross-channel mean effective parameter <= 8) stay on
the host coder, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import (
    CODER_LOW_THRESHOLD_PARAMETER,
    CODER_NUM_RECURSIVE_RICE_PARAMETER,
    CODER_QUOTPART_THRESHOLD,
)

_FRAC = 8
_HALF = 1 << (_FRAC - 1)
_M32 = 0xFFFFFFFF
_INT64_MAX = (1 << 63) - 1
_QUOT_T = CODER_QUOTPART_THRESHOLD  # 16
# every Rice-parameter index h - 1 lies below 2^23: h = round(p / 512) with
# the fixed-point p below 2^32 (the update's fixed point is under 2^29)
_LUT_BITS = 23
_luts: dict[torch.device, torch.Tensor] = {}


def _pows(device, n: int = 32) -> torch.Tensor:
    """2^0 .. 2^(n-1) as int64 (n <= 63)."""
    return torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int64, device=device), torch.arange(n, device=device)
    )


def _bit_length(x: torch.Tensor, pows: torch.Tensor) -> torch.Tensor:
    """bit_length of non-negative int64 values below 2^len(pows), counted
    against the powers of two (branch-free)."""
    return (x.unsqueeze(-1) >= pows).sum(-1)


def _bit_length_lut(device) -> torch.Tensor:
    """bit_length of every value below 2^23 (int64), one table per device:
    in the scans a bit length is one lookup."""
    device = torch.device(device)
    if device not in _luts:
        lut = torch.zeros((1 << _LUT_BITS,), dtype=torch.int64, device=device)
        for i in range(1, _LUT_BITS + 1):
            lut[1 << (i - 1) : 1 << i] = i
        _luts[device] = lut
    return _luts[device]


class _Consts:
    """The scans' integer constants as 0-dim int64 tensors on one device:
    an op between two int64 tensors dispatches faster than one with a
    Python int, and the scans run tens of ops a symbol."""

    def __init__(self, device):
        for name, v in (("c0", 0), ("c1", 1), ("c5", 5), ("c7", 7), ("c8", _FRAC),
                        ("c16", _QUOT_T), ("c17", 17), ("c31", 31), ("c32", 32),
                        ("c46", 46), ("c63", 63), ("c64", 64), ("half", _HALF),
                        ("m32", _M32), ("i64max", _INT64_MAX), ("c2304", 2304)):
            setattr(self, name, torch.tensor(v, dtype=torch.int64, device=device))


def _param_update(p: torch.Tensor, code: torch.Tensor, c: _Consts) -> torch.Tensor:
    """p <- (119 p + 9 * u32(code << 8) + 64) >> 7 with the uint32 wrap of
    the 9*(code<<8) term (rice.py param_update): 9 * (code << 8) is
    code * 2304, and the low 32 bits of a product are the same in int64 as
    in uint64."""
    return (torch.add((code * c.c2304) & c.m32, p, alpha=119) + c.c64) >> c.c7


def _rice_bits(p: torch.Tensor, lut: torch.Tensor, c: _Consts) -> torch.Tensor:
    """log2 of roundup_pow2(max(round(p/2), 1)) (rice.py rice_param). The
    reference masks the shift count to 5 bits (x86's `1U << 32`); with
    h - 1 below 2^23 that mask never acts."""
    return torch.take(lut, torch.clamp_min(((p >> c.c1) + c.half) >> c.c8, 1) - c.c1)


def _zigzag(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64)
    return torch.where(x < 0, -2 * x - 1, 2 * x)


def encode_parts64(residual: torch.Tensor, init_params: torch.Tensor):
    """rice_encode_parts with the values in int64 (each below 2^32), the
    form the plain pack (kernels/cuda_entropy.py) takes."""
    assert CODER_NUM_RECURSIVE_RICE_PARAMETER == 2
    dev = residual.device
    B, L = residual.shape
    lut, c = _bit_length_lut(dev), _Consts(dev)
    u = _zigzag(residual).T.contiguous()  # (L, B) sample-major
    # stage 0 always sees u, so its update term is known for every sample
    term_u = (u * 2304) & _M32
    p = ((init_params.to(torch.int64) & _M32) << _FRAC) & _M32
    pa, pb = p.clone(), p.clone()
    bits = torch.empty((L, 2, B), dtype=torch.int64, device=dev)
    for s in range(L):  # the scan: only the parameters are sequential
        b0, b1 = _rice_bits(pa, lut, c), _rice_bits(pb, lut, c)
        bits[s, 0], bits[s, 1] = b0, b1
        k0 = torch.bitwise_left_shift(c.c1, b0)
        pb = torch.where(u[s] >= k0, _param_update(pb, u[s] - k0, c), pb)
        pa = (torch.add(term_u[s], pa, alpha=119) + c.c64) >> c.c7
    b0, b1 = bits[:, 0], bits[:, 1]
    k0 = torch.bitwise_left_shift(1, b0)
    in_stage0 = u < k0
    reduced = torch.where(in_stage0, u, u - k0)
    tail_quot = torch.where(in_stage0, 0, 1 + (reduced >> b1))  # k1 is 2^b1
    escape = (~in_stage0) & (tail_quot >= _QUOT_T)
    quot = torch.where(in_stage0, 0, torch.clamp_max(tail_quot, _QUOT_T))
    gv = torch.where(escape, tail_quot - _QUOT_T, 0)
    ndigit = _bit_length((gv + 1) & _M32, _pows(dev))  # log2ceil(gv + 2)
    kb = torch.where(in_stage0, b0, b1)
    zero = torch.zeros_like(u)
    values = torch.stack([
        torch.ones_like(u), zero, torch.where(escape, (gv + 1) & _M32, 0),
        reduced & (torch.bitwise_left_shift(1, kb) - 1),
    ], dim=-1)
    lengths = torch.stack([
        quot + 1, torch.where(escape, ndigit - 1, 0), torch.where(escape, ndigit, 0), kb,
    ], dim=-1).to(torch.int32)
    return values, lengths


def rice_encode_parts(residual: torch.Tensor, init_params: torch.Tensor):
    """Per-symbol code parts for a (B, L) residual batch.

    residual: (B, L) int32; init_params: (B,) uint32 initial parameters.
    Returns (values (L, B, 4) uint32, lengths (L, B, 4) int32), sample-major
    so a pack walks symbols in stream order per row:

        part 0: the unary run   - `quot` zero bits then a 1   (quot <= 16)
        part 1: gamma zeros     - (ndigit-1) zero bits        (escape only)
        part 2: gamma value     - `ndigit` bits of v+1        (escape only)
        part 3: Rice remainder  - log2(k) low bits

    The two-stage recursive Rice encoder exactly (rice.py
    put_recursive_rice); the static-Golomb branch is decided per block on
    the host and does not use this path."""
    values, lengths = encode_parts64(residual, init_params)
    return values.to(torch.uint32), lengths


# words read past a row's window: a cursor that stays unflagged ends at or
# before the window's last bit, and a symbol reads at most 17 + 65 + 64 bits
# past its start
_WINDOW_PAD = 8


class _Windows:
    """Each row's words of the stream (B, W), read as 64-bit big-endian
    windows from any bit (int64 bit patterns). Reads past the window see
    its last word again, as the reference's clamped gather does; only a
    symbol that flags its block reads there."""

    def __init__(self, words: torch.Tensor, c: _Consts):
        B, self.W = words.shape
        w = torch.cat([words, words[:, -1:].expand(-1, _WINDOW_PAD)], dim=1)
        self.hi = ((w[:, :-2] << 32) | w[:, 1:-1]).reshape(-1)  # words i, i + 1
        self.lo = w[:, 2:].reshape(-1)  # word i + 2
        self.row = torch.arange(B, device=words.device) * (self.W + _WINDOW_PAD - 2)
        self.c = c

    def __call__(self, bp: torch.Tensor) -> torch.Tensor:
        c = self.c
        idx = (bp >> c.c5) + self.row
        off = bp & c.c31
        # lo < 2^32, so a shift by 32 (off == 0) gives 0
        return (torch.take(self.hi, idx) << off) | (torch.take(self.lo, idx) >> (c.c32 - off))


def _gamma(w2: torch.Tensor, lut: torch.Tensor, c: _Consts):
    """(gz, gamma) of the Elias-gamma codes at the top of w2 (rice.py
    get_gamma): gz zeros, a 1, then gz value bits. gz counts up to 32; a
    code of more than 32 digits (gz > 31) flags the block."""
    top = ((w2 >> 1) & c.i64max) >> 31  # the top 32 bits
    hi = torch.take(lut, top >> 23)
    gz = torch.where(hi > 0, 9 - hi, 32 - torch.take(lut, top & ((1 << 23) - 1)))
    g = torch.clamp_max(gz, 31)
    grest = (w2 >> (63 - 2 * g)) & ((1 << g) - 1)  # w2 >= 0 when gz > 0
    return gz, (1 << g) + grest - 1


def rice_decode_blocks(words, start_bits, counts, init_params, C: int, n_max: int):
    """Decode B independent recursive-Rice block payloads.

    words: (B, W) big-endian 32-bit words of each block's window of the
        stream (values below 2^32, any integer dtype);
    start_bits: (B,) bit offset of each payload within its window;
    counts: (B,) samples per block (rows shorter than n_max freeze their
        cursor and parameters once exhausted, and read 0 past their count);
    init_params: (B, C) uint32 initial Rice parameters.
    Returns (residual (B, C, n_max) int32, bad (B,) bool). A `bad` block saw
    something no valid stream produces (a unary run past the escape
    threshold, a gamma code of more than 32 digits, or a cursor past the
    window): the reference's flag, bit for bit. Decoding a flagged block
    stops at that symbol and its later samples read 0; the caller
    re-decodes it on the host. Every other block's values and parameter
    updates equal the host coder's (rice.py get_recursive_rice).

    One symbol of every row a step, the C channels in stream order. The
    unary run is read from the top 17 bits of the window at the cursor (a
    run of 17 or more flags the block); off the escape the remainder
    follows it in the same window (at most 17 + 23 bits), and only a step
    where some row escapes reads the gamma code and a third window."""
    assert CODER_NUM_RECURSIVE_RICE_PARAMETER == 2
    words = torch.as_tensor(words).to(torch.int64) & _M32
    dev = words.device
    B = words.shape[0]
    lut, c = _bit_length_lut(dev), _Consts(dev)
    win = _Windows(words, c)
    wbits = torch.tensor(win.W * 32, device=dev)
    counts = torch.as_tensor(counts, device=dev).to(torch.int64)
    bp = torch.as_tensor(start_bits, device=dev).to(torch.int64)
    p = ((torch.as_tensor(init_params, device=dev).to(torch.int64) & _M32) << _FRAC) & _M32
    # (B, 2) per channel: the stage-0 and stage-1 parameters
    params = [p[:, ch : ch + 1].repeat(1, 2) for ch in range(C)]
    stage0 = torch.tensor([True, False], device=dev)
    first_off = torch.tensor([0, 1], device=dev)
    good = torch.ones((B,), dtype=torch.bool, device=dev)
    steps = min(n_max, int(counts.max())) if B else 0  # later samples stay 0
    vals = torch.zeros((B, C, steps), dtype=torch.int64, device=dev)
    for si in range(steps):
        alive = counts > si
        for ch in range(C):  # channel-interleaved stream order
            live = alive & good
            kb2 = _rice_bits(params[ch], lut, c)  # (B, 2): stages 0 and 1
            k = torch.bitwise_left_shift(c.c1, kb2)
            w1 = win(bp)
            # the zero run from the top 17 bits; 17 stands for more than 16
            quot = c.c17 - torch.take(lut, ((w1 >> c.c1) & c.i64max) >> c.c46)
            stage1 = quot > c.c0
            bp2 = bp + quot + c.c1
            w3 = w1 << (torch.clamp_max(quot, _QUOT_T) + c.c1)  # the bits after the run
            quot_u = quot
            fail = quot > c.c16
            esc = live & (quot == c.c16)
            escaped = bool(esc.any())
            if escaped:
                gz, gamma = _gamma(win(bp2), lut, c)
                fail = fail | (esc & (gz > 31))
                quot_u = torch.where(esc, quot + gamma, quot)
                bp2 = torch.where(esc, bp2 + 2 * gz + 1, bp2)
                w3 = torch.where(esc, win(bp2), w3)
            kb = torch.where(stage1, kb2[:, 1], kb2[:, 0])
            rest = ((w3 >> c.c1) & c.i64max) >> (c.c63 - kb)  # the top kb bits
            bp3 = bp2 + kb
            val = rest + torch.where(stage1, k[:, 0] + k[:, 1] * (quot_u - c.c1), c.c0)
            if escaped:  # the products wrap mod 2^64 as the reference's uint64 does
                val = val & c.m32
            fail = fail | (bp3 > wbits)
            ok = live & ~fail
            good = good & ~(live & fail)
            # stage 0 adapts to val, stage 1 (where reached) to val - k0
            codes = val.unsqueeze(1) - k[:, :1] * first_off
            upd = ok.unsqueeze(1) & (stage1.unsqueeze(1) | stage0)
            params[ch] = torch.where(upd, _param_update(params[ch], codes, c), params[ch])
            bp = torch.where(ok, bp3, bp)
            vals[:, ch, si] = torch.where(ok, val, c.c0)
    out = torch.zeros((B, C, n_max), dtype=torch.int32, device=dev)
    out[:, :, :steps] = ((vals >> 1) ^ -(vals & 1)).to(torch.int32)  # unzigzag
    return out, ~good


def stream_words(data: bytes) -> np.ndarray:
    """Big-endian uint32 view of a whole stream, zero-padded so the final
    word is all-zero (native-endian values)."""
    pad = (-len(data)) % 4
    arr = np.frombuffer(bytes(data) + b"\x00" * (4 + pad), dtype=">u4")
    return arr.astype(np.uint32)


# the stream on the card: at least this many zero bytes past its end; K9's
# reads clamp to the last word, which is then zero
STREAM_PAD = 16


def upload_stream(data: bytes, device) -> torch.Tensor:
    """The whole stream as a uint8 tensor on `device`, zero-padded to a
    whole number of 32-bit words plus STREAM_PAD bytes. Made once per decode
    call and shared by every synthesis group (decode_blocks_payload_device
    reads each group's payloads from it)."""
    device = torch.device(device)
    n = len(data)
    host = torch.zeros((n + (-n) % 4 + STREAM_PAD,), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    host.numpy()[:n] = np.frombuffer(data, dtype=np.uint8)
    return host.to(device)


def window_width(bit_offsets: np.ndarray, block_bits: np.ndarray) -> int:
    """The reference's window width in words: the group's widest payload
    plus 2 words of slack, bucketed to 512 words. It sets the limit of the
    cursor check (bp > W * 32 from each block's first word)."""
    word_start = bit_offsets // 32
    end_word = -(-(bit_offsets + block_bits) // 32)
    W = int(np.max(end_word - word_start)) + 2
    return -(-W // 512) * 512


def decode_blocks_payload_device(
    data: bytes,
    bit_offsets: np.ndarray,
    block_bits: np.ndarray,
    counts: np.ndarray,
    init_params: np.ndarray,
    C: int,
    n_max: int,
    words_arr: torch.Tensor | None = None,
    device=None,
):
    """Decode a group of COMPRESSDATA payloads with K9 (the plain scan for a
    stream on the CPU).

    data: the whole stream; bit_offsets: (B,) payload bit offsets;
    block_bits: (B,) payload-region sizes in bits (to the block end);
    counts: (B,) samples; init_params: (B, C) uint32 (raw header values);
    words_arr: upload_stream(data, device), made once per decode call and
    reused across groups (made here when None); device: where to decode
    when words_arr is None (default: the card).
    Returns (residual (B, C, n_max) int32 tensor on the stream's device, bad
    (B,) bool numpy). The residual stays where it was decoded, so the
    synthesis batch never crosses to the host; a `bad` block stops at the
    flagged symbol (its later samples read 0), and the caller re-decodes it
    on the host."""
    from .kernels import cuda_entropy

    offs = np.asarray(bit_offsets, dtype=np.int64)
    W = window_width(offs, np.asarray(block_bits, dtype=np.int64))
    if words_arr is None:
        words_arr = upload_stream(data, torch.device("cuda" if device is None else device))
    dev = words_arr.device
    rows, bad = cuda_entropy.rice_decode_blocks(
        words_arr,
        torch.from_numpy(offs).to(dev),
        W,
        torch.from_numpy(np.asarray(counts, dtype=np.int32)).to(dev),
        torch.from_numpy(np.asarray(init_params, dtype=np.uint32).astype(np.int64)).to(dev),
        C,
        n_max,
    )
    return rows.view(len(offs), C, n_max), bad.cpu().numpy()


def is_golomb_block(init_params) -> bool:
    """The static-Golomb branch: cross-channel mean effective initial
    parameter <= 8 (SLACoder.c:450-466); such payloads stay on the host
    coder."""
    from . import rice

    eff = [rice.effective_init_param(int(p)) for p in init_params]
    return sum(eff) // len(eff) <= CODER_LOW_THRESHOLD_PARAMETER


def encode_blocks_device(rows: torch.Tensor, row0, counts, init_params, C: int):
    """K8 over the recursive-Rice blocks of one filter chunk.

    rows: (R, L) int32 residual rows where they lie (block j's channels are
    rows row0[j] .. row0[j] + C - 1); row0, counts: (B,) ints; init_params:
    (B, C) uint32. Returns (payload uint8 numpy, offsets (B,), sizes (B,)):
    block j's payload is payload[offsets[j] : offsets[j] + sizes[j]]. On the
    card, only the payload bytes cross to the host, into one pinned
    buffer."""
    from .kernels import cuda_entropy

    dev = rows.device
    payload, offsets, sizes = cuda_entropy.rice_encode_blocks(
        rows,
        torch.as_tensor(np.asarray(row0, dtype=np.int32)).to(dev),
        torch.as_tensor(np.asarray(counts, dtype=np.int32)).to(dev),
        torch.from_numpy(np.asarray(init_params, dtype=np.uint32).astype(np.int64)).to(dev),
        C,
    )
    if payload.is_cuda:
        host = torch.empty(payload.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(payload)
        payload = host
    return payload.numpy(), offsets.cpu().numpy(), sizes.cpu().numpy()


def encode_block_payload_device(
    residual: np.ndarray,
    init_params: list[int],
    parts=None,
    device=None,
) -> bytes:
    """Full device-coded payload for one block: the byte-aligned
    channel-interleaved payload, byte-identical to the host coder.

    residual: (C, n) int32. The static-Golomb branch (cross-channel mean
    parameter <= 8) takes the host coder. parts: this block's payload bytes
    from a batched K8 pass over the whole filter chunk
    (encoder._attach_device_parts), used as they are; without them the
    block is coded alone on `device` (default: the card)."""
    from . import native

    if is_golomb_block(init_params):
        return native.put_data_array(residual, init_params)
    if parts is not None:
        return bytes(parts)
    C, n = residual.shape
    dev = torch.device("cuda" if device is None else device)
    rows = torch.from_numpy(np.ascontiguousarray(residual, dtype=np.int32)).to(dev)
    payload, offsets, sizes = encode_blocks_device(
        rows, [0], [n], np.asarray([init_params], dtype=np.uint32), C
    )
    return payload[offsets[0] : offsets[0] + sizes[0]].tobytes()
