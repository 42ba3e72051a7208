"""The CUDA kernels' bodies and schedules (csrc/filters.cuh), built for the
CPU with g++ -fwrapv, against the plain PyTorch versions: the kernels'
arithmetic checked without a card. Both the compile-time-order
instantiations the presets take and the run-time-order one are run. K1
runs its lane schedule (32 lanes, their shuffles, chunk carries and
segment warm-ups), K7 its lane schedule (lag-sized steps, lanes forward
and in reverse), K2-K4 and K6 their tile pipelines.
Exact comparisons (integer codec, tolerance 0)."""

import functools
import shutil

import numpy as np
import pytest
import torch

from sla_tpu_torch.kernels import build, cuda_filters

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    return build.host_library()


ROW_ENTRIES = ("sla_host_lattice_predict", "sla_host_stage2_predict", "sla_host_synth_cascade",
               "sla_host_fused_encode", "sla_host_lattice_synth", "sla_host_lms_synth",
               "sla_host_longterm_synth")


def _call(lib, fn, x, *args):
    """Runs a host entry on (B, L) rows: K1-K7 take them as they are, the
    LMS alone in the (L, B) layout."""
    rows = fn in ROW_ENTRIES
    x_in = np.ascontiguousarray(x if rows else x.T)
    y = np.empty_like(x_in)
    keep = [np.ascontiguousarray(a) if isinstance(a, np.ndarray) else a for a in args]
    ptrs = [a.ctypes.data if isinstance(a, np.ndarray) else a for a in keep]
    getattr(lib, fn)(x_in.ctypes.data, y.ctypes.data, *ptrs)
    return y if rows else y.T


def _inputs(seed, B, L, p, T, full_range):
    rng = np.random.default_rng(seed)
    if full_range:
        x = rng.integers(I32_MIN, I32_MAX, (B, L), dtype=np.int64, endpoint=True)
        x[0, ::5] = I32_MIN
        x = x.astype(np.int32)
    else:
        x = rng.integers(-(1 << 18), 1 << 18, (B, L), dtype=np.int32)
    coef = rng.integers(-32768, 32768, (B, p), dtype=np.int32)
    pitch = rng.integers(3, 257, B)
    pitch[::4] = 0
    pitch[1::5] = rng.integers(1, 8, len(pitch[1::5]))  # lags under 8
    md = np.where(pitch > 0, pitch + T // 2, 0).astype(np.int32) if T else np.zeros(B, np.int32)
    q15 = rng.integers(-32768, 32768, (B, T), dtype=np.int32)
    return x, coef, md, q15


# the preset orders (templated) and others (run-time instantiation)
CASES = [(8, 1, 4), (8, 1, 8), (16, 1, 8), (32, 3, 8), (0, 0, 0), (1, 5, 16), (48, 5, 40),
         (5, 5, 13)]


@pytest.mark.parametrize("fixed", [1, 0])
@pytest.mark.parametrize("p,T,M", CASES)
@pytest.mark.parametrize("full_range", [False, True])
def test_row_bodies_match_plain(lib, p, T, M, fixed, full_range):
    B, L = 24, 700
    x, coef, md, q15 = _inputs(p * 100 + T * 10 + M, B, L, p, T, full_range)
    X, C, MD, Q = (torch.from_numpy(a) for a in (x, coef, md, q15))

    k1 = _call(lib, "sla_host_lattice_predict", x, coef, B, L, p, 1, fixed, 0)
    assert np.array_equal(k1, cuda_filters.lattice_predict_plain(X, C).numpy())

    k2 = _call(lib, "sla_host_stage2_predict", x, md, q15, B, L, T, M, fixed)
    assert np.array_equal(k2, cuda_filters.stage2_predict_plain(X, MD, Q, M).numpy())

    k3 = _call(lib, "sla_host_synth_cascade", x, coef, md, q15, B, L, p, T, M, fixed)
    assert np.array_equal(k3, cuda_filters.synth_cascade_plain(X, C, MD, Q, M).numpy())


@pytest.mark.parametrize("fixed", [1, 0])
@pytest.mark.parametrize("p,T,M", CASES)
@pytest.mark.parametrize("full_range", [False, True])
def test_known_parameter_bodies_match_plain(lib, p, T, M, fixed, full_range):
    """K4 (fused encode), K5 (lattice synth, both emphasis values), K6 (LMS
    synth) and K7 (long-term synth), and K1 without pre-emphasis."""
    B, L = 24, 700
    x, coef, md, q15 = _inputs(p * 100 + T * 10 + M + 1, B, L, p, T, full_range)
    X, C, MD, Q = (torch.from_numpy(a) for a in (x, coef, md, q15))

    k4 = _call(lib, "sla_host_fused_encode", x, coef, md, q15, B, L, p, T, M, fixed, 0)
    assert np.array_equal(k4, cuda_filters.fused_encode_plain(X, C, MD, Q, M).numpy())

    for emphasis in (1, 0):
        k5 = _call(lib, "sla_host_lattice_synth", x, coef, B, L, p, emphasis, fixed, 0)
        assert np.array_equal(k5, cuda_filters.lattice_synth_plain(X, C, bool(emphasis)).numpy())
    k1 = _call(lib, "sla_host_lattice_predict", x, coef, B, L, p, 0, fixed, 0)
    assert np.array_equal(k1, cuda_filters.lattice_predict_plain(X, C, False).numpy())

    k6 = _call(lib, "sla_host_lms_synth", x, B, L, M, fixed, 0)
    assert np.array_equal(k6, cuda_filters.lms_synth_plain(X, M).numpy())

    k7 = _call(lib, "sla_host_longterm_synth", x, md, q15, B, L, T, fixed, 0)
    assert np.array_equal(k7, cuda_filters.longterm_synth_plain(X, MD, Q).numpy())


def test_split_bodies_round_trip(lib):
    """K5 inverts K1 (with and without emphasis), K6 inverts K2's LMS
    stage, K7 inverts K2's long-term stage, and K3 inverts K4."""
    B, L, p, T, M = 16, 900, 32, 3, 8
    x, coef, _, q15 = _inputs(9, B, L, p, T, False)
    rng = np.random.default_rng(10)
    pitch = rng.integers(T // 2 + 1, 257, B)
    pitch[::3] = 0
    md = np.where(pitch > 0, pitch + T // 2, 0).astype(np.int32)
    no_md, no_q = np.zeros(B, np.int32), np.zeros((B, 0), np.int32)
    for emphasis in (1, 0):
        r = _call(lib, "sla_host_lattice_predict", x, coef, B, L, p, emphasis, 1, 0)
        assert np.array_equal(_call(lib, "sla_host_lattice_synth", r, coef, B, L, p, emphasis, 1, 0), x)
    r = _call(lib, "sla_host_stage2_predict", x, no_md, no_q, B, L, 0, M, 1)
    assert np.array_equal(_call(lib, "sla_host_lms_synth", r, B, L, M, 1, 0), x)
    r = _call(lib, "sla_host_stage2_predict", x, md, q15, B, L, T, 0, 1)
    assert np.array_equal(_call(lib, "sla_host_longterm_synth", r, md, q15, B, L, T, 1, 0), x)
    r = _call(lib, "sla_host_fused_encode", x, coef, md, q15, B, L, p, T, M, 1, 0)
    out = _call(lib, "sla_host_synth_cascade", r, coef, md, q15, B, L, p, T, M, 1)
    assert np.array_equal(out, x)


def test_row_bodies_round_trip(lib):
    """K3 inverts K1 then K2 on the stream's pitch range (> T//2)."""
    B, L, p, T, M = 16, 900, 32, 3, 8
    x, coef, _, q15 = _inputs(7, B, L, p, T, False)
    rng = np.random.default_rng(8)
    pitch = rng.integers(T // 2 + 1, 257, B)
    pitch[::3] = 0
    md = np.where(pitch > 0, pitch + T // 2, 0).astype(np.int32)
    r1 = _call(lib, "sla_host_lattice_predict", x, coef, B, L, p, 1, 1, 0)
    r2 = _call(lib, "sla_host_stage2_predict", r1, md, q15, B, L, T, M, 1)
    out = _call(lib, "sla_host_synth_cascade", r2, coef, md, q15, B, L, p, T, M, 1)
    assert np.array_equal(out, x)


# -- K2 and K3 as tile pipelines (filters.cuh Stage2Pipe, SynthPipe; 64-sample
# tiles, 32-row groups, a 512-slot history ring per row) --------------------

TILED_SHAPES = [  # (B, L): shorter than a tile, ragged tiles, B not a multiple of 32,
    (1, 1), (33, 37), (40, 64), (35, 65), (70, 1300),  # and the ring wrapping twice
]
TILED_ORDERS = [(16, 1, 8), (32, 3, 8), (0, 0, 0), (5, 5, 40), (3, 5, 0)]


def _tiled_inputs(seed, B, L, p, T):
    """Full-range rows with INT32_MIN samples; delays 0 (no stage), 1-9
    (taps at or ahead of n at T 5), 256, 257 and the largest, 258."""
    x, coef, _, q15 = _inputs(seed, B, L, p, T, True)
    special = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 256, 257, 258], np.int32)
    rng = np.random.default_rng(seed + 1)
    md = rng.integers(0, 259, B).astype(np.int32)
    md[: min(B, special.size)] = special[: min(B, special.size)]
    if T == 0:
        md[:] = 0
    return x, coef, md, q15


@pytest.mark.parametrize("fixed", [1, 0])
@pytest.mark.parametrize("p,T,M", TILED_ORDERS)
@pytest.mark.parametrize("B,L", TILED_SHAPES)
def test_tiled_stage2_and_synth_match_plain(lib, B, L, p, T, M, fixed):
    x, coef, md, q15 = _tiled_inputs(B * 7 + L + p + T + M, B, L, p, T)
    X, C, MD, Q = (torch.from_numpy(a) for a in (x, coef, md, q15))
    k2 = _call(lib, "sla_host_stage2_predict", x, md, q15, B, L, T, M, fixed)
    assert np.array_equal(k2, cuda_filters.stage2_predict_plain(X, MD, Q, M).numpy())
    k3 = _call(lib, "sla_host_synth_cascade", x, coef, md, q15, B, L, p, T, M, fixed)
    assert np.array_equal(k3, cuda_filters.synth_cascade_plain(X, C, MD, Q, M).numpy())


@pytest.mark.parametrize("fixed", [1, 0])
@pytest.mark.parametrize("synth", [1, 0])
@pytest.mark.parametrize("M", [8, 1, 2, 13, 40])
def test_tree_summed_lms_matches_serial(lib, M, synth, fixed):
    """The kernels' tree-summed LMS dot product against the serial sum it
    replaced, on full-range rows (the wrapping sums must agree bit for bit)."""
    B, L = 12, 900
    x, _, _, _ = _inputs(M * 10 + synth, B, L, 0, 0, True)
    tree = _call(lib, "sla_host_lms", x, B, L, M, synth, 1, fixed)
    serial = _call(lib, "sla_host_lms", x, B, L, M, synth, 0, fixed)
    assert np.array_equal(tree, serial)
    plain = (cuda_filters.lms_synth_plain if synth else
             lambda d, m: cuda_filters.stage2_predict_plain(
                 d, torch.zeros(B, dtype=torch.int32), torch.zeros((B, 0), dtype=torch.int32), m))
    assert np.array_equal(tree, plain(torch.from_numpy(x), M).numpy())


# -- K1 as a sample-parallel stencil (filters.cuh lattice_segment: a warp per
# segment of a row, 32 lanes x 4 samples a chunk, a p-sample warm-up) -------

STENCIL_ORDERS = [0, 1, 5, 8, 16, 32, 48]
# B not a multiple of 32, L < p, L not a multiple of 4, one sample
STENCIL_SHAPES = [(33, 700), (3, 30), (2, 1), (5, 131)]


@pytest.mark.parametrize("seg", [64, 7, 0])  # 0: the kernel's own segment length
@pytest.mark.parametrize("emphasis", [1, 0])
@pytest.mark.parametrize("fixed", [1, 0])
@pytest.mark.parametrize("p", STENCIL_ORDERS)
def test_lattice_stencil_matches_plain(lib, p, fixed, emphasis, seg):
    """K1's lane schedule across chunk and segment boundaries, on full-range
    rows with INT32_MIN samples: short segments put many warm-ups in a row."""
    for B, L in STENCIL_SHAPES:
        x, coef, _, _ = _inputs(p * 31 + B + L + seg, B, L, p, 0, True)
        k1 = _call(lib, "sla_host_lattice_predict", x, coef, B, L, p, emphasis, fixed, seg)
        plain = cuda_filters.lattice_predict_plain(
            torch.from_numpy(x), torch.from_numpy(coef), bool(emphasis))
        assert np.array_equal(k1, plain.numpy()), (B, L)


# -- K4 as a tile pipeline (filters.cuh EncodePipe: stage 1 on K1's lane
# schedule into the ring, then K2's FIR and LMS roles) ----------------------

ENCODE_ORDERS = [(16, 1, 8), (32, 3, 8), (8, 1, 4), (0, 0, 0), (48, 5, 40), (1, 5, 13), (5, 0, 8)]


@functools.lru_cache(maxsize=None)
def _encode_case(B, L, p, T, M):
    x, coef, md, q15 = _tiled_inputs(B * 5 + L + p + T + M, B, L, p, T)
    plain = cuda_filters.fused_encode_plain(*(torch.from_numpy(a) for a in (x, coef, md, q15)), M)
    return x, coef, md, q15, plain.numpy()


@pytest.mark.parametrize("reverse", [0, 1])
@pytest.mark.parametrize("fixed", [1, 0])
@pytest.mark.parametrize("p,T,M", ENCODE_ORDERS)
@pytest.mark.parametrize("B,L", TILED_SHAPES)
def test_encode_pipeline_matches_plain(lib, B, L, p, T, M, fixed, reverse):
    """Each iteration's roles in pipeline order, then in reverse: a slot
    overwritten before it is read fails the first, a tile read in the
    iteration that writes it the second."""
    x, coef, md, q15, plain = _encode_case(B, L, p, T, M)
    k4 = _call(lib, "sla_host_fused_encode", x, coef, md, q15, B, L, p, T, M, fixed, reverse)
    assert np.array_equal(k4, plain)


# -- K6 as a tile pipeline (filters.cuh LmsSynthPipe: the steps computed
# sample-parallel one iteration ahead of the chain; LmsSynthChain at M 4 and
# 8, the Lms body at a run-time order) --------------------------------------

LMS_SYNTH_ORDERS = [0, 1, 2, 4, 8, 13, 40]
# TILED_SHAPES hold L < M (1 and 37 samples against M 40) and ragged tiles
LMS_SYNTH_SHAPES = TILED_SHAPES + [(3, 5)]


@functools.lru_cache(maxsize=None)
def _lms_synth_case(B, L, M):
    x, _, _, _ = _tiled_inputs(B * 3 + L + M, B, L, 0, 0)
    return x, cuda_filters.lms_synth_plain(torch.from_numpy(x), M).numpy()


@pytest.mark.parametrize("reverse", [0, 1])
@pytest.mark.parametrize("fixed", [1, 0])
@pytest.mark.parametrize("M", LMS_SYNTH_ORDERS)
@pytest.mark.parametrize("B,L", LMS_SYNTH_SHAPES)
def test_lms_synth_pipeline_matches_plain(lib, B, L, M, fixed, reverse):
    """K6's roles in pipeline order, then in reverse: a step tile read in
    the iteration that writes it fails the second. Full-range rows with
    INT32_MIN samples (the step's magnitude is 2^31 there)."""
    x, plain = _lms_synth_case(B, L, M)
    k6 = _call(lib, "sla_host_lms_synth", x, B, L, M, fixed, reverse)
    assert np.array_equal(k6, plain)


# -- K7 as a lane schedule (filters.cuh longterm_row: a warp per row, steps of
# min(d, 128) samples, d = max(1, md - T + 1) the smallest live lag) --------

LONGTERM_TAPS = [0, 1, 3, 5]


@functools.lru_cache(maxsize=None)
def _longterm_case(B, L, T):
    x, _, md, q15 = _tiled_inputs(B * 11 + L + T, B, L, 0, T)
    if T and B > 20:  # steps of 31, 32, 33 and 127-129 samples, and the largest step
        md[13:21] = np.array([31, 32, 33, 34, 35, 130, 131, 132], np.int32) + T - 1
    plain = cuda_filters.longterm_synth_plain(*(torch.from_numpy(a) for a in (x, md, q15)))
    return x, md, q15, plain.numpy()


@pytest.mark.parametrize("reverse", [0, 1])
@pytest.mark.parametrize("fixed", [1, 0])
@pytest.mark.parametrize("T", LONGTERM_TAPS)
@pytest.mark.parametrize("B,L", TILED_SHAPES)
def test_longterm_lanes_match_plain(lib, B, L, T, fixed, reverse):
    """K7's lanes of each step forward, then in reverse: a lane that reads
    a sample written in its own step fails one of the two. Delays 0 (no
    stage), 1-9 (taps at or ahead of n at T 3 and 5), steps around 32 and
    128 samples, 256-258; full-range rows with INT32_MIN samples; the rows
    share one ring, so a slot read before it was written fails too."""
    x, md, q15, plain = _longterm_case(B, L, T)
    k7 = _call(lib, "sla_host_longterm_synth", x, md, q15, B, L, T, fixed, reverse)
    assert np.array_equal(k7, plain)


# -- K5 as a systolic schedule (filters.cuh lattice_synth_warp: lanes over
# stages, two rows on opposite step parities, 64 / G rows a warp) ------------

SYNTH_ORDERS = [0, 1, 5, 8, 16, 32, 48]
# B not a multiple of a warp's rows (4 at G 16), L of one, two and odd
# lengths, past a chunk (32) and a ring (64)
SYNTH_SHAPES = [(37, 1), (5, 2), (19, 33), (3, 65), (21, 131)]


@functools.lru_cache(maxsize=None)
def _lattice_synth_case(B, L, p, emphasis):
    x, coef, _, _ = _inputs(B * 13 + L + p + emphasis, B, L, p, 0, True)
    plain = cuda_filters.lattice_synth_plain(torch.from_numpy(x), torch.from_numpy(coef),
                                             bool(emphasis))
    return x, coef, plain.numpy()


@pytest.mark.parametrize("reverse", [0, 1])
@pytest.mark.parametrize("fixed", [1, 0])
@pytest.mark.parametrize("emphasis", [1, 0])
@pytest.mark.parametrize("p", SYNTH_ORDERS)
def test_lattice_synth_lanes_match_plain(lib, p, emphasis, fixed, reverse):
    """K5's lane schedule, each step's lanes forward, then in reverse, on
    full-range rows with INT32_MIN samples; fixed 1 runs the kernel's
    configuration for p (32 stages up to p 32), fixed 0 the widest (48),
    the stages above p at coefficient 0 in both. The warps
    share one pair of rings, so a slot read before it was written fails."""
    for B, L in SYNTH_SHAPES:
        x, coef, plain = _lattice_synth_case(B, L, p, emphasis)
        k5 = _call(lib, "sla_host_lattice_synth", x, coef, B, L, p, emphasis, fixed, reverse)
        assert np.array_equal(k5, plain), (B, L)


# -- the entropy kernels' bodies (csrc/entropy.cuh): K8 and K9 ----------------


def host_rice_encode(lib, rows, row0, counts, inits, C, fixed=1):
    """K8's schedule through the g++ build: the chain pass, the 4-byte aligned
    exclusive sum, the emit pass. Returns (payload, offsets, sizes)."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    r0 = np.ascontiguousarray(row0, dtype=np.int32)
    cnt = np.ascontiguousarray(counts, dtype=np.int32)
    ini = np.ascontiguousarray(inits, dtype=np.int64)
    B, L = len(cnt), rows.shape[1]
    sizes = np.empty(B, dtype=np.int64)
    recs = np.empty(max(B * L * C, 1), dtype=np.uint16)
    args = (rows.ctypes.data, L, r0.ctypes.data, cnt.ctypes.data, ini.ctypes.data, B, C)
    lib.sla_host_rice_encode_blocks(*args, None, None, sizes.ctypes.data, recs.ctypes.data, 0,
                                    fixed)
    padded = (sizes + 3) & ~3
    offsets = np.cumsum(padded) - padded
    out = np.zeros(max(int(padded.sum()), 4), dtype=np.uint8)
    lib.sla_host_rice_encode_blocks(*args, offsets.ctypes.data, out.ctypes.data,
                                    sizes.ctypes.data, recs.ctypes.data, 1, fixed)
    return out[: int(padded.sum())], offsets, sizes


def host_rice_decode(lib, stream, offsets, W, counts, inits, C, n_max, fixed=1):
    """K9's body through the g++ build on the uint8 stream (a whole number
    of words, the last zero). Returns (rows (B*C, n_max), bad (B,))."""
    buf = np.ascontiguousarray(stream, dtype=np.uint8)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    cnt = np.ascontiguousarray(counts, dtype=np.int32)
    ini = np.ascontiguousarray(inits, dtype=np.int64)
    B = len(cnt)
    rows = np.empty((B * C, n_max), dtype=np.int32)
    bad = np.empty(B, dtype=np.uint8)
    lib.sla_host_rice_decode_blocks(buf.ctypes.data, buf.size // 4, offs.ctypes.data, W,
                                    cnt.ctypes.data, ini.ctypes.data, B, C, n_max,
                                    rows.ctypes.data, bad.ctypes.data, fixed)
    return rows, bad.astype(bool)


# (blocks, channels, samples): one block, a short last block among a few,
# eight channels, mono; blocks longer than many of K9's 32-word ring
# refills and K8's 1,024-symbol emit tiles; counts that are no multiple of
# K8's 64-sample chain tile or K9's 32-sample output tile (97, and the last
# block's 73); three channels, which leave two of a chain warp's lanes idle
ENTROPY_CASES = [(1, 2, 700), (3, 2, 1500), (4, 8, 300), (5, 1, 900), (2, 2, 2600),
                 (3, 2, 97), (3, 3, 200)]


def symbol_ends(rows, counts, inits, C, b):
    """The bit ends of block b's symbols in stream order, from its payload's
    first bit (the plain parts scan's lengths)."""
    from sla_tpu_torch import rice_device

    n = int(counts[b])
    lengths = rice_device.encode_parts64(torch.from_numpy(rows[b * C : (b + 1) * C, :n]),
                                         torch.from_numpy(inits[b].astype(np.int64)))[1]
    return torch.cumsum(lengths.sum(-1).reshape(-1).to(torch.int64), 0).numpy()


def plant_run(stream: bytes, bit: int) -> bytes:
    """The stream with 17 zeros from `bit` on: a unary run past 16 there."""
    bits = np.unpackbits(np.frombuffer(stream, dtype=np.uint8)).copy()
    bits[bit : bit + 17] = 0
    return np.packbits(bits).tobytes()


def truncated(rows, C, b, k):
    """The rows with block b's symbols from stream index k on read as 0."""
    out = rows.copy()
    blk = out[b * C : (b + 1) * C]
    s, c = divmod(k, C)
    blk[c:, s] = 0
    blk[:, s + 1 :] = 0
    return out


def ring_flag_cases(stream, offs, rows, counts, inits, C):
    """Two streams with a flag planted in block 0 and in the last block:
    at the first symbol that starts in one of K9's 32-word ring refills
    (words 32 m onward from the block's first word), then at the last
    symbol before it. Yields (name, stream, flags, expected rows)."""
    B = len(counts)
    for name, which in (("first of a ring refill", 0), ("last before a ring refill", -1)):
        data, want = stream, rows
        flags = np.zeros(B, dtype=bool)
        for b in sorted({0, B - 1}):
            ends = symbol_ends(rows, counts, inits, C, b)
            rel = offs[b] % 32 + np.concatenate([[0], ends[:-1]])  # from the first word
            m = max(1, min(3, int(rel.max()) // 1024))
            k = int(np.searchsorted(rel, 1024 * m)) + which
            data = plant_run(data, int(offs[b]) + int(rel[k]) - int(offs[b] % 32))
            want = truncated(want, C, b, k)
            flags[b] = True
        yield name, data, flags, want


def limit_flag_cases(rows, counts, inits, C):
    """Block 0 alone, placed so that a symbol ends exactly at the cursor
    limit W * 32 (it passes and the next one flags), then one bit later
    (it flags). Yields (name, stream, offsets, W, flags, expected rows)."""
    ends = symbol_ends(rows, counts, inits, C, 0)
    payload = native_payload(rows, counts, inits, C, 0)
    for W in range(int(ends[-1]) // 64, 0, -1):
        hits = np.flatnonzero((W * 32 - ends[:-1] >= 0) & (W * 32 - ends[:-1] <= 30))
        if hits.size:
            break
    k = int(hits[-1])
    o = W * 32 - int(ends[k])
    block0 = rows[:C]
    for name, at, flag_at in (("a symbol ending at the limit", o, k + 1),
                              ("a symbol ending one bit past it", o + 1, k)):
        bits = np.concatenate([np.ones(at, dtype=np.uint8),
                               np.unpackbits(np.frombuffer(payload, dtype=np.uint8))])
        yield (name, np.packbits(bits).tobytes(), np.array([at], dtype=np.int64), W,
               np.array([True]), truncated(block0, C, 0, flag_at))


def native_payload(rows, counts, inits, C, b):
    from sla_tpu_torch import native

    return native.put_data_array(rows[b * C : (b + 1) * C, : counts[b]], list(inits[b]))


def longest_block(C, n):
    """A block of the code's longest symbols: each residual's zigzag is k0 +
    0xFF000000 for its symbol's k0, so the update terms wrap to 9 * (k0 <<
    8) (stage 0) and 0 (stage 1), both Rice parameters fall from the initial
    40 to 2^0 within 60 samples, and every symbol after that is an escape
    with a gamma code of 32 digits, 80 bits. Returns (rows (C, n), inits
    (1, C), payload (the host coder's))."""
    M = 0xFFFFFFFF

    def rice_bits(p):
        return ((((p >> 1) + 128) >> 8) - 1 & M).bit_length() & 31

    def update(p, code):
        return (119 * p + (9 * (code << 8 & M) & M) + 64) >> 7 & M

    rows = np.empty((C, n), dtype=np.int32)
    bits = np.empty((C, n), dtype=np.int64)
    for c in range(C):
        pa = pb = 40 << 8
        for s in range(n):
            k0, b1 = 1 << rice_bits(pa), rice_bits(pb)
            u = k0 + 0xFF000000
            pa, pb = update(pa, u), update(pb, u - k0)
            rows[c, s] = (u >> 1) ^ -(u & 1)
            bits[c, s] = 16 + 2 * ((0xFF000000 >> b1) - 14).bit_length() + b1
    assert (bits[:, 60:] == 80).all()
    inits = np.full((1, C), 40, dtype=np.int64)
    payload = native_payload(rows, [n], inits, C, 0)
    assert len(payload) == (int(bits.sum()) + 7) // 8
    return rows, inits, payload


def at_alignment(payload: bytes, at: int) -> bytes:
    """The payload after `at` one bits."""
    bits = np.unpackbits(np.frombuffer(payload, dtype=np.uint8))
    return np.packbits(np.concatenate([np.ones(at, dtype=np.uint8), bits])).tobytes()


@pytest.mark.parametrize("fixed", [1, 0])
@pytest.mark.parametrize("B,C,L", ENTROPY_CASES)
def test_rice_encode_body_matches_plain_and_host_coder(lib, B, C, L, fixed):
    """K8's body (count, then emit) gives the plain version's buffer byte for
    byte, and each block's payload is the host coder's (the compile-time
    channel count for C 1 and 2 with fixed 1, the run-time one otherwise),
    a block of the longest symbols too."""
    from sla_tpu_torch import native
    from sla_tpu_torch.kernels import cuda_entropy
    from sla_tpu_torch.tools.verify_device import entropy_blocks

    rows, counts, inits = entropy_blocks(B * 31 + C + L, B, C, L, 3000.0)
    row0 = np.arange(0, B * C, C, dtype=np.int32)
    got = host_rice_encode(lib, rows, row0, counts, inits, C, fixed)
    want = cuda_entropy.rice_encode_blocks_plain(
        torch.from_numpy(rows), torch.from_numpy(row0), torch.from_numpy(counts),
        torch.from_numpy(inits.astype(np.int64)), C)
    for a, b in zip(got, want):
        assert np.array_equal(a, b.numpy())
    payload, offsets, sizes = got
    for b in range(B):
        block = rows[b * C : (b + 1) * C, : counts[b]]
        assert (payload[offsets[b] : offsets[b] + sizes[b]].tobytes()
                == native.put_data_array(block, list(inits[b])))
    # a block of the longest symbols, each ORed over three words
    n = min(L, 160)
    rows1, inits1, payload1 = longest_block(C, n)
    got1 = host_rice_encode(lib, rows1, [0], [n], inits1, C, fixed)
    assert got1[0][: got1[2][0]].tobytes() == payload1


@pytest.mark.parametrize("fixed", [1, 0])
@pytest.mark.parametrize("B,C,L", ENTROPY_CASES)
def test_rice_decode_body_matches_plain(lib, B, C, L, fixed):
    """K9's body on payloads at every bit alignment gives the host coder's
    rows and no flag, as the plain version does; with the flag conditions
    planted, the same flags and the same unflagged rows; a block of the
    longest symbols at every bit alignment."""
    from sla_tpu_torch import rice_device
    from sla_tpu_torch.kernels import cuda_entropy
    from sla_tpu_torch.tools import verify_device as vd

    rows, counts, inits = vd.entropy_blocks(B * 37 + C + L, B, C, L, 3000.0)
    stream, offs, bits = vd.entropy_stream(B + C, rows, counts, inits, C)
    ini = inits.astype(np.int64)

    def both(data, offsets, W, cnt, n_max):
        words = rice_device.upload_stream(data, "cpu")
        k = host_rice_decode(lib, words.numpy(), offsets, W, cnt, ini[: len(cnt)], C, n_max, fixed)
        p = cuda_entropy.rice_decode_blocks_plain(
            words, torch.from_numpy(offsets), W, torch.from_numpy(cnt),
            torch.from_numpy(ini[: len(cnt)]), C, n_max)
        return k, p

    # flags planted at K9's ring refills and at the cursor limit: the same
    # flags, stopping at the same symbol, zeros after it, as the plain version
    W = rice_device.window_width(offs, bits)
    for name, data, flags, want in ring_flag_cases(stream, offs, rows, counts, inits, C):
        (k_rows, k_bad), (p_rows, p_bad) = both(data, offs, W, counts, L)
        assert np.array_equal(k_bad, flags) and np.array_equal(p_bad.numpy(), flags), name
        assert np.array_equal(k_rows, want) and np.array_equal(p_rows.numpy(), want), name
    for name, data, o, Wl, flags, want in limit_flag_cases(rows, counts, inits, C):
        (k_rows, k_bad), (p_rows, p_bad) = both(data, o, Wl, counts[:1], L)
        assert np.array_equal(k_bad, flags) and np.array_equal(p_bad.numpy(), flags), name
        assert np.array_equal(k_rows, want) and np.array_equal(p_rows.numpy(), want), name
    # rows longer than every count: zeros past them
    (k_rows, k_bad), _ = both(stream, offs, W, counts, L + 45)
    assert not k_bad.any() and np.array_equal(k_rows[:, :L], rows) and not k_rows[:, L:].any()
    # a block of the longest symbols at every bit alignment: a sample reads
    # the most ring words past the cursor's word there
    n = min(L, 160)
    rows1, inits1, payload1 = longest_block(C, n)
    cnt1 = np.array([n], dtype=np.int32)
    for at in range(32):
        o = np.array([at], dtype=np.int64)
        W1 = rice_device.window_width(o, np.array([8 * len(payload1)]))
        words = rice_device.upload_stream(at_alignment(payload1, at), "cpu").numpy()
        k_rows, k_bad = host_rice_decode(lib, words, o, W1, cnt1, inits1, C, n, fixed)
        assert not k_bad.any() and np.array_equal(k_rows, rows1), at
    p_rows, p_bad = cuda_entropy.rice_decode_blocks_plain(
        torch.from_numpy(words), torch.from_numpy(o), W1, torch.from_numpy(cnt1),
        torch.from_numpy(inits1), C, n)
    assert not bool(p_bad.any()) and np.array_equal(p_rows.numpy(), rows1)
    # a cursor past the window (512 words from the block's first word)
    # flags every payload longer than it and no payload well inside it
    window = 512 * 32
    short = np.where(bits > window + 64, True, np.where(bits < window - 64, False, None))
    cases = [(stream, bits, np.zeros(B, dtype=object)), (stream, np.full_like(bits, 64), short)]
    if B >= 2:
        planted = np.zeros(B, dtype=object)
        planted[:2] = True
        cases.append((vd.corrupt_entropy_stream(stream, offs), bits, planted))
    for data, region, flags in cases:
        words = rice_device.upload_stream(data, "cpu")
        W = rice_device.window_width(offs, region)
        k_rows, k_bad = host_rice_decode(lib, words.numpy(), offs, W, counts,
                                         inits.astype(np.int64), C, L, fixed)
        p_rows, p_bad = cuda_entropy.rice_decode_blocks_plain(
            words, torch.from_numpy(offs), W, torch.from_numpy(counts),
            torch.from_numpy(inits.astype(np.int64)), C, L)
        ok, _ = cuda_entropy.decode_agrees(torch.from_numpy(k_rows), torch.from_numpy(k_bad),
                                           p_rows, p_bad, C)
        assert ok
        known = flags != None  # noqa: E711 (elementwise)
        assert np.array_equal(k_bad[known], flags[known].astype(bool))
        if data is stream and region is bits:
            assert np.array_equal(k_rows, rows)
