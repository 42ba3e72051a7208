"""The CUDA kernels' per-row bodies (csrc/filters.cuh), built for the CPU
with g++ -fwrapv, against the plain PyTorch versions: the kernels'
arithmetic checked without a card. Both the compile-time-order
instantiations the presets take and the run-time-order one are run.
Exact comparisons (integer codec, tolerance 0)."""

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


def _call(lib, fn, x, *args):
    """Runs a host entry on (B, L) rows in the kernels' (L, B) layout."""
    x_t = np.ascontiguousarray(x.T)
    y_t = np.empty_like(x_t)
    keep = [np.ascontiguousarray(a) if isinstance(a, np.ndarray) else a for a in args]
    ptrs = [a.ctypes.data if isinstance(a, np.ndarray) else a for a in keep]
    getattr(lib, fn)(x_t.ctypes.data, y_t.ctypes.data, *ptrs)
    return y_t.T


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

    k1 = _call(lib, "sla_host_lattice_predict", x, coef, B, L, p, 1, fixed)
    assert np.array_equal(k1, cuda_filters.lattice_predict_plain(X, C).numpy())

    k2 = _call(lib, "sla_host_stage2_predict", x, md, q15, B, L, T, M, fixed)
    assert np.array_equal(k2, cuda_filters.stage2_predict_plain(X, MD, Q, M).numpy())

    hist = np.zeros((L, B), np.int32)
    k3 = _call(lib, "sla_host_synth_cascade", x, hist, coef, md, q15, B, L, p, T, M, fixed)
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

    hist = np.zeros((L, B), np.int32)
    k4 = _call(lib, "sla_host_fused_encode", x, hist, coef, md, q15, B, L, p, T, M, fixed)
    assert np.array_equal(k4, cuda_filters.fused_encode_plain(X, C, MD, Q, M).numpy())

    for emphasis in (1, 0):
        k5 = _call(lib, "sla_host_lattice_synth", x, coef, B, L, p, emphasis, fixed)
        assert np.array_equal(k5, cuda_filters.lattice_synth_plain(X, C, bool(emphasis)).numpy())
    k1 = _call(lib, "sla_host_lattice_predict", x, coef, B, L, p, 0, fixed)
    assert np.array_equal(k1, cuda_filters.lattice_predict_plain(X, C, False).numpy())

    k6 = _call(lib, "sla_host_lms_synth", x, B, L, M, fixed)
    assert np.array_equal(k6, cuda_filters.lms_synth_plain(X, M).numpy())

    hist = np.zeros((L, B), np.int32)
    k7 = _call(lib, "sla_host_longterm_synth", x, hist, md, q15, B, L, T, fixed)
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
        r = _call(lib, "sla_host_lattice_predict", x, coef, B, L, p, emphasis, 1)
        assert np.array_equal(_call(lib, "sla_host_lattice_synth", r, coef, B, L, p, emphasis, 1), x)
    r = _call(lib, "sla_host_stage2_predict", x, no_md, no_q, B, L, 0, M, 1)
    assert np.array_equal(_call(lib, "sla_host_lms_synth", r, B, L, M, 1), x)
    r = _call(lib, "sla_host_stage2_predict", x, md, q15, B, L, T, 0, 1)
    hist = np.zeros((L, B), np.int32)
    assert np.array_equal(_call(lib, "sla_host_longterm_synth", r, hist, md, q15, B, L, T, 1), x)
    hist = np.zeros((L, B), np.int32)
    r = _call(lib, "sla_host_fused_encode", x, hist, coef, md, q15, B, L, p, T, M, 1)
    hist = np.zeros((L, B), np.int32)
    out = _call(lib, "sla_host_synth_cascade", r, hist, coef, md, q15, B, L, p, T, M, 1)
    assert np.array_equal(out, x)


def test_row_bodies_round_trip(lib):
    """K3 inverts K1 then K2 on the stream's pitch range (> T//2)."""
    B, L, p, T, M = 16, 900, 32, 3, 8
    x, coef, _, q15 = _inputs(7, B, L, p, T, False)
    rng = np.random.default_rng(8)
    pitch = rng.integers(T // 2 + 1, 257, B)
    pitch[::3] = 0
    md = np.where(pitch > 0, pitch + T // 2, 0).astype(np.int32)
    r1 = _call(lib, "sla_host_lattice_predict", x, coef, B, L, p, 1, 1)
    r2 = _call(lib, "sla_host_stage2_predict", r1, md, q15, B, L, T, M, 1)
    hist = np.zeros((L, B), np.int32)
    out = _call(lib, "sla_host_synth_cascade", r2, hist, coef, md, q15, B, L, p, T, M, 1)
    assert np.array_equal(out, x)
