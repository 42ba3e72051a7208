"""Plain PyTorch filters of sla_tpu_torch against sla_tpu's lax.scan twins.

Same seeded numpy inputs and starting states through both; every
comparison is exact (an integer codec: tolerance 0). Non-zero states go
across through sla_tpu_torch.params, the converter the port uses."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sla_tpu
from sla_tpu import pipeline as jpipe
from sla_tpu.kernels import emphasis as jemph
from sla_tpu.kernels import lattice as jlat
from sla_tpu.kernels import lms as jlms
from sla_tpu.kernels import longterm as jlt

import sla_tpu_torch
from sla_tpu_torch import params
from sla_tpu_torch import pipeline as tpipe
from sla_tpu_torch.kernels import emphasis as temph
from sla_tpu_torch.kernels import lattice as tlat
from sla_tpu_torch.kernels import lms as tlms
from sla_tpu_torch.kernels import longterm as tlt

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _rows(rng, B, N, lo=-(1 << 20), hi=1 << 20, extremes=True):
    x = rng.integers(lo, hi, (B, N), dtype=np.int64)
    if extremes and N:
        # full-range and INT32_MIN samples exercise every wrap
        x[0, :: max(1, N // 7)] = I32_MIN
        x[-1, :] = rng.integers(I32_MIN, I32_MAX, N, dtype=np.int64, endpoint=True)
    return x.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _eq(port, ref):
    ref = np.asarray(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert port.shape == ref.shape
    assert np.array_equal(port, ref)


def test_presets_match_sla_tpu():
    assert sla_tpu_torch.DEFAULT_PRESET == sla_tpu.DEFAULT_PRESET
    assert len(sla_tpu_torch.PRESETS) == len(sla_tpu.PRESETS)
    for a, b in zip(sla_tpu_torch.PRESETS, sla_tpu.PRESETS):
        assert (a.parcor_order, a.longterm_order, a.lms_order_per_filter,
                int(a.ch_process_method), int(a.window_function_type),
                a.max_num_block_samples) == (
                b.parcor_order, b.longterm_order, b.lms_order_per_filter,
                int(b.ch_process_method), int(b.window_function_type),
                b.max_num_block_samples)
    for n in range(5):
        for ch in (1, 2):
            a = sla_tpu_torch.preset_parameter(n, ch)
            b = sla_tpu.preset_parameter(n, ch)
            assert int(a.ch_process_method) == int(b.ch_process_method)


@pytest.mark.parametrize("N", [1, 7, 300])
def test_emphasis(N):
    rng = np.random.default_rng(N)
    B = 6
    x = _rows(rng, B, N, I32_MIN, I32_MAX)
    prev = rng.integers(I32_MIN, I32_MAX, B, dtype=np.int64).astype(np.int32)
    ro, rp = jemph.pre_emphasis(jnp.asarray(x), jnp.asarray(prev))
    po, pp = temph.pre_emphasis(_t(x), _t(prev))
    _eq(po, ro)
    _eq(pp, rp)
    ro, rp = jemph.de_emphasis(jnp.asarray(x), jnp.asarray(prev))
    po, pp = temph.de_emphasis(_t(x), _t(prev))
    _eq(po, ro)
    _eq(pp, rp)


@pytest.mark.parametrize("p", [0, 1, 8, 16, 32])
@pytest.mark.parametrize("synthesize", [False, True])
@pytest.mark.parametrize("state", ["zero", "carried"])
def test_lattice(p, synthesize, state):
    rng = np.random.default_rng(100 + p)
    B, N = 5, 200
    x = _rows(rng, B, N)
    coef = rng.integers(-32768, 32768, (B, p), dtype=np.int32)
    back = (
        rng.integers(-(1 << 24), 1 << 24, (B, p + 1), dtype=np.int32)
        if state == "carried" else np.zeros((B, p + 1), np.int32)
    )
    jf = jlat.lattice_synthesize if synthesize else jlat.lattice_predict
    tf = tlat.lattice_synthesize if synthesize else tlat.lattice_predict
    ro, rs = jf(jnp.asarray(x), jnp.asarray(coef), jnp.asarray(back))
    po, ps = tf(_t(x), _t(coef), params.lattice_state(back))
    _eq(po, ro)
    _eq(ps, rs)


@pytest.mark.parametrize("N", [1, 3])
def test_lattice_short_rows(N):
    rng = np.random.default_rng(7)
    B, p = 4, 16
    x = _rows(rng, B, N, extremes=False)
    coef = rng.integers(-32768, 32768, (B, p), dtype=np.int32)
    back = rng.integers(-(1 << 20), 1 << 20, (B, p + 1), dtype=np.int32)
    for jf, tf in ((jlat.lattice_predict, tlat.lattice_predict),
                   (jlat.lattice_synthesize, tlat.lattice_synthesize)):
        ro, rs = jf(jnp.asarray(x), jnp.asarray(coef), jnp.asarray(back))
        po, ps = tf(_t(x), _t(coef), params.lattice_state(back))
        _eq(po, ro)
        _eq(ps, rs)


def _lms_state(rng, B, M, carried):
    if not carried:
        return tuple(np.zeros((B, M), np.int32) for _ in range(4)) + (
            np.zeros(B, np.int32),)
    fc = rng.integers(-4096, 4096, (B, M), dtype=np.int32)
    ic = rng.integers(-4096, 4096, (B, M), dtype=np.int32)
    xb = rng.integers(-(1 << 16), 1 << 16, (B, M), dtype=np.int32)
    pb = rng.integers(-(1 << 16), 1 << 16, (B, M), dtype=np.int32)
    # some rows still in warmup, some past it
    t = rng.integers(0, 2 * M + 1, B, dtype=np.int32)
    return fc, ic, xb, pb, t


@pytest.mark.parametrize("M", [0, 4, 8, 16])
@pytest.mark.parametrize("synthesize", [False, True])
@pytest.mark.parametrize("state", ["zero", "carried"])
def test_lms(M, synthesize, state):
    rng = np.random.default_rng(200 + M)
    B, N = 6, 250
    x = _rows(rng, B, N)
    st = _lms_state(rng, B, M, state == "carried")
    jf = jlms.lms_synthesize if synthesize else jlms.lms_predict
    tf = tlms.lms_synthesize if synthesize else tlms.lms_predict
    ro, rs = jf(jnp.asarray(x), jlms.LmsState(*(jnp.asarray(s) for s in st)), M)
    po, ps = tf(_t(x), params.lms_state(st), M)
    _eq(po, ro)
    for a, b in zip(ps, rs):
        _eq(a, b)


def test_lms_int32_min_residuals():
    """|INT32_MIN| stays INT32_MIN in int32: the step must still use the
    uint32 magnitude 2^31 (bit length 32)."""
    B, N, M = 3, 64, 8
    x = np.full((B, N), I32_MIN, dtype=np.int32)
    x[1, ::2] = I32_MAX
    x[2, ::3] = 0
    for jf, tf in ((jlms.lms_predict, tlms.lms_predict),
                   (jlms.lms_synthesize, tlms.lms_synthesize)):
        ro, _ = jf(jnp.asarray(x), jlms.lms_init_state(B, M), M)
        po, _ = tf(_t(x), tlms.lms_init_state(B, M), M)
        _eq(po, ro)


def _pitches(rng, B, T):
    pitch = rng.integers(3, 257, B).astype(np.int32)
    pitch[::4] = 0  # no long-term stage
    pitch[1::5] = rng.integers(1, 8, len(pitch[1::5]))  # lags under 8
    if T >= 3:
        pitch[2] = 1  # a tap at or ahead of the current sample
    return pitch


@pytest.mark.parametrize("T", [0, 1, 3, 5])
@pytest.mark.parametrize("state", ["zero", "carried"])
def test_longterm_predict(T, state):
    rng = np.random.default_rng(300 + T)
    B, N = 12, 600
    x = _rows(rng, B, N)
    pitch = _pitches(rng, B, T)
    coef = (rng.integers(-32768, 32768, (B, max(T, 1)), dtype=np.int32) << 16)[:, :T]
    proc = (rng.integers(0, 300, B) if state == "carried" else np.zeros(B)).astype(np.int32)
    ro, rp = jlt.longterm_predict(jnp.asarray(x), jnp.asarray(pitch), jnp.asarray(coef), T,
                                  jnp.asarray(proc))
    po, pp = tlt.longterm_predict(_t(x), _t(pitch), _t(coef), T, _t(proc))
    _eq(po, ro)
    _eq(pp, rp)


@pytest.mark.parametrize("T", [0, 1, 3, 5])
@pytest.mark.parametrize("state", ["zero", "carried"])
def test_longterm_synthesize(T, state):
    rng = np.random.default_rng(400 + T)
    B, N = 12, 600
    x = _rows(rng, B, N)
    pitch = _pitches(rng, B, T)
    coef = (rng.integers(-32768, 32768, (B, max(T, 1)), dtype=np.int32) << 16)[:, :T]
    if state == "carried":
        hist = rng.integers(-(1 << 20), 1 << 20, (B, tlt.MAX_DELAY), dtype=np.int32)
        proc = rng.integers(0, 300, B).astype(np.int32)
    else:
        hist, proc = np.zeros((B, tlt.MAX_DELAY), np.int32), np.zeros(B, np.int32)
    ro, (rh, rp) = jlt.longterm_synthesize(
        jnp.asarray(x), jnp.asarray(pitch), jnp.asarray(coef), T,
        (jnp.asarray(hist), jnp.asarray(proc)),
    )
    po, (ph, pp) = tlt.longterm_synthesize(
        _t(x), _t(pitch), _t(coef), T, params.longterm_state((hist, proc))
    )
    _eq(po, ro)
    _eq(ph, rh)
    _eq(pp, rp)


def _stage_inputs(seed, B, L, p, T):
    rng = np.random.default_rng(seed)
    x = _rows(rng, B, L, -(1 << 18), 1 << 18, extremes=False)
    coef = rng.integers(-25000, 25000, (B, p), dtype=np.int32)
    pitch = _pitches(rng, B, T) if T else np.zeros(B, np.int32)
    ltm = rng.integers(-32768, 32768, (B, max(T, 1)), dtype=np.int32) << 16
    return x, coef, pitch, ltm


@pytest.mark.parametrize("p,T,M", [(16, 1, 8), (32, 3, 8), (8, 1, 4), (0, 0, 0), (1, 5, 16)])
def test_pipeline_stages(p, T, M):
    """The port's encode_stage1 / encode_stage2 / decode_stage / plain
    encode_filters against sla_tpu's pipeline on the CPU (its scan
    path)."""
    B, L = 9, 400
    x, coef, pitch, ltm = _stage_inputs(500 + p, B, L, p, T)
    r1 = jpipe.encode_stage1(jnp.asarray(x), jnp.asarray(coef), p)
    r2 = jpipe.encode_stage2(r1, jnp.asarray(pitch), jnp.asarray(ltm), T, M)
    ref_dec = jpipe.decode_stage(jnp.asarray(x), jnp.asarray(coef), jnp.asarray(pitch),
                                 jnp.asarray(ltm), p, T, M)
    ref_all = jpipe.encode_filters(jnp.asarray(x), jnp.asarray(coef), jnp.asarray(pitch),
                                   jnp.asarray(ltm), p, T, M)
    t1 = tpipe.encode_stage1(_t(x), _t(coef), p)
    _eq(t1, r1)
    _eq(tpipe.encode_stage2(t1, pitch, ltm, T, M), r2)
    _eq(tpipe.decode_stage(_t(x), _t(coef), pitch, ltm, p, T, M), ref_dec)
    _eq(tpipe.encode_filters(_t(x), _t(coef), pitch, ltm, p, T, M), ref_all)
    # a round trip through the port alone is exact too, for the pitches a
    # stream can carry (> T//2, decoder.py:339; a tap at or ahead of the
    # current sample has no inverse)
    ok = np.where((pitch > 0) & (pitch <= T // 2), T // 2 + 1, pitch)
    r2 = tpipe.encode_stage2(t1, ok, ltm, T, M)
    _eq(tpipe.decode_stage(r2, _t(coef), ok, ltm, p, T, M), x)


def test_longterm_params_layout():
    pitch = np.array([0, 3, 256, 17], np.int32)
    ltm = (np.arange(12, dtype=np.int32).reshape(4, 3) - 6) << 16
    md, q15 = params.longterm_params(pitch, ltm, 3)
    assert md.tolist() == [0, 4, 257, 18]
    assert q15.tolist() == (np.arange(12).reshape(4, 3) - 6).tolist()
    md0, q0 = params.longterm_params(pitch, ltm, 0)
    assert md0.tolist() == [0, 0, 0, 0] and q0.shape == (4, 0)
    with pytest.raises(ValueError):
        params.longterm_params(np.array([300]), ltm[:1], 3)
