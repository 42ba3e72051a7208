"""The port's seven kernel functions, run through their plain PyTorch
versions, against sla_tpu's Pallas kernels in interpret mode (as
tests/test_pallas.py runs them on the CPU), on (2048, 128) cases.
Exact comparisons: an integer codec, tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sla_tpu  # noqa: F401  (x64 before any tracing)
from sla_tpu.kernels.pallas_filters import (
    TILE_B, TILE_L, fused_encode_tl, fused_stage2_tl, fused_synth_tl,
    lattice_filter_tl, lms_filter_tl, longterm_ring_depth, longterm_synth_tl,
)
from sla_tpu.pipeline import _longterm_window_plan

from sla_tpu_torch import params
from sla_tpu_torch.kernels import cuda_filters

B, L = TILE_B, TILE_L  # (2048 samples, 128 rows)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _long_rows(seed, T):
    rng = np.random.default_rng(seed)
    res = rng.integers(-(1 << 20), 1 << 20, (B, L), dtype=np.int32)
    coef = rng.integers(-25000, 25000, (B, 16), dtype=np.int32)
    # one 128-row tile: a lag band narrow enough for the window plan
    pitch = rng.integers(60, 200, B).astype(np.int32)
    pitch[5::9] = 0
    ltm = rng.integers(-32768, 32768, (B, T), dtype=np.int32) << 16
    md, q15 = params.longterm_params(pitch, ltm, T)
    prm = np.concatenate([md.numpy()[:, None], q15.numpy()], axis=1)
    return res, coef, pitch, ltm, md, q15, prm


def test_k1_matches_lattice_filter_tl():
    rng = np.random.default_rng(61)
    data = rng.integers(-30000, 30000, (B, L), dtype=np.int32)
    coef = rng.integers(-25000, 25000, (B, 16), dtype=np.int32)
    ref = np.asarray(
        lattice_filter_tl(jnp.asarray(data.T), jnp.asarray(coef.T), 16, interpret=True)
    ).T
    out = cuda_filters.lattice_predict(_t(data), _t(coef))
    assert np.array_equal(out.numpy(), ref)


def test_k2_matches_fused_stage2_tl():
    T, M = 3, 8
    res, _, pitch, _, md, q15, prm = _long_rows(62, T)
    lt_win, hi8s, order = _longterm_window_plan(pitch, T, B)
    assert lt_win > 0, "window plan did not engage"
    perm = np.arange(B) if order is None else order
    ring = longterm_ring_depth(int(md.max()))
    ref_sorted = np.asarray(
        fused_stage2_tl(jnp.asarray(res[perm].T), jnp.asarray(prm[perm].T), T, M,
                        hist_d=ring, lt_win=lt_win, hi8s=jnp.asarray(hi8s),
                        interpret=True)
    ).T
    ref = np.empty_like(ref_sorted)
    ref[perm] = ref_sorted
    out = cuda_filters.stage2_predict(_t(res), md, q15, M)
    assert np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize("windowed", [False, True])
def test_k3_matches_fused_synth_tl(windowed):
    T, M, p = 1, 8, 16
    res, coef, pitch, _, md, q15, prm = _long_rows(63, T)
    kw = {}
    perm = np.arange(B)
    if windowed:
        lt_win, hi8s, order = _longterm_window_plan(pitch, T, B)
        assert lt_win > 0, "window plan did not engage"
        perm = perm if order is None else order
        kw = dict(hist_d=longterm_ring_depth(int(md.max())), lt_win=lt_win,
                  hi8s=jnp.asarray(hi8s))
    ref_sorted = np.asarray(
        fused_synth_tl(jnp.asarray(res[perm].T), jnp.asarray(coef[perm].T),
                       jnp.asarray(prm[perm].T), p, T, M, interpret=True, **kw)
    ).T
    ref = np.empty_like(ref_sorted)
    ref[perm] = ref_sorted
    out = cuda_filters.synth_cascade(_t(res), _t(coef), md, q15, M)
    assert np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize("synthesize,emphasis", [(False, False), (True, True), (True, False)])
def test_lattice_matches_lattice_filter_tl(synthesize, emphasis):
    """K1 without pre-emphasis, and K5 with and without de-emphasis."""
    rng = np.random.default_rng(64)
    data = rng.integers(-30000, 30000, (B, L), dtype=np.int32)
    coef = rng.integers(-25000, 25000, (B, 16), dtype=np.int32)
    ref = np.asarray(
        lattice_filter_tl(jnp.asarray(data.T), jnp.asarray(coef.T), 16,
                          pre_emphasis=emphasis, synthesize=synthesize, interpret=True)
    ).T
    kernel = cuda_filters.lattice_synth if synthesize else cuda_filters.lattice_predict
    out = kernel(_t(data), _t(coef), emphasis)
    assert np.array_equal(out.numpy(), ref)


def test_k4_matches_fused_encode_tl():
    p, T, M = 16, 3, 8
    _, coef, pitch, _, md, q15, prm = _long_rows(65, T)
    data = np.random.default_rng(66).integers(-30000, 30000, (B, L), dtype=np.int32)
    lt_win, hi8s, order = _longterm_window_plan(pitch, T, B)
    assert lt_win > 0, "window plan did not engage"
    perm = np.arange(B) if order is None else order
    ref_sorted = np.asarray(
        fused_encode_tl(jnp.asarray(data[perm].T), jnp.asarray(coef[perm].T),
                        jnp.asarray(prm[perm].T), p, T, M,
                        hist_d=longterm_ring_depth(int(md.max())), lt_win=lt_win,
                        hi8s=jnp.asarray(hi8s), interpret=True)
    ).T
    ref = np.empty_like(ref_sorted)
    ref[perm] = ref_sorted
    out = cuda_filters.fused_encode(_t(data), _t(coef), md, q15, M)
    assert np.array_equal(out.numpy(), ref)


def test_k6_matches_lms_filter_tl_synth():
    M = 8
    data = np.random.default_rng(67).integers(-(1 << 20), 1 << 20, (B, L), dtype=np.int32)
    ref = np.asarray(lms_filter_tl(jnp.asarray(data.T), M, synthesize=True, interpret=True)).T
    out = cuda_filters.lms_synth(_t(data), M)
    assert np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize("T,windowed", [(1, False), (3, False), (5, False), (3, True)])
def test_k7_matches_longterm_synth_tl(T, windowed):
    res, _, pitch, _, md, q15, prm = _long_rows(68 + T, T)
    perm = np.arange(B)
    kw = {}
    if windowed:
        lt_win, hi8s, order = _longterm_window_plan(pitch, T, B)
        assert lt_win > 0, "window plan did not engage"
        perm = perm if order is None else order
        kw = dict(hist_d=longterm_ring_depth(int(md.max())), lt_win=lt_win,
                  hi8s=jnp.asarray(hi8s))
    ref_sorted = np.asarray(
        longterm_synth_tl(jnp.asarray(res[perm].T), jnp.asarray(prm[perm].T), T,
                          interpret=True, **kw)
    ).T
    ref = np.empty_like(ref_sorted)
    ref[perm] = ref_sorted
    out = cuda_filters.longterm_synth(_t(res), md, q15)
    assert np.array_equal(out.numpy(), ref)
