"""The known-parameter encode path: the port's
`pipeline.encode_filters_fused` (K4; its plain version on the CPU) against
sla_tpu's `encode_filters_fused` and `encode_filters`, and the port's
`entry()` against `__graft_entry__.entry()`. Seeded unsorted pitches with
rows off (pitch 0), lags under 8 and the longest lag, T in {0, 1, 3, 5},
p in {0, 8, 16}, M in {0, 4, 8}, and row counts that are not a multiple of
128. Exact comparisons (integer codec, tolerance 0)."""

import numpy as np
import pytest

import jax.numpy as jnp

import sla_tpu  # noqa: F401  (x64 before any tracing)
from sla_tpu import pipeline as jax_pipeline

import __graft_entry__
from sla_tpu_torch import entry as torch_entry
from sla_tpu_torch import pipeline


def _inputs(seed, B, L, p, T):
    rng = np.random.default_rng(seed)
    data = rng.integers(-(1 << 20), 1 << 20, (B, L), dtype=np.int32)
    data[0, ::11] = -(2**31)
    coef = rng.integers(-25000, 25000, (B, p), dtype=np.int32)
    pitch = rng.integers(1, 257, B).astype(np.int32)
    pitch[::4] = 0
    pitch[1::5] = rng.integers(1, 8, len(pitch[1::5]))  # lags under 8
    pitch[2] = 256
    ltm = rng.integers(-32768, 32768, (B, T), dtype=np.int32) << 16
    return data, coef, pitch, ltm


@pytest.mark.parametrize("p,T,M", [
    (16, 1, 8), (8, 3, 4), (16, 5, 8), (0, 0, 0), (8, 0, 8), (0, 5, 4), (16, 3, 0), (8, 1, 4),
])
@pytest.mark.parametrize("B", [37, 130])
def test_encode_filters_fused_matches_sla_tpu(p, T, M, B):
    L = 600
    data, coef, pitch, ltm = _inputs(p * 100 + T * 10 + M + B, B, L, p, T)
    ref_fused = np.asarray(jax_pipeline.encode_filters_fused(
        jnp.asarray(data), jnp.asarray(coef), pitch, jnp.asarray(ltm), p, T, M))
    ref = np.asarray(jax_pipeline.encode_filters(
        jnp.asarray(data), jnp.asarray(coef), jnp.asarray(pitch), jnp.asarray(ltm), p, T, M))
    assert np.array_equal(ref_fused, ref)
    out = pipeline.encode_filters_fused(
        pipeline.to_rows(data, "cpu"), pipeline.to_rows(coef, "cpu"), pitch, ltm, p, T, M)
    assert np.array_equal(out.numpy(), ref)


def test_encode_filters_fused_equals_stages():
    """K4 equals stage 1 then stage 2, the encoder's two-kernel form."""
    p, T, M = 16, 3, 8
    data, coef, pitch, ltm = _inputs(11, 20, 500, p, T)
    x, c = pipeline.to_rows(data, "cpu"), pipeline.to_rows(coef, "cpu")
    staged = pipeline.encode_stage2(pipeline.encode_stage1(x, c, p), pitch, ltm, T, M)
    fused = pipeline.encode_filters_fused(x, c, pitch, ltm, p, T, M)
    assert np.array_equal(fused.numpy(), staged.numpy())


def test_entry_matches_graft_entry():
    forward, args = torch_entry.entry(device="cpu")
    jax_forward, jax_args = __graft_entry__.entry()
    for a, b in zip(args, jax_args):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    out = forward(*args)
    assert out.shape == (16, 4096)
    assert np.array_equal(out.numpy(), np.asarray(jax_forward(*jax_args)))
