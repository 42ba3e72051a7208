"""The port's debug and sanitizer variables against sla_tpu's:
SLA_TPU_DEBUG_ASSERTS (the checked plain filters, sla_tpu's checkify
asserts), SLA_TPU_NATIVE_DEBUG (the -DSLA_TPU_DEBUG native build) and
SLA_TPU_SANITIZE (the ASan + UBSan native build)."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import sla_tpu

import sla_tpu_torch as st
from sla_tpu_torch import debug, native, pipeline
from sla_tpu_torch.kernels import cuda_filters

from .test_encode_decode import gen_wave

REPO = pathlib.Path(__file__).resolve().parent.parent


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _ref_error(fn) -> str:
    with pytest.raises(Exception) as e:
        fn()
    return str(e.value)


def _lms_trap(mod_lms, to):
    """tests/test_cli.py's overflow: coefficients and history at 2^30,
    past the warm-up; `to` makes the package's arrays from numpy."""
    B, M = 1, 4
    big, zero = np.full((B, M), 2**30, np.int32), np.zeros((B, M), np.int32)
    st_ = mod_lms.LmsState(to(big), to(zero), to(big), to(zero),
                           to(np.full((B,), M, np.int32)))
    return st_, to(np.full((B, 4), 2**20, np.int32)), M


def test_assert_mode_traps_lms_overflow(monkeypatch):
    """tests/test_cli.py's seeded LMS tap overflow: the port's plain LMS
    raises sla_tpu's message."""
    import jax.numpy as jnp

    from sla_tpu import debug as ref_debug
    from sla_tpu.kernels import lms as ref_lms
    from sla_tpu_torch.kernels import lms

    monkeypatch.setenv("SLA_TPU_DEBUG_ASSERTS", "1")
    state, data, M = _lms_trap(ref_lms, jnp.asarray)
    ref = _ref_error(lambda: ref_debug.run_checked(
        ref_lms._lms_scan, data, state, num_coef=M, synthesize=False))
    state, data, M = _lms_trap(lms, torch.from_numpy)
    with pytest.raises(debug.DebugAssertError, match="LMS tap product overflows int32") as e:
        lms.lms_predict(data, state, M)
    assert str(e.value) in ref
    with pytest.raises(debug.DebugAssertError, match="LMS tap product overflows int32"):
        lms.lms_synthesize(data, state, M)
    monkeypatch.delenv("SLA_TPU_DEBUG_ASSERTS")
    lms.lms_predict(data, state, M)  # unchecked: wraps as the kernels do


@pytest.mark.parametrize("direction", ["predict", "synth"])
def test_assert_mode_traps_lattice_overflow(monkeypatch, direction):
    """The one Q15 corner that overflows: c = -2^15 against INT32_MIN."""
    import jax.numpy as jnp

    from sla_tpu import debug as ref_debug
    from sla_tpu.kernels import lattice as ref_lattice
    from sla_tpu_torch.kernels import lattice

    monkeypatch.setenv("SLA_TPU_DEBUG_ASSERTS", "1")
    B, p = 1, 4
    ref_fn = getattr(ref_lattice, "lattice_predict" if direction == "predict"
                     else "lattice_synthesize")
    fn = getattr(lattice, "lattice_predict" if direction == "predict"
                 else "lattice_synthesize")
    ref = _ref_error(lambda: ref_debug.run_checked(
        ref_fn, jnp.full((B, 4), 1, jnp.int32), jnp.full((B, p), -32768, jnp.int32),
        jnp.full((B, p + 1), -(2**31), jnp.int32)))
    with pytest.raises(debug.DebugAssertError,
                       match=f"lattice {direction} stage product overflows int32") as e:
        fn(torch.full((B, 4), 1, dtype=torch.int32),
           torch.full((B, p), -32768, dtype=torch.int32),
           torch.full((B, p + 1), -(2**31), dtype=torch.int32))
    assert str(e.value) in ref


def test_assert_mode_traps_longterm_overflow(monkeypatch):
    import jax.numpy as jnp

    from sla_tpu import debug as ref_debug
    from sla_tpu.kernels import longterm as ref_longterm
    from sla_tpu_torch.kernels import longterm

    monkeypatch.setenv("SLA_TPU_DEBUG_ASSERTS", "1")
    B = 1
    hist, _ = ref_longterm.longterm_init_state(B)
    ref = _ref_error(lambda: ref_debug.run_checked(
        lambda r, p, c, s: ref_longterm.longterm_synthesize(r, p, c, 1, s, chunk=1),
        jnp.zeros((B, 16), jnp.int32), jnp.full((B,), 8, jnp.int32),
        jnp.full((B, 1), -(2**31), jnp.int32),
        (jnp.full_like(hist, -(2**31)), jnp.full((B,), 1000, jnp.int32))))
    hist, _ = longterm.longterm_init_state(B)
    with pytest.raises(debug.DebugAssertError,
                       match="long-term prediction overflows int32") as e:
        longterm.longterm_synthesize(
            torch.zeros((B, 16), dtype=torch.int32), torch.full((B,), 8, dtype=torch.int32),
            torch.full((B, 1), -(2**31), dtype=torch.int32), 1,
            (torch.full_like(hist, -(2**31)), torch.full((B,), 1000, dtype=torch.int32)))
    assert str(e.value) in ref


def test_checks_raise_the_first_failure_in_order():
    checks = debug.Checks()
    checks.check(torch.tensor(True), "a")
    checks.check(torch.tensor(False), "b")
    checks.check(torch.tensor(False), "c")
    with pytest.raises(debug.DebugAssertError, match="^b$"):
        checks.raise_first()
    debug.Checks().raise_first()


def test_assert_mode_runs_the_plain_versions_not_the_kernels(monkeypatch):
    """With the variable set, the pipeline's stages take the checked plain
    versions (as sla_tpu takes its checkified scans): the kernel wrappers
    are never called, and the values are the kernels'."""
    rng = np.random.default_rng(2)
    x = _t(rng.integers(-(1 << 20), 1 << 20, (6, 300), dtype=np.int32))
    coef = _t(rng.integers(-3000, 3000, (6, 8), dtype=np.int32))
    pitch = np.array([0, 40, 41, 0, 90, 12], np.int32)
    ltm = (rng.integers(-2000, 2000, (6, 3), dtype=np.int32) << 16).astype(np.int32)
    want_res = pipeline.encode_filters_fused(x, coef, pitch, ltm, 8, 3, 8)
    want_pcm = pipeline.decode_stage(want_res, coef, pitch, ltm, 8, 3, 8)
    monkeypatch.setenv("SLA_TPU_DEBUG_ASSERTS", "1")

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper ran in assert mode")

    for name in ("lattice_predict", "stage2_predict", "synth_cascade", "fused_encode"):
        monkeypatch.setattr(cuda_filters, name, refuse)
    assert torch.equal(pipeline.encode_filters_fused(x, coef, pitch, ltm, 8, 3, 8), want_res)
    assert torch.equal(pipeline.encode_stage2(pipeline.encode_stage1(x, coef, 8),
                                              pitch, ltm, 3, 8), want_res)
    assert torch.equal(pipeline.decode_stage(want_res, coef, pitch, ltm, 8, 3, 8), want_pcm)
    assert torch.equal(want_pcm, x)


@pytest.mark.parametrize("preset", [1, 3])
def test_assert_mode_leaves_streams_unchanged(monkeypatch, preset):
    pcm = gen_wave("chirp", 9000, 2, 16, 0, seed=4)

    def encode():
        enc = st.Encoder(st.EncoderConfig(backend="device"), device="cpu")
        enc.set_wave_format(st.WaveFormat(2, 16, 44100))
        enc.set_encode_parameter(st.PRESETS[preset])
        return enc.encode_whole(pcm)

    plain = encode()
    monkeypatch.setenv("SLA_TPU_DEBUG_ASSERTS", "1")
    checked = encode()
    assert checked == plain
    dec = st.Decoder(st.DecoderConfig(backend="device"), device="cpu")
    assert np.array_equal(dec.decode_whole(checked)[1], pcm)
    ref = sla_tpu.Encoder(sla_tpu.EncoderConfig(backend="host"))
    ref.set_wave_format(sla_tpu.WaveFormat(2, 16, 44100))
    ref.set_encode_parameter(sla_tpu.PRESETS[preset])
    assert checked == ref.encode_whole(pcm)


def test_native_debug_build_roundtrip_and_trap():
    """The twin of tests/test_cli.py's native debug test on the port's
    library: SLA_TPU_NATIVE_DEBUG=1 builds the -DSLA_TPU_DEBUG variant, a
    round trip passes, and a seeded LMS overflow aborts the process."""
    env = {**os.environ, "SLA_TPU_NATIVE_DEBUG": "1"}
    ok_src = (
        "import numpy as np, sla_tpu_torch as st\n"
        "from sla_tpu_torch import native\n"
        "rng = np.random.default_rng(4)\n"
        "pcm = (rng.integers(-3000, 3000, (2, 9000)).astype(np.int32) << 16)\n"
        "enc = st.Encoder(device='cpu'); enc.set_wave_format(st.WaveFormat(2, 16, 44100))\n"
        "enc.set_encode_parameter(st.PRESETS[1])\n"
        "blob = enc.encode_whole(pcm)\n"
        "assert np.array_equal(st.Decoder(device='cpu').decode_whole(blob)[1], pcm)\n"
        "assert native.available() and 'sla_native_dbg' in native._lib._name\n"
        "print('debug-build round-trip ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", ok_src], capture_output=True,
                       text=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "round-trip ok" in r.stdout
    trap_src = (
        "import numpy as np\n"
        "from sla_tpu_torch import native\n"
        "res = np.full((16, 512), 2**30, np.int32)\n"
        "coef = np.zeros((16, 4), np.int32)\n"
        "pitch = np.zeros(16, np.int32)\n"
        "ltm = np.zeros((16, 1), np.int32)\n"
        "native.synth_rows(res, coef, pitch, ltm, 1, 8)\n"
        "print('should have aborted')\n"
    )
    r = subprocess.run([sys.executable, "-c", trap_src], capture_output=True,
                       text=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode != 0 and "should have aborted" not in r.stdout
    assert "SLA debug assert failed" in r.stderr, r.stderr[-2000:]


@pytest.mark.parametrize("env,name,extra", [
    ({}, "sla_native", []),
    ({"SLA_TPU_NATIVE_DEBUG": "1"}, "sla_native_dbg", ["-DSLA_TPU_DEBUG"]),
    ({"SLA_TPU_SANITIZE": "1"}, "sla_native_san",
     ["-fsanitize=address,undefined", "-fno-sanitize-recover=all",
      "-fno-omit-frame-pointer", "-g"]),
])
def test_native_build_variants_select_their_command(monkeypatch, env, name, extra):
    """Each variable selects its own build name (so its own key) and
    sla_tpu's flags; the command is checked, not run."""
    for k in ("SLA_TPU_NATIVE_DEBUG", "SLA_TPU_SANITIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got_name, cmd = native.build_command()
    assert got_name == name
    assert cmd == ["g++"] + native.GXX_FLAGS + extra


def test_failed_sanitized_build_raises(monkeypatch):
    """SLA_TPU_SANITIZE never goes on without the native code: a failed
    instrumented build raises instead of falling back (sla_tpu's rule)."""
    from sla_tpu_torch.kernels import build

    def fail(*a, **k):
        raise RuntimeError("g++: unrecognized -fsanitize")

    monkeypatch.setattr(build, "build_library", fail)
    monkeypatch.delenv("SLA_TPU_SANITIZE", raising=False)
    assert native._build() is None
    monkeypatch.setenv("SLA_TPU_SANITIZE", "1")
    with pytest.raises(RuntimeError, match="SLA_TPU_SANITIZE"):
        native._build()
