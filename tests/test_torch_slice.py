"""The port's encode/decode slice end to end on the CPU: sla_tpu_torch's
Encoder/Decoder on backend='device', device='cpu' (the plain PyTorch
stages) against sla_tpu's host and device backends, byte for byte, and
exact PCM back."""

import os

import numpy as np
import pytest

import sla_tpu
from sla_tpu import wavio

import sla_tpu_torch as st
from sla_tpu_torch.kernels import cuda_filters


def _stereo_second(seed=11, n=44100):
    """About 1 s of seeded CD stereo: two tones with noise, 16 bit."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = np.stack([
        9000 * np.sin(2 * np.pi * t / 97.0) + rng.normal(0, 400, n),
        7000 * np.sin(2 * np.pi * t / 131.0) + 3000 * np.sin(2 * np.pi * t / 41.0)
        + rng.normal(0, 400, n),
    ])
    return np.clip(x, -32768, 32767).astype(np.int32) << 16, 16, 44100


def _a_wav(path):
    w = wavio.read_wav(str(path))
    return w.data, w.bits_per_sample, w.sampling_rate


def _encode(mod, pcm, bits, rate, preset, backend, **kw):
    enc = mod.Encoder(mod.EncoderConfig(backend=backend), **kw)
    enc.set_wave_format(mod.WaveFormat(pcm.shape[0], bits, rate))
    enc.set_encode_parameter(mod.preset_parameter(preset, pcm.shape[0]))
    return enc.encode_whole(pcm)


@pytest.mark.parametrize("source", ["stereo", "a_wav"])
@pytest.mark.parametrize("preset", [0, 1, 2, 3, 4])
def test_slice_matches_sla_tpu(preset, source, request):
    pcm, bits, rate = (
        _stereo_second() if source == "stereo" else _a_wav(request.getfixturevalue("a_wav"))
    )
    ref_host = _encode(sla_tpu, pcm, bits, rate, preset, "host")
    ref_dev = _encode(sla_tpu, pcm, bits, rate, preset, "device")
    assert ref_host == ref_dev
    port = _encode(st, pcm, bits, rate, preset, "device", device="cpu")
    assert port == ref_host
    # the port's decoder returns the exact PCM, from its own stream and from
    # one sla_tpu wrote on the host
    dec = st.Decoder(st.DecoderConfig(backend="device"), device="cpu")
    _, out = dec.decode_whole(port)
    assert np.array_equal(out, pcm)


def test_decode_entry_points_reach_the_port():
    """decode_block, decode_range and decode_salvage all synthesize through
    the port's stage; the host backend gives the same PCM."""
    pcm, bits, rate = _stereo_second(seed=12, n=30000)
    blob = _encode(sla_tpu, pcm, bits, rate, 1, "host")
    dec = st.Decoder(st.DecoderConfig(backend="device"), device="cpu")
    _, out = dec.decode_whole(blob)
    assert np.array_equal(out, pcm)
    _, win = dec.decode_range(blob, 5000, 7000)
    assert np.array_equal(win, pcm[:, 5000:12000])
    _, segs = dec.decode_salvage(blob)
    assert np.array_equal(np.concatenate([s.pcm for s in segs], axis=1), pcm)
    host = st.Decoder(st.DecoderConfig(backend="host"), device="cpu")
    assert np.array_equal(host.decode_whole(blob)[1], pcm)


def test_verify_uses_the_port_decoder():
    pcm, bits, rate = _stereo_second(seed=13, n=20000)
    enc = st.Encoder(st.EncoderConfig(backend="device", verify=True), device="cpu")
    enc.set_wave_format(st.WaveFormat(2, bits, rate))
    enc.set_encode_parameter(st.PRESETS[1])
    assert enc.encode_whole(pcm) == _encode(sla_tpu, pcm, bits, rate, 1, "host")


def test_auto_backend_stays_on_host_below_threshold():
    pcm, bits, rate = _stereo_second(seed=14, n=20000)
    before = dict(cuda_filters.launches)
    blob = _encode(st, pcm, bits, rate, 2, "auto", device="cpu")
    assert blob == _encode(sla_tpu, pcm, bits, rate, 2, "host")
    assert cuda_filters.launches == before


def test_cuda_device_without_gpu_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        st.Encoder(st.EncoderConfig(backend="device"), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        st.Decoder(st.DecoderConfig(backend="device"), device="cuda")


def test_mesh_backend_raises():
    pcm, bits, rate = _stereo_second(seed=15, n=20000)
    with pytest.raises(NotImplementedError, match="mesh"):
        _encode(st, pcm, bits, rate, 1, "mesh", device="cpu")
    blob = _encode(sla_tpu, pcm, bits, rate, 1, "host")
    with pytest.raises(NotImplementedError, match="mesh"):
        st.Decoder(st.DecoderConfig(backend="mesh"), device="cpu").decode_whole(blob)


@pytest.mark.parametrize("value", ["1", "0"])
def test_device_entropy_knob_raises(monkeypatch, value):
    pcm, bits, rate = _stereo_second(seed=16, n=20000)
    blob = _encode(sla_tpu, pcm, bits, rate, 1, "host")
    monkeypatch.setitem(os.environ, "SLA_TPU_DEVICE_ENTROPY", value)
    with pytest.raises(NotImplementedError, match="SLA_TPU_DEVICE_ENTROPY"):
        _encode(st, pcm, bits, rate, 1, "device", device="cpu")
    with pytest.raises(NotImplementedError, match="SLA_TPU_DEVICE_ENTROPY"):
        st.Decoder(st.DecoderConfig(backend="device"), device="cpu").decode_whole(blob)
