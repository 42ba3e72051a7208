"""The port's streaming decoder (sla_tpu_torch/streaming.py, hostref.py)
against sla_tpu's: the same fragments in give the same PCM out of every
decode() tick, the same packet-queue behaviour and the same SLAError codes
on damaged streams, on the native route and on the pure-Python one."""

import numpy as np
import pytest

import sla_tpu
from sla_tpu import wavio

import sla_tpu_torch as st

from .test_encode_decode import gen_wave


def _encode(pcm, width, preset, rate=44100):
    enc = sla_tpu.Encoder(sla_tpu.EncoderConfig(backend="host"))
    enc.set_wave_format(sla_tpu.WaveFormat(pcm.shape[0], width, rate))
    enc.set_encode_parameter(sla_tpu.preset_parameter(preset, pcm.shape[0]))
    return enc.encode_whole(pcm)


def _ticks(mod, blob, seed, tick_hz=120.0):
    """Feed `blob` to mod's StreamingDecoder in fragments of seeded random
    sizes; returns (per-tick PCM list, SLAError code or None)."""
    rng = np.random.default_rng(seed)
    header, _ = mod.decode_header(blob)
    wf = header.wave_format
    sd = mod.StreamingDecoder(mod.StreamingDecoderConfig(
        core=mod.DecoderConfig(), decode_interval_hz=tick_hz,
        max_bit_per_sample=max(8, wf.bit_per_sample)))
    ticks = []
    try:
        sd.set_wave_format(wf)
        sd.set_encode_parameter(header.encode_param)
        pos, done = 43, 0
        while done < header.num_samples:
            need = sd.estimate_minimum_necessary_data_size()
            if pos < len(blob) and sd.remaining_data_size() < need:
                take = min(need + int(rng.integers(0, 2000)), len(blob) - pos)
                sd.append_data_fragment(blob[pos : pos + take])
                pos += take
            chunk = sd.decode()
            ticks.append(chunk.copy())
            if chunk.shape[1] == 0:
                if pos >= len(blob):
                    break
                take = min(need, len(blob) - pos)
                sd.append_data_fragment(blob[pos : pos + take])
                pos += take
            done += chunk.shape[1]
            sd.collect_data_fragments()
    except (sla_tpu.SLAError, st.SLAError) as e:
        return ticks, int(e.result)
    return ticks, None


def _same_ticks(blob, seed=0):
    ref, ref_err = _ticks(sla_tpu, blob, seed)
    port, port_err = _ticks(st, blob, seed)
    assert port_err == ref_err
    assert len(port) == len(ref)
    for a, b in zip(ref, port):
        assert np.array_equal(a, b)
    return port, port_err


@pytest.mark.parametrize("width", [8, 16, 24])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("preset", [0, 1, 2, 3, 4])
def test_streaming_ticks_match_sla_tpu(preset, channels, width):
    pcm = gen_wave("chirp" if channels == 2 else "gauss", 9000, channels, width, 0,
                   seed=preset * 7 + width)
    ticks, err = _same_ticks(_encode(pcm, width, preset), seed=preset)
    assert err is None
    assert np.array_equal(np.concatenate(ticks, axis=1), pcm)


def test_streaming_fixture_matches_sla_tpu(a_wav):
    w = wavio.read_wav(str(a_wav))
    ticks, err = _same_ticks(_encode(w.data, w.bits_per_sample, 2, w.sampling_rate))
    assert err is None
    assert np.array_equal(np.concatenate(ticks, axis=1), w.data)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_packet_queue_random_fragments(seed):
    """Both queues, driven by the same seeded random enqueue / get /
    dequeue schedule, return the same bytes and sizes at every step."""
    rng = np.random.default_rng(seed)
    ref, port = sla_tpu.DataPacketQueue(capacity=8), st.DataPacketQueue(capacity=8)
    for _ in range(400):
        op = int(rng.integers(0, 3))
        if op == 0:
            data = rng.integers(0, 256, int(rng.integers(1, 64)), dtype=np.uint8).tobytes()
            outcome = []
            for q in (ref, port):
                try:
                    q.enqueue(data)
                    outcome.append(None)
                except (sla_tpu.SLAError, st.SLAError) as e:
                    outcome.append(int(e.result))
            assert outcome[0] == outcome[1]
        elif op == 1:
            n = int(rng.integers(0, 40))
            assert ref.get_fragment(n) == port.get_fragment(n)
        else:
            assert ref.dequeue() == port.dequeue()
        assert ref.remaining_size() == port.remaining_size()


def _damaged(kind):
    pcm = gen_wave("chirp", 20000, 2, 16, 0, seed=5)
    blob = bytearray(_encode(pcm, 16, 1))
    if kind == "payload-flip":
        blob[len(blob) // 2] ^= 0x5A
    elif kind == "sync-flip":
        blob[43] ^= 0xFF
    elif kind == "header-flip":  # the first block's sample count
        blob[51] ^= 0xFF
    elif kind == "truncated":
        blob = blob[: len(blob) * 2 // 3]
    return bytes(blob)


@pytest.mark.parametrize("kind", ["payload-flip", "sync-flip", "header-flip", "truncated"])
def test_damaged_streams_give_the_same_error(kind):
    _, err = _same_ticks(_damaged(kind), seed=4)
    if kind in ("sync-flip", "header-flip"):
        assert err is not None


@pytest.mark.parametrize("preset,width", [(0, 8), (1, 16), (3, 24)])
def test_hostref_route_matches_sla_tpu(monkeypatch, preset, width):
    """With the native library reported unavailable in both packages, the
    pure-Python twins (hostref.py) decode the same ticks."""
    pcm = gen_wave("chirp", 5000, 2, width, 0, seed=width)
    blob = _encode(pcm, width, preset)
    monkeypatch.setattr("sla_tpu.streaming.native.available", lambda: False)
    monkeypatch.setattr("sla_tpu_torch.streaming.native.available", lambda: False)
    ticks, err = _same_ticks(blob, seed=preset)
    assert err is None
    assert np.array_equal(np.concatenate(ticks, axis=1), pcm)
