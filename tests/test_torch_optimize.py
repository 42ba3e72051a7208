"""The port's parameter search (sla_tpu_torch.optimize_encode, device="cpu")
against sla_tpu.optimize_encode: the same knob search, sampled slice and
trial order give the same stream and the same EncodeParameter."""

import numpy as np
import pytest

import sla_tpu

import sla_tpu_torch as st

from .test_encode_decode import gen_wave


def _same(pcm, width, **kw):
    ch = pcm.shape[0]
    ref_kw = {k: (sla_tpu.EncoderConfig(**v) if k == "encoder_config" else v)
              for k, v in kw.items()}
    port_kw = {k: (st.EncoderConfig(**v) if k == "encoder_config" else v)
               for k, v in kw.items()}
    ref_blob, ref_param = sla_tpu.optimize_encode(
        pcm, sla_tpu.WaveFormat(ch, width, 44100), **ref_kw)
    blob, param = st.optimize_encode(pcm, st.WaveFormat(ch, width, 44100),
                                     device="cpu", **port_kw)
    assert blob == ref_blob
    assert str(param) == str(ref_param)
    assert np.array_equal(st.Decoder(device="cpu").decode_whole(blob)[1], pcm)
    return param


@pytest.mark.parametrize("effort", [1, 2])
@pytest.mark.parametrize("kind,ch,width", [("chirp", 2, 16), ("sine", 1, 24)])
def test_optimize_matches_sla_tpu(effort, kind, ch, width):
    _same(gen_wave(kind, 12000, ch, width, 0, seed=11), width, effort=effort)


def test_optimize_seed_and_verify_match_sla_tpu():
    pcm = gen_wave("gauss", 9000, 2, 16, 0, seed=3)
    start = st.EncodeParameter(4, 1, 4, st.ChannelProcessMethod.NONE,
                               st.WindowFunctionType.RECTANGULAR, 4096)
    ref_start = sla_tpu.EncodeParameter(4, 1, 4, sla_tpu.ChannelProcessMethod.NONE,
                                         sla_tpu.WindowFunctionType.RECTANGULAR, 4096)
    ref_blob, ref_param = sla_tpu.optimize_encode(
        pcm, sla_tpu.WaveFormat(2, 16, 44100), start=ref_start, effort=1,
        encoder_config=sla_tpu.EncoderConfig(verify=True))
    blob, param = st.optimize_encode(
        pcm, st.WaveFormat(2, 16, 44100), start=start, effort=1,
        encoder_config=st.EncoderConfig(verify=True), device="cpu")
    assert blob == ref_blob and str(param) == str(ref_param)


def test_optimize_rejects_bad_effort_like_sla_tpu():
    pcm = gen_wave("sine", 3000, 1, 16, 0, seed=1)
    with pytest.raises(sla_tpu.SLAError) as ref:
        sla_tpu.optimize_encode(pcm, sla_tpu.WaveFormat(1, 16, 44100), effort=3)
    with pytest.raises(st.SLAError) as port:
        st.optimize_encode(pcm, st.WaveFormat(1, 16, 44100), effort=3, device="cpu")
    assert str(port.value) == str(ref.value)


def test_optimize_sampled_slice_matches_sla_tpu():
    """A file longer than the effort-1 trial budget: the search runs on the
    sampled slice and the finalists on the whole file, in both packages."""
    from sla_tpu_torch.optimize import _SAMPLE_CHUNK_LEN, _SAMPLE_CHUNKS

    pcm = gen_wave("chirp", _SAMPLE_CHUNKS * _SAMPLE_CHUNK_LEN + 5000, 1, 16, 0, seed=7)
    _same(pcm, 16, effort=1)
