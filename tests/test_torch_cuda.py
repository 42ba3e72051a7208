"""The seven CUDA kernels on the card against their plain PyTorch versions
on the same card, the fused encode against the two-stage form, and the
encode/decode slice on the card against the host backend. Needs an NVIDIA GPU with nvcc (the kernels build at first use);
elsewhere every test skips. Run them on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Exact comparisons (integer codec, tolerance 0)."""

import numpy as np
import pytest
import torch

from sla_tpu_torch.kernels import cuda_filters

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, seed, B, L, p, T):
    rng = np.random.default_rng(seed)
    x = rng.integers(-(1 << 20), 1 << 20, (B, L), dtype=np.int32)
    x[0, ::7] = -(2**31)
    coef = rng.integers(-32768, 32768, (B, p), dtype=np.int32)
    pitch = rng.integers(3, 257, B)
    pitch[::4] = 0
    pitch[1::5] = rng.integers(1, 8, len(pitch[1::5]))
    md = np.where(pitch > 0, pitch + T // 2, 0).astype(np.int32) if T else np.zeros(B, np.int32)
    q15 = rng.integers(-32768, 32768, (B, T), dtype=np.int32)
    return (torch.from_numpy(a).to(dev) for a in (x, coef, md, q15))


ORDERS = [(16, 1, 8), (32, 3, 8), (8, 1, 4), (0, 0, 0), (5, 5, 13)]


@pytest.mark.parametrize("p,T,M", ORDERS)
def test_kernels_match_plain_on_card(dev, p, T, M):
    x, coef, md, q15 = _inputs(dev, p + T + M, 300, 1024, p, T)
    k1 = cuda_filters.lattice_predict(x, coef)
    torch.cuda.synchronize()
    assert torch.equal(k1, cuda_filters.lattice_predict_plain(x, coef))
    k2 = cuda_filters.stage2_predict(x, md, q15, M)
    torch.cuda.synchronize()
    assert torch.equal(k2, cuda_filters.stage2_predict_plain(x, md, q15, M))
    k3 = cuda_filters.synth_cascade(x, coef, md, q15, M)
    torch.cuda.synchronize()
    assert torch.equal(k3, cuda_filters.synth_cascade_plain(x, coef, md, q15, M))


@pytest.mark.parametrize("p,T,M", ORDERS)
def test_known_parameter_kernels_match_plain_on_card(dev, p, T, M):
    x, coef, md, q15 = _inputs(dev, p + T + M + 1, 300, 1024, p, T)
    pairs = [
        (lambda: cuda_filters.fused_encode(x, coef, md, q15, M),
         lambda: cuda_filters.fused_encode_plain(x, coef, md, q15, M)),
        (lambda: cuda_filters.lms_synth(x, M), lambda: cuda_filters.lms_synth_plain(x, M)),
        (lambda: cuda_filters.longterm_synth(x, md, q15),
         lambda: cuda_filters.longterm_synth_plain(x, md, q15)),
    ]
    for emphasis in (True, False):
        pairs += [
            (lambda e=emphasis: cuda_filters.lattice_synth(x, coef, e),
             lambda e=emphasis: cuda_filters.lattice_synth_plain(x, coef, e)),
            (lambda e=emphasis: cuda_filters.lattice_predict(x, coef, e),
             lambda e=emphasis: cuda_filters.lattice_predict_plain(x, coef, e)),
        ]
    for kernel, plain in pairs:
        out = kernel()
        torch.cuda.synchronize()
        assert torch.equal(out, plain())


def test_encode_filters_fused_on_card_matches_stages(dev):
    from sla_tpu_torch import pipeline

    rng = np.random.default_rng(9)
    B, L, p, T, M = 700, 4096, 16, 1, 8
    x = torch.from_numpy(rng.integers(-30000, 30000, (B, L), dtype=np.int32)).to(dev)
    coef = torch.from_numpy(rng.integers(-25000, 25000, (B, p), dtype=np.int32)).to(dev)
    pitch = rng.integers(0, 257, B).astype(np.int32)
    ltm = rng.integers(-32768, 32768, (B, T), dtype=np.int32) << 16
    fused = pipeline.encode_filters_fused(x, coef, pitch, ltm, p, T, M)
    staged = pipeline.encode_stage2(pipeline.encode_stage1(x, coef, p), pitch, ltm, T, M)
    torch.cuda.synchronize()
    assert torch.equal(fused, staged)


def test_slice_on_card_matches_host(dev):
    import sla_tpu_torch as st

    rng = np.random.default_rng(5)
    pcm = rng.integers(-8000, 8000, (2, 60000)).astype(np.int32) << 16
    blobs = []
    for backend, device in (("host", "cpu"), ("device", "cuda")):
        enc = st.Encoder(st.EncoderConfig(backend=backend), device=device)
        enc.set_wave_format(st.WaveFormat(2, 16, 44100))
        enc.set_encode_parameter(st.PRESETS[2])
        blobs.append(enc.encode_whole(pcm))
    assert blobs[0] == blobs[1]
    dec = st.Decoder(st.DecoderConfig(backend="device"), device="cuda")
    assert np.array_equal(dec.decode_whole(blobs[1])[1], pcm)
