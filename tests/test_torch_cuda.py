"""The nine CUDA kernels on the card against their plain PyTorch versions
on the same card (each also on ragged and misaligned rows), the fused
encode against the two-stage form, K5 against K1 (a round trip), the
entropy kernels K8 and K9 also against the g++ build of their bodies and
the host coder, and the encode/decode slice on the card
against the host backend. Needs an NVIDIA GPU with nvcc (the kernels build
at first use); elsewhere every test skips. Run them on a machine with a
card:

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


@pytest.mark.parametrize("B,L", [(1, 1), (33, 37), (70, 65), (40, 1300)])
@pytest.mark.parametrize("p,T,M", [(16, 1, 8), (5, 5, 40), (0, 0, 0)])
def test_pipelines_on_ragged_tiles_on_card(dev, B, L, p, T, M):
    """K2 and K3 (tile pipelines) where rows, tiles and the history ring
    do not divide evenly, with delays up to 258."""
    x, coef, md, q15 = _inputs(dev, B + L + p, B, L, p, T)
    if T:
        md[: min(B, 4)] = torch.tensor([1, 256, 257, 258], dtype=torch.int32, device=dev)[: min(B, 4)]
    k2 = cuda_filters.stage2_predict(x, md, q15, M)
    k3 = cuda_filters.synth_cascade(x, coef, md, q15, M)
    torch.cuda.synchronize()
    assert torch.equal(k2, cuda_filters.stage2_predict_plain(x, md, q15, M))
    assert torch.equal(k3, cuda_filters.synth_cascade_plain(x, coef, md, q15, M))


def _misaligned(t):
    """t's values in a tensor whose data starts 4 bytes past an aligned
    address, so no row is aligned for 16-byte loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("B,L", [(1, 1), (33, 37), (70, 65), (40, 1300), (3, 3001), (5, 2021)])
@pytest.mark.parametrize("p,T,M", [(16, 1, 8), (32, 3, 8), (8, 1, 4), (48, 5, 40), (0, 0, 0)])
def test_stencil_and_encode_pipeline_on_ragged_shapes_on_card(dev, B, L, p, T, M):
    """K1 (a warp per segment of 1,024 - p outputs, lanes over samples) and
    K4 (the encode pipeline) where rows, chunks, segments and tiles do not
    divide evenly (L 3,001 and 2,021 end in a ragged segment), with delays
    up to 258, on rows as allocated and rows misaligned for 16-byte loads;
    K1 also without pre-emphasis (p 0 and 48 take the run-time order)."""
    x, coef, md, q15 = _inputs(dev, B * 3 + L + p, B, L, p, T)
    if T:
        md[: min(B, 4)] = torch.tensor([1, 256, 257, 258], dtype=torch.int32, device=dev)[: min(B, 4)]
    for rows in (x, _misaligned(x)):
        k1 = cuda_filters.lattice_predict(rows, coef)
        k1_plain_rows = cuda_filters.lattice_predict(rows, coef, False)
        k4 = cuda_filters.fused_encode(rows, coef, md, q15, M)
        torch.cuda.synchronize()
        assert torch.equal(k1, cuda_filters.lattice_predict_plain(x, coef))
        assert torch.equal(k1_plain_rows, cuda_filters.lattice_predict_plain(x, coef, False))
        assert torch.equal(k4, cuda_filters.fused_encode_plain(x, coef, md, q15, M))


RAGGED_SHAPES = [(1, 1), (33, 37), (70, 65), (40, 1300), (3, 3001)]
LAGS = [1, 2, 31, 32, 33, 258]


@pytest.mark.parametrize("B,L", RAGGED_SHAPES)
@pytest.mark.parametrize("T", [1, 3, 5])
def test_longterm_synth_lag_steps_on_card(dev, B, L, T):
    """K7 (a warp per row, steps of the row's smallest live lag) with
    delays of 1, 2, 31, 32, 33 and 258 samples among random ones, on rows
    as allocated and misaligned."""
    x, _, md, q15 = _inputs(dev, B * 5 + L + T, B, L, 0, T)
    n = min(B, len(LAGS))
    lags = torch.tensor(LAGS, dtype=torch.int32, device=dev)
    md[:n] = lags[(L + torch.arange(n, device=dev)) % len(LAGS)]
    plain = cuda_filters.longterm_synth_plain(x, md, q15)
    for rows in (x, _misaligned(x)):
        out = cuda_filters.longterm_synth(rows, md, q15)
        torch.cuda.synchronize()
        assert torch.equal(out, plain)


@pytest.mark.parametrize("B,L", RAGGED_SHAPES)
@pytest.mark.parametrize("M", [8, 4, 40, 13, 0])
def test_lms_synth_pipeline_on_card(dev, B, L, M):
    """K6 (the tile pipeline; the slim chain at M 4 and 8, the Lms body at
    a run-time order, 40 the largest) where rows and tiles do not divide
    evenly, on rows as allocated and misaligned."""
    x, _, _, _ = _inputs(dev, B * 7 + L + M, B, L, 0, 0)
    plain = cuda_filters.lms_synth_plain(x, M)
    for rows in (x, _misaligned(x)):
        out = cuda_filters.lms_synth(rows, M)
        torch.cuda.synchronize()
        assert torch.equal(out, plain)


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


SYNTH_SHAPES = [(1, 1), (3, 2), (33, 63), (2049, 1), (1, 12289), (33, 12289)]


@pytest.mark.parametrize("B,L", SYNTH_SHAPES)
@pytest.mark.parametrize("p", [0, 1, 8, 16, 32, 48])
def test_lattice_synth_lanes_on_card(dev, B, L, p):
    """K5 (lanes over stages, 64 / G rows a warp) where rows do not fill a
    warp and chunks do not divide evenly, with and without de-emphasis, on
    rows as allocated and misaligned."""
    x, coef, _, _ = _inputs(dev, B * 17 + L + p, B, L, p, 0)
    for emphasis in (True, False):
        plain = cuda_filters.lattice_synth_plain(x, coef, emphasis)
        for rows in (x, _misaligned(x)):
            out = cuda_filters.lattice_synth(rows, coef, emphasis)
            torch.cuda.synchronize()
            assert torch.equal(out, plain)


@pytest.mark.parametrize("p", [16, 48])
def test_lattice_synth_full_shape_on_card(dev, p):
    """K5 at 2,049 x 12,289: one row past a whole number of warps, one
    sample past a whole number of chunks."""
    x, coef, _, _ = _inputs(dev, p + 5, 2049, 12289, p, 0)
    out = cuda_filters.lattice_synth(x, coef)
    torch.cuda.synchronize()
    assert torch.equal(out, cuda_filters.lattice_synth_plain(x, coef))


@pytest.mark.parametrize("p", [8, 16, 32, 48, 5])
def test_lattice_synth_inverts_predict_on_card(dev, p):
    """K5 inverts K1 on the card, with and without emphasis."""
    x, coef, _, _ = _inputs(dev, p + 11, 300, 1500, p, 0)
    for emphasis in (True, False):
        r = cuda_filters.lattice_predict(x, coef, emphasis)
        out = cuda_filters.lattice_synth(r, coef, emphasis)
        torch.cuda.synchronize()
        assert torch.equal(out, x)


# -- the entropy kernels: K8 (encode) and K9 (decode) --------------------------


@pytest.fixture
def host_lib(dev):
    from sla_tpu_torch.kernels import build

    return build.host_library()


# (blocks, channels, samples): one block, a few with a short last one, a
# decode group's 1,066 blocks, eight channels, mono; 31 and 33 blocks (a
# chain warp's 16 stereo blocks and 32 mono ones, and one more) and about
# 1,000, at one, two and eight channels
ENTROPY_SHAPES = [(1, 2, 700), (3, 2, 1500), (1066, 2, 300), (5, 8, 400), (4, 1, 2000),
                  (1, 1, 900), (1, 8, 300), (31, 1, 500), (31, 2, 400), (31, 8, 150),
                  (33, 1, 500), (33, 2, 400), (33, 8, 150), (1000, 1, 200), (1000, 8, 64)]


@pytest.mark.parametrize("B,C,L", ENTROPY_SHAPES)
def test_rice_encode_blocks_on_card(dev, host_lib, B, C, L):
    """K8's buffer equals its plain version's and the g++ build's byte for
    byte, and every block's payload is the host coder's."""
    from sla_tpu_torch import native
    from sla_tpu_torch.kernels import cuda_entropy
    from sla_tpu_torch.tools.verify_device import entropy_blocks

    from .test_torch_hostbuild import host_rice_encode

    rows, counts, inits = entropy_blocks(B * 7 + C + L, B, C, L, 3000.0)
    row0 = np.arange(0, B * C, C, dtype=np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (rows, row0, counts, inits.astype(np.int64))]
    got = cuda_entropy.rice_encode_blocks(*args, C)
    torch.cuda.synchronize()
    want = cuda_entropy.rice_encode_blocks_plain(*args, C)
    host = host_rice_encode(host_lib, rows, row0, counts, inits, C)
    for a, b, h in zip(got, want, host):
        assert torch.equal(a, b)
        assert np.array_equal(a.cpu().numpy(), h)
    payload, offsets, sizes = (t.cpu().numpy() for t in got)
    for b in range(min(B, 8)):
        block = rows[b * C : (b + 1) * C, : counts[b]]
        assert (payload[offsets[b] : offsets[b] + sizes[b]].tobytes()
                == native.put_data_array(block, list(inits[b])))


@pytest.mark.parametrize("B,C,L", ENTROPY_SHAPES)
def test_rice_decode_blocks_on_card(dev, host_lib, B, C, L):
    """K9 on payloads at every bit alignment gives the host coder's rows and
    no flag; with every flag condition planted (a long unary run, a long
    gamma code, a cursor past the window), the flags and the unflagged
    rows of its plain version and of the g++ build."""
    from sla_tpu_torch import rice_device
    from sla_tpu_torch.kernels import cuda_entropy
    from sla_tpu_torch.tools import verify_device as vd

    from .test_torch_hostbuild import host_rice_decode

    rows, counts, inits = vd.entropy_blocks(B * 11 + C + L, B, C, L, 3000.0)
    stream, offs, bits = vd.entropy_stream(B + C + 1, rows, counts, inits, C)
    cases = [(stream, bits), (stream, np.full_like(bits, 64))]
    if B >= 2:
        cases.append((vd.corrupt_entropy_stream(stream, offs), bits))
    for data, region in cases:
        (k_rows, k_bad), (p_rows, p_bad) = vd.decode_entropy_stream(
            dev, data, offs, region, counts, inits, C, L)
        torch.cuda.synchronize()
        assert cuda_entropy.decode_agrees(k_rows, k_bad, p_rows, p_bad, C)[0]
        words = rice_device.upload_stream(data, "cpu").numpy()
        h_rows, h_bad = host_rice_decode(host_lib, words, offs,
                                         rice_device.window_width(offs, region), counts,
                                         inits.astype(np.int64), C, L)
        assert cuda_entropy.decode_agrees(k_rows.cpu(), k_bad.cpu(), torch.from_numpy(h_rows),
                                          torch.from_numpy(h_bad), C)[0]
        if data is stream and region is bits:
            assert not bool(k_bad.any())
            assert np.array_equal(k_rows.cpu().numpy(), rows)
        elif data is not stream:
            assert bool(k_bad[:2].all())
    # rows longer than every count: zeros past them, as the plain version
    (k_rows, k_bad), (p_rows, p_bad) = vd.decode_entropy_stream(
        dev, stream, offs, bits, counts, inits, C, L + 45)
    torch.cuda.synchronize()
    assert torch.equal(k_rows, p_rows) and torch.equal(k_bad, p_bad) and not bool(k_bad.any())
    assert np.array_equal(k_rows[:, :L].cpu().numpy(), rows) and not bool(k_rows[:, L:].any())


@pytest.mark.parametrize("B,C,L", [(1, 2, 700), (3, 2, 1500), (33, 2, 400), (31, 8, 150),
                                   (5, 1, 900), (3, 2, 97)])
def test_rice_decode_flags_at_ring_boundaries_on_card(dev, host_lib, B, C, L):
    """K9 with a flag planted at the first symbol of a ring refill and at the
    last one before it, and with a symbol ending exactly at the cursor limit
    and one bit past it: the planted flags, the rows stopped at the same
    symbol with zeros after it, equal to the g++ build's and the plain
    version's rows."""
    from sla_tpu_torch import rice_device
    from sla_tpu_torch.kernels import cuda_entropy
    from sla_tpu_torch.tools import verify_device as vd

    from .test_torch_hostbuild import host_rice_decode, limit_flag_cases, ring_flag_cases

    rows, counts, inits = vd.entropy_blocks(B * 13 + C + L, B, C, L, 3000.0)
    stream, offs, bits = vd.entropy_stream(B + C + 2, rows, counts, inits, C)
    ini = inits.astype(np.int64)
    W = rice_device.window_width(offs, bits)
    cases = [(name, data, offs, W, counts, flags, want)
             for name, data, flags, want in ring_flag_cases(stream, offs, rows, counts, inits, C)]
    cases += [(name, data, o, Wl, counts[:1], flags, want)
              for name, data, o, Wl, flags, want in limit_flag_cases(rows, counts, inits, C)]
    for name, data, o, Wc, cnt, flags, want in cases:
        words = rice_device.upload_stream(data, dev)
        args = (torch.from_numpy(o).to(dev), Wc, torch.from_numpy(cnt).to(dev),
                torch.from_numpy(ini[: len(cnt)]).to(dev), C, L)
        k_rows, k_bad = cuda_entropy.rice_decode_blocks(words, *args)
        torch.cuda.synchronize()
        p_rows, p_bad = cuda_entropy.rice_decode_blocks_plain(words, *args)
        h_rows, h_bad = host_rice_decode(host_lib, words.cpu().numpy(), o, Wc, cnt,
                                         ini[: len(cnt)], C, L)
        assert np.array_equal(k_bad.cpu().numpy(), flags), name
        assert torch.equal(k_rows, p_rows) and torch.equal(k_bad, p_bad), name
        assert np.array_equal(k_rows.cpu().numpy(), want) and np.array_equal(h_rows, want), name


@pytest.mark.parametrize("C", [1, 2, 8])
def test_rice_longest_symbols_on_card(dev, host_lib, C):
    """A block of the code's longest symbols (80-bit escapes): K8's payload
    is the host coder's, and K9 decodes it at every bit alignment to the
    residuals, unflagged, as the g++ build does."""
    from sla_tpu_torch import rice_device
    from sla_tpu_torch.kernels import cuda_entropy

    from .test_torch_hostbuild import at_alignment, host_rice_decode, longest_block

    n = 300
    rows, inits, payload = longest_block(C, n)
    args = [torch.from_numpy(a).to(dev) for a in (rows, np.zeros(1, np.int32),
                                                   np.array([n], np.int32), inits)]
    got, _, sizes = cuda_entropy.rice_encode_blocks(*args, C)
    torch.cuda.synchronize()
    assert got.cpu().numpy()[: int(sizes[0])].tobytes() == payload
    cnt = np.array([n], dtype=np.int32)
    for at in range(32):
        o = np.array([at], dtype=np.int64)
        W = rice_device.window_width(o, np.array([8 * len(payload)]))
        words = rice_device.upload_stream(at_alignment(payload, at), dev)
        k_rows, k_bad = cuda_entropy.rice_decode_blocks(words, torch.from_numpy(o).to(dev), W,
                                                        args[2], args[3], C, n)
        torch.cuda.synchronize()
        h_rows, h_bad = host_rice_decode(host_lib, words.cpu().numpy(), o, W, cnt, inits, C, n)
        assert not bool(k_bad.any()) and not h_bad.any(), at
        assert np.array_equal(k_rows.cpu().numpy(), rows) and np.array_equal(h_rows, rows), at


def test_entropy_kernels_count_their_launches(dev):
    """Each wrapper adds one to its own count per kernel run (K8's count and
    emit launches are one run), apart from the filter kernels' counts."""
    from sla_tpu_torch.kernels import cuda_entropy
    from sla_tpu_torch.tools import verify_device as vd

    before_filters = dict(cuda_filters.launches)
    cuda_entropy.reset_launch_counts()
    rows, counts, inits = vd.entropy_blocks(1, 3, 2, 500, 3000.0)
    args = [torch.from_numpy(a).to(dev) for a in (rows, np.arange(0, 6, 2, dtype=np.int32),
                                                   counts, inits.astype(np.int64))]
    cuda_entropy.rice_encode_blocks(*args, 2)
    stream, offs, bits = vd.entropy_stream(2, rows, counts, inits, 2)
    vd.decode_entropy_stream(dev, stream, offs, bits, counts, inits, 2, 500)
    torch.cuda.synchronize()
    assert cuda_entropy.launches == {"rice_encode_blocks": 1, "rice_decode_blocks": 1}
    assert cuda_filters.launches == before_filters


def test_codec_on_card_entropy_on_and_off(dev):
    """The device backend codes entropy on the card by default (K8, K9) and
    writes the host backend's stream; with device_entropy='off' too."""
    import sla_tpu_torch as st
    from sla_tpu_torch.kernels import cuda_entropy

    rng = np.random.default_rng(6)
    pcm = rng.integers(-8000, 8000, (2, 60000)).astype(np.int32) << 16

    def encode(backend, device, **kw):
        enc = st.Encoder(st.EncoderConfig(backend=backend, **kw), device=device)
        enc.set_wave_format(st.WaveFormat(2, 16, 44100))
        enc.set_encode_parameter(st.PRESETS[2])
        return enc, enc.encode_whole(pcm)

    cuda_entropy.reset_launch_counts()
    _, host_blob = encode("host", "cpu")
    enc, blob = encode("device", "cuda")
    assert enc._device_entropy_active and blob == host_blob
    enc_off, blob_off = encode("device", "cuda", device_entropy="off")
    assert not enc_off._device_entropy_active and blob_off == host_blob
    for kw in ({}, {"device_entropy": "off"}):
        dec = st.Decoder(st.DecoderConfig(backend="device", **kw), device="cuda")
        assert np.array_equal(dec.decode_whole(blob)[1], pcm)
    assert cuda_entropy.launches["rice_encode_blocks"] > 0
    assert cuda_entropy.launches["rice_decode_blocks"] > 0


def test_codec_on_card_host_stragglers(dev, monkeypatch):
    """The decode's host stragglers on the card: a static-Golomb block in a
    loud stream, then a payload that K9 flags (64 zeroed bytes, CRC off),
    are decoded by the host coder and scattered into the card's residual
    batch; the results equal the host backend's."""
    import dataclasses

    import sla_tpu_torch as st
    from sla_tpu_torch import rice_device
    from sla_tpu_torch.constants import BlockDataType

    param = dataclasses.replace(st.PRESETS[2], max_num_block_samples=4096)
    rng = np.random.default_rng(6)
    loud = rng.integers(-8000, 8000, (2, 12288)).astype(np.int32) << 16
    quiet = rng.integers(-2, 3, (2, 4096)).astype(np.int32) << 16
    pcm = np.concatenate([loud[:, :8192], quiet, loud[:, 8192:]], axis=1)
    enc = st.Encoder(st.EncoderConfig(backend="host"), device="cpu")
    enc.set_wave_format(st.WaveFormat(2, 16, 44100))
    enc.set_encode_parameter(param)
    blob = enc.encode_whole(pcm)

    flagged = []
    decode_payloads = rice_device.decode_blocks_payload_device

    def spy(*args, **kwargs):
        res, bad = decode_payloads(*args, **kwargs)
        assert res.is_cuda
        flagged.append(np.flatnonzero(bad).tolist())
        return res, bad

    monkeypatch.setattr(rice_device, "decode_blocks_payload_device", spy)

    def decode(backend, device, data):
        cfg = st.DecoderConfig(enable_crc_check=False, backend=backend)
        return st.Decoder(cfg, device=device).decode_whole(data)[1]

    dec = st.Decoder(st.DecoderConfig(backend="device"), device="cuda")
    header = dec._open_stream(blob)
    blocks = dec.scan_blocks(blob, header.num_samples)
    comp = [i for i, b in enumerate(blocks) if b.block_type == BlockDataType.COMPRESSDATA]
    golomb = [rice_device.is_golomb_block(blocks[i].init_rice) for i in comp]
    assert any(golomb) and not all(golomb)
    assert np.array_equal(decode("device", "cuda", blob), pcm)
    assert flagged == [[]]

    start = blocks[comp[0]].payload_bit_offset // 8 + 200
    corrupt = blob[:start] + bytes(64) + blob[start + 64:]
    flagged.clear()
    got = decode("device", "cuda", corrupt)
    assert flagged == [[0]]
    assert np.array_equal(got, decode("host", "cpu", corrupt))
