"""sla_tpu_torch's on-card entropy coding (rice_device.py, the wrappers of K8
and K9) on the CPU, where the wrappers run their plain versions: the twin of
tests/test_rice_device.py. The same seeded inputs go through
sla_tpu.rice_device (XLA on the CPU), the port and the host coder. Exact
comparisons (integer codec, tolerance 0)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sla_tpu
from sla_tpu import rice_device as ref

import sla_tpu_torch as st
from sla_tpu_torch import native, pipeline, rice, rice_device
from sla_tpu_torch.constants import BlockDataType
from sla_tpu_torch.kernels import cuda_entropy, cuda_filters
from sla_tpu_torch.parallel import sharding
from sla_tpu_torch.tools import verify_device as vd

from .test_encode_decode import gen_wave
from .test_rice_device import _host_payload_stream

pytestmark = pytest.mark.skipif(not native.available(), reason="native build unavailable")

# preset 2 with 4,096-sample blocks: the plain scans loop over a block's
# samples, so shorter blocks keep the whole-codec cases quick
PARAM = dataclasses.replace(st.PRESETS[2], max_num_block_samples=4096)
REF_PARAM = dataclasses.replace(sla_tpu.PRESETS[2], max_num_block_samples=4096)


# -- the encode scan and payloads ------------------------------------------------


@pytest.mark.parametrize("scale", [1, 60, 4000, 200000, 1 << 27])
@pytest.mark.parametrize("channels", [1, 2, 6, 8])
def test_encode_parts_match_sla_tpu(scale, channels):
    """rice_encode_parts' values and lengths equal sla_tpu's, from the
    static-Golomb scale to gamma escapes."""
    rng = np.random.default_rng(scale % 1009 + channels)
    data = rng.normal(0, scale, (channels, 400)).clip(-(2**31), 2**31 - 1).astype(np.int32)
    init = np.asarray(rice.calculate_initial_params(list(data)), dtype=np.uint32)
    values, lengths = rice_device.rice_encode_parts(torch.from_numpy(data),
                                                    torch.from_numpy(init.astype(np.int64)))
    want_v, want_l = ref.rice_encode_parts(jnp.asarray(data), jnp.asarray(init))
    assert values.dtype == torch.uint32 and lengths.dtype == torch.int32
    assert np.array_equal(values.numpy(), np.asarray(want_v))
    assert np.array_equal(lengths.numpy(), np.asarray(want_l))


@pytest.mark.parametrize("scale", [20, 5000, 1 << 20, 1 << 30])
@pytest.mark.parametrize("channels", [1, 2, 8])
def test_payload_matches_host_and_sla_tpu(scale, channels):
    rng = np.random.default_rng(scale % 97 + channels)
    N = int(rng.integers(500, 2500))
    data = rng.integers(-scale, scale, (channels, N)).astype(np.int32)
    init = rice.calculate_initial_params(list(data))
    got = rice_device.encode_block_payload_device(data, init, device="cpu")
    assert got == native.put_data_array(data, init)
    assert got == ref.encode_block_payload_device(data, init)


def test_payload_golomb_branch_takes_the_host_coder():
    rng = np.random.default_rng(0)
    data = rng.integers(-2, 3, (2, 1200)).astype(np.int32)
    init = rice.calculate_initial_params(list(data))
    assert rice_device.is_golomb_block(init)
    assert (rice_device.encode_block_payload_device(data, init, device="cpu")
            == native.put_data_array(data, init))


def test_payload_extreme_values():
    data = np.array([[2**31 - 1, -(2**31), 0, 1, -1] * 300], dtype=np.int32)
    init = rice.calculate_initial_params(list(data))
    got = rice_device.encode_block_payload_device(data, init, device="cpu")
    assert got == native.put_data_array(data, init)
    assert got == ref.encode_block_payload_device(data, init)


def test_encode_blocks_lays_payloads_out_word_aligned():
    """K8's wrapper on the CPU: every block's payload is the host coder's,
    at a 4-byte aligned offset, zero-padded to the next word; the parts
    come back only as bytes."""
    rows, counts, inits = vd.entropy_blocks(7, 5, 2, 900, 3000.0, spread=4.0)
    payload, offsets, sizes = rice_device.encode_blocks_device(
        torch.from_numpy(rows), np.arange(0, 10, 2), counts, inits, 2)
    assert payload.dtype == np.uint8 and (offsets % 4 == 0).all()
    ends = offsets + sizes
    for b in range(5):
        block = rows[2 * b : 2 * b + 2, : counts[b]]
        assert payload[offsets[b] : ends[b]].tobytes() == native.put_data_array(block, list(inits[b]))
        assert not payload[ends[b] : -(-ends[b] // 4) * 4].any()
    assert payload.size == -(-ends[-1] // 4) * 4


# -- the decode scan ---------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 5, 8])
def test_stream_words_match_sla_tpu(n):
    data = bytes(range(200, 200 + n))
    assert np.array_equal(rice_device.stream_words(data), ref.stream_words(data))


@pytest.mark.parametrize("channels,scale", [(1, 60), (2, 4000), (6, 200000), (8, 1 << 27)])
def test_decode_matches_sla_tpu_and_host(channels, scale):
    """decode_blocks_payload_device equals sla_tpu's, residual and flags, on
    the reference's ragged, misaligned streams, and the host coder's
    input."""
    rng = np.random.default_rng(channels * 1000 + 17)
    n_max = 257
    data, offs, bits, counts, inits, expected = _host_payload_stream(rng, 7, channels, n_max,
                                                                     scale)
    res, bad = rice_device.decode_blocks_payload_device(
        data, offs, bits, counts, inits, channels, n_max, device="cpu")
    want, want_bad = ref.decode_blocks_payload_device(data, offs, bits, counts, inits,
                                                      channels, n_max)
    assert not bad.any() and np.array_equal(bad, np.asarray(want_bad))
    assert np.array_equal(res.numpy(), np.asarray(want))
    for b in range(7):
        assert np.array_equal(res.numpy()[b, :, : counts[b]], expected[b])


def _agree_with_sla_tpu(data, offs, bits, counts, inits, C, n_max):
    """(port flags, sla_tpu flags, whether the unflagged rows agree)."""
    res, bad = rice_device.decode_blocks_payload_device(data, offs, bits, counts, inits, C,
                                                        n_max, device="cpu")
    want, want_bad = ref.decode_blocks_payload_device(data, offs, bits, counts, inits, C, n_max)
    ok, _ = cuda_entropy.decode_agrees(res.view(-1, n_max), torch.from_numpy(bad),
                                       torch.from_numpy(np.array(want)).view(-1, n_max),
                                       torch.from_numpy(np.array(want_bad)), C)
    return bad, np.asarray(want_bad), ok


def test_decode_flags_corrupt_payload():
    rng = np.random.default_rng(5)
    data, offs, bits, counts, inits, _ = _host_payload_stream(rng, 2, 2, 64, 50)
    data = bytearray(data)
    start = (int(offs[0]) >> 3) + 1
    data[start : start + 24] = b"\x00" * 24
    bad, want_bad, ok = _agree_with_sla_tpu(bytes(data), offs, bits, counts, inits, 2, 64)
    assert bad[0] and np.array_equal(bad, want_bad) and ok


@pytest.mark.parametrize("case", ["unary run", "gamma digits", "cursor past the window"])
def test_decode_flags_every_condition_as_sla_tpu(case):
    """Each of the reference's three flag conditions raises the same flags
    in the port, and the unflagged blocks decode the same."""
    rows, counts, inits = vd.entropy_blocks(11, 4, 2, 1500, 3000.0)
    stream, offs, bits = vd.entropy_stream(12, rows, counts, inits, 2)
    if case == "cursor past the window":
        bits = np.full_like(bits, 64)
    elif case == "unary run":
        stream = vd.corrupt_entropy_stream(stream, offs)
        offs, bits, counts, inits = offs[:1], bits[:1], counts[:1], inits[:1]
    else:
        stream = vd.corrupt_entropy_stream(stream, offs)
        offs, bits, counts, inits = offs[1:], bits[1:], counts[1:], inits[1:]
    bad, want_bad, ok = _agree_with_sla_tpu(stream, offs, bits, counts, inits, 2, 1500)
    assert bad[0] and np.array_equal(bad, want_bad) and ok


# -- the policy --------------------------------------------------------------------


ENV_TABLE = [  # (variable, config, backend, on)
    ("0", "auto", "device", False), ("off", "auto", "device", False),
    ("FALSE", "auto", "device", False), ("no", "auto", "device", False),
    (" Off ", "auto", "mesh", False),
    ("1", "off", "host", True), ("on", "off", "host", True), ("anything", "off", "host", True),
    ("", "auto", "device", True), ("  ", "auto", "device", True), ("", "auto", "mesh", True),
    ("", "auto", "host", False), ("", "off", "mesh", False), ("", "off", "device", False),
]


@pytest.mark.parametrize("value,config,backend,on", ENV_TABLE)
def test_device_entropy_policy_matches_sla_tpu(monkeypatch, value, config, backend, on):
    """SLA_TPU_DEVICE_ENTROPY: 0/off/false/no force it off, anything else
    non-empty forces it on, unset or empty defers to the config; the
    reference gives the same answer for every (value, config, backend)."""
    from sla_tpu.pipeline import device_entropy_on as ref_policy

    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", value)
    got = pipeline.device_entropy_on(st.EncoderConfig(device_entropy=config), backend)
    assert got == ref_policy(sla_tpu.EncoderConfig(device_entropy=config), backend) == on
    assert pipeline.device_entropy_on(st.DecoderConfig(device_entropy=config), backend) == on


def test_mesh_with_device_entropy_forced_equals_host(monkeypatch):
    """SLA_TPU_DEVICE_ENTROPY=1 on the mesh backend: K8 codes the residual
    gathered onto the encoder's device, and the stream equals the host
    backend's and sla_tpu's; the mesh decode (K9, then the shards) is exact."""
    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", "1")
    pcm = gen_wave("chirp", 6000, 2, 16, 0, seed=3)
    enc = st.Encoder(st.EncoderConfig(backend="mesh"), device="cpu")
    enc.set_wave_format(st.WaveFormat(2, 16, 44100))
    enc.set_encode_parameter(PARAM)
    blob = enc.encode_whole(pcm)
    assert enc._device_entropy_active
    monkeypatch.delenv("SLA_TPU_DEVICE_ENTROPY")
    assert blob == _encode(st, pcm)[1] == _encode(sla_tpu, pcm)[1]
    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", "1")
    monkeypatch.setattr(sharding, "SHARDS", 2)
    dec = st.Decoder(st.DecoderConfig(backend="mesh"), device="cpu")
    assert np.array_equal(dec.decode_whole(blob)[1], pcm)


# -- the codec on device="cpu" -----------------------------------------------------


def _encode(mod, pcm, backend="host", device="cpu", **cfg):
    """(encoder, stream) of `pcm` at 4,096-sample preset 2; sla_tpu's
    Encoder takes no device."""
    enc = (mod.Encoder(mod.EncoderConfig(backend=backend, **cfg), device=device) if mod is st
           else mod.Encoder(mod.EncoderConfig(backend=backend, **cfg)))
    enc.set_wave_format(mod.WaveFormat(pcm.shape[0], 16, 44100))
    enc.set_encode_parameter(PARAM if mod is st else REF_PARAM)
    return enc, enc.encode_whole(pcm)


def test_encoder_codes_entropy_on_the_device_backend_by_default():
    """The device backend codes entropy with K8 (its plain version here) by
    default and writes sla_tpu's host stream; device_entropy='off' codes it
    on the host and writes the same bytes."""
    pcm = gen_wave("chirp", 7000, 2, 16, 0, seed=8)
    _, want = _encode(sla_tpu, pcm)
    before = dict(cuda_filters.launches)
    enc, blob = _encode(st, pcm, "device")
    assert enc._device_entropy_active and blob == want
    enc_off, blob_off = _encode(st, pcm, "device", device_entropy="off")
    assert not enc_off._device_entropy_active and blob_off == want
    assert cuda_filters.launches == before  # the CPU runs plain versions


def test_encoder_device_entropy_forced_on_the_host_backend(monkeypatch):
    pcm = gen_wave("chirp", 7000, 2, 16, 0, seed=9)
    _, want = _encode(sla_tpu, pcm)
    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", "1")
    enc, blob = _encode(st, pcm, "host")
    assert enc._device_entropy_active and blob == want
    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", "0")
    enc, blob = _encode(st, pcm, "device")
    assert not enc._device_entropy_active and blob == want


def test_decoder_device_entropy_matches_host():
    """The device backend decodes entropy with K9 (plain here) by default,
    and with device_entropy='off' on the host: the same exact PCM."""
    pcm = gen_wave("chirp", 7000, 2, 16, 0, seed=21)
    _, blob = _encode(sla_tpu, pcm)
    for kw in ({}, {"device_entropy": "off"}):
        dec = st.Decoder(st.DecoderConfig(backend="device", **kw), device="cpu")
        assert np.array_equal(dec.decode_whole(blob)[1], pcm)


def test_decoder_device_entropy_forced_on_host_backend(monkeypatch):
    """Forced on-card entropy with host synthesis: the batch lands on the
    host once and feeds the host cascade."""
    pcm = gen_wave("chirp", 7000, 2, 16, 0, seed=23)
    _, blob = _encode(sla_tpu, pcm)
    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", "1")
    _, out = st.Decoder(device="cpu").decode_whole(blob)
    assert np.array_equal(out, pcm)


def test_decoder_device_entropy_mixed_golomb_group(monkeypatch):
    """A minority of static-Golomb blocks in a loud stream keeps the group on
    the device path: the stragglers decode on the host and scatter in."""
    loud = gen_wave("noise", 12288, 2, 16, 0, seed=24)
    quiet = (np.random.default_rng(25).integers(-2, 3, size=(2, 4096))
             .astype(np.int32) << 16)
    pcm = np.concatenate([loud[:, :8192], quiet, loud[:, 8192:]], axis=1)
    _, blob = _encode(sla_tpu, pcm)
    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", "1")
    dec = st.Decoder(st.DecoderConfig(backend="device"), device="cpu")
    header = dec._open_stream(blob)
    blocks = dec.scan_blocks(blob, header.num_samples)
    comp = [i for i, b in enumerate(blocks) if b.block_type == BlockDataType.COMPRESSDATA]
    golomb = [rice_device.is_golomb_block(blocks[i].init_rice) for i in comp]
    assert any(golomb) and not all(golomb)
    assert dec._device_entropy_group(blob, blocks, comp, PARAM.max_num_block_samples) is not None
    _, out = dec.decode_whole(blob)
    assert np.array_equal(out, pcm)


def test_decoder_device_entropy_golomb_group_takes_the_host_coder(monkeypatch):
    rng = np.random.default_rng(9)
    pcm = rng.integers(-2, 3, size=(2, 9000)).astype(np.int32) << 16
    _, blob = _encode(sla_tpu, pcm)
    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", "1")
    dec = st.Decoder(st.DecoderConfig(backend="device"), device="cpu")
    _, out = dec.decode_whole(blob)
    assert np.array_equal(out, pcm)


def test_decoder_device_entropy_corrupt_equals_host(monkeypatch):
    """With the CRC off, a corrupt payload decodes to the host path's
    output (the flagged block is decoded again on the host), or fails the
    same way."""
    pcm = gen_wave("noise", 7000, 2, 16, 0, seed=22)
    _, blob = _encode(sla_tpu, pcm)
    blob = bytearray(blob)
    blob[len(blob) // 2] ^= 0xFF
    blob = bytes(blob)

    def decode(backend):
        cfg = st.DecoderConfig(enable_crc_check=False, backend=backend)
        try:
            return st.Decoder(cfg, device="cpu").decode_whole(blob)[1]
        except st.SLAError as e:
            return repr(e)

    host = decode("host")
    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", "1")
    dev = decode("device")
    if isinstance(host, str):
        assert host == dev
    else:
        assert np.array_equal(host, dev)


def test_decode_range_and_salvage_under_forced_device_entropy(monkeypatch):
    pcm = gen_wave("chirp", 12000, 2, 16, 0, seed=26)
    _, blob = _encode(sla_tpu, pcm)
    monkeypatch.setenv("SLA_TPU_DEVICE_ENTROPY", "1")
    _, win = st.Decoder(device="cpu").decode_range(blob, 3000, 5000)
    assert np.array_equal(win, pcm[:, 3000:8000])
    _, segs = st.Decoder(device="cpu").decode_salvage(blob)
    assert len(segs) == 1 and segs[0].sample_offset == 0
    assert np.array_equal(segs[0].pcm, pcm)


# -- K9's cursor limit against what a stream can ask for -------------------------


def test_no_header_reaches_the_decode_symbol_limit():
    """K9 refuses blocks of more than MAX_DECODE_SYMBOLS symbols (its 32-bit
    cursor); a block is at most max_num_block_samples x channels, the
    header stores the first in 16 bits and the decoder refuses more than
    SLA_MAX_CHANNELS channels, so no stream reaches the limit."""
    from sla_tpu_torch.constants import SLA_MAX_CHANNELS

    assert 0xFFFF * SLA_MAX_CHANNELS <= cuda_entropy.MAX_DECODE_SYMBOLS
    assert st.DecoderConfig().max_num_channels <= SLA_MAX_CHANNELS


@pytest.mark.parametrize("n_max", [0xFFFF, 0x10000, 0x10000 + 12288, 1 << 20, (1 << 20) - 1])
def test_header_block_size_never_round_trips_larger(n_max):
    """A header written with max_num_block_samples over 0xFFFF keeps its low
    16 bits (format.py's `& 0xFFFF`), as sla_tpu's does: the n_max the
    decoder reads back is never larger than 0xFFFF."""
    from sla_tpu import format as ref_format
    from sla_tpu_torch import format as fmt

    def header(mod, pkg):
        ep = dataclasses.replace(pkg.PRESETS[2], max_num_block_samples=n_max)
        return mod.HeaderInfo(pkg.WaveFormat(8, 16, 44100), ep, num_samples=1000, num_blocks=1)

    blob = fmt.encode_header(header(fmt, st))
    assert blob == ref_format.encode_header(header(ref_format, sla_tpu))
    got, _ = fmt.decode_header(blob)
    assert got.encode_param.max_num_block_samples == n_max & 0xFFFF <= 0xFFFF
    assert got.encode_param.max_num_block_samples * 8 <= cuda_entropy.MAX_DECODE_SYMBOLS
