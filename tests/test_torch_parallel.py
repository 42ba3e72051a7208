"""sla_tpu_torch's mesh backend (sla_tpu_torch/parallel/, the mesh branches
of the encoder and decoder) on an 8-shard CPU mesh: the twin of
tests/test_parallel.py, case for case, against sla_tpu on the JAX 8-device
virtual CPU mesh (tests/conftest.py) with the same seeded inputs.

Every whole-codec case holds the port's 'mesh' output against sla_tpu's
'mesh' output and the port's 'host' output; the sharded steps hold the
port's shards against sla_tpu's and against the unsharded plain chain.
sla_tpu's sharded functions take (NB, NC, ...) grids and the port's take
the same batch as (NB * NC, ...) rows: the cases reshape at that boundary.
Exact comparisons (integer codec, tolerance 0), except `gmax`, a float32
log2 that XLA and torch may round an ulp apart: rtol 1e-6. The clips are
short and mostly at preset 0 (4,096-sample blocks): on a CPU shard every
stage is a plain per-sample loop, once a shard, so the whole-codec cases
shard the port's CPU mesh twice (`two_shards`). For the same reason the
decode cases other than the device-entropy contrast decode the payloads on
the host in both packages (device_entropy='off'): the plain K9 loops over
every symbol, and the contrast case holds the mesh decode with it on. Tests of TPU scaffolding
(the Pallas mesh bodies and their window plans) have no twin: the port
has neither.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sla_tpu
from sla_tpu import parallel as ref_par
from sla_tpu.errors import SLAError as RefSLAError

import sla_tpu_torch as st
from sla_tpu_torch import entry, native, pipeline
from sla_tpu_torch.errors import SLAError
from sla_tpu_torch.parallel import (
    gather,
    gather_to,
    make_mesh,
    mesh_devices,
    shard_batch,
    sharded_decode_step,
    sharded_encode_stage1,
    sharded_encode_stage2,
    sharded_encode_step,
)
from sla_tpu_torch.parallel import sharding

from .test_parallel import _inputs, _pcm

pytestmark = pytest.mark.skipif(not native.available(), reason="native build unavailable")

CPU8 = ["cpu"] * 8


def _encode(mod, pcm, backend, preset=0, **cfg):
    C = pcm.shape[0]
    if mod is st:
        enc = st.Encoder(st.EncoderConfig(backend=backend, **cfg), device="cpu")
    else:
        enc = sla_tpu.Encoder(sla_tpu.EncoderConfig(backend=backend, **cfg))
    enc.set_wave_format(mod.WaveFormat(C, 16, 44100))
    enc.set_encode_parameter(mod.preset_parameter(preset, C))
    return enc.encode_whole(pcm)


def _decoder(mod, backend, **cfg):
    if mod is st:
        return st.Decoder(st.DecoderConfig(backend=backend, **cfg), device="cpu")
    return sla_tpu.Decoder(sla_tpu.DecoderConfig(backend=backend, **cfg))


def _mesh_stream(pcm, preset=0, **cfg):
    """The port's mesh stream, after holding it equal to sla_tpu's mesh
    stream and to the port's host stream."""
    got = _encode(st, pcm, "mesh", preset, **cfg)
    assert got == _encode(sla_tpu, pcm, "mesh", preset, **cfg)
    assert got == _encode(st, pcm, "host", preset)
    return got


@pytest.fixture
def two_shards(monkeypatch):
    """Shard the port's CPU mesh twice, not 8 times: the shard count
    changes no output, and every CPU shard runs the plain loops on its own
    (sla_tpu's side keeps its 8 devices)."""
    monkeypatch.setattr(sharding, "SHARDS", 2)


def _mesh_decode(blob, pcm, **cfg):
    """The port's mesh decode equals the input PCM, sla_tpu's mesh decode
    and the port's host decode; host entropy unless `cfg` says otherwise."""
    cfg.setdefault("device_entropy", "off")
    _, got = _decoder(st, "mesh", **cfg).decode_whole(blob)
    _, ref = _decoder(sla_tpu, "mesh", **cfg).decode_whole(blob)
    _, host = _decoder(st, "host").decode_whole(blob)
    assert np.array_equal(got, pcm)
    assert np.array_equal(got, ref) and np.array_equal(got, host)


# ---- sharded step level: channel_parallel x channels ------------------------


@pytest.mark.parametrize(
    "channel_parallel,NC",
    [(1, 1), (1, 2), (1, 6), (1, 8), (2, 2), (2, 6), (2, 8), (4, 8)],
)
def test_sharded_step_matrix(channel_parallel, NC):
    mesh = make_mesh(CPU8, channel_parallel=channel_parallel)
    ref_mesh = ref_par.make_mesh(jax.devices()[:8], channel_parallel=channel_parallel)
    p, T, M = 8, 1, 4
    NB, L = 2 * mesh.shape["blocks"], 256
    B = NB * NC
    data, coef, pitch, ltm = _inputs(NB, NC, L, p, T, seed=NC)
    d_data, d_coef = shard_batch(mesh, data.reshape(B, L), coef.reshape(B, p))
    pitch_r, ltm_r = pitch.reshape(B), ltm.reshape(B, T)
    r_data, r_coef, r_ltm = ref_par.shard_batch(ref_mesh, data, coef, ltm)
    r_pitch = ref_par.shard_batch(ref_mesh, pitch[..., None])[0][..., 0]

    def rows(x):
        return np.asarray(x).reshape((B,) + np.asarray(x).shape[2:])

    res, abs_sum, bits, gmax = sharded_encode_step(d_data, d_coef, pitch_r, ltm_r, p, T, M)
    want_res, want_sum, want_gmax = ref_par.sharded_encode_step(
        r_data, r_coef, r_pitch, r_ltm, p, T, M, ref_mesh
    )
    assert np.array_equal(gather(res), rows(want_res))
    assert np.array_equal(gather(abs_sum), rows(want_sum))
    assert gather(abs_sum).dtype == np.int64 and gather(bits).dtype == np.float32
    np.testing.assert_allclose(gmax, float(np.asarray(want_gmax)), rtol=1e-6)
    assert gmax == gather(bits).max() and np.isfinite(gmax)
    plain = pipeline.encode_filters(
        torch.from_numpy(data.reshape(B, L)), torch.from_numpy(coef.reshape(B, p)),
        pitch_r, ltm_r, p, T, M,
    )
    assert np.array_equal(gather(res), plain.numpy())

    # the two encode halves, each against sla_tpu's
    s1 = sharded_encode_stage1(d_data, d_coef, p)
    r_s1 = ref_par.sharded_encode_stage1(r_data, r_coef, p, ref_mesh)
    assert np.array_equal(gather(s1), rows(r_s1))
    s2 = sharded_encode_stage2(s1, pitch_r, ltm_r, T, M)
    r_s2 = ref_par.sharded_encode_stage2(r_s1, r_pitch, r_ltm, T, M, ref_mesh)
    assert np.array_equal(gather(s2), rows(r_s2))
    assert np.array_equal(gather(s2), gather(res))

    # decode mirror: the sharded synthesis inverts the residual exactly
    pcm = sharded_decode_step(res, d_coef, pitch_r, ltm_r, p, T, M)
    r_pcm = ref_par.sharded_decode_step(want_res, r_coef, r_pitch, r_ltm, p, T, M, ref_mesh)
    assert np.array_equal(gather(pcm), data.reshape(B, L))
    assert np.array_equal(gather(pcm), rows(r_pcm))


# ---- the mesh itself ---------------------------------------------------------


def test_repeated_device_mesh_builds_a_tensor_per_shard():
    mesh = make_mesh(CPU8, channel_parallel=2)
    assert mesh.shape == {"blocks": 4, "channels": 2} and mesh.devices.shape == (4, 2)
    data = np.arange(32 * 3, dtype=np.int32).reshape(32, 3)
    x, = shard_batch(mesh, data)
    assert len(x.parts) == 8 and len({t.data_ptr() for t in x.parts}) == 8
    assert all(t.shape == (4, 3) for t in x.parts)
    assert x.shape == data.shape and np.array_equal(gather(x), data)
    assert torch.equal(gather_to(x, "cpu"), torch.from_numpy(data))
    # contiguous slices with no padding: 11 rows over 8 shards, and fewer
    # parts than shards when the rows run out
    x, = shard_batch(mesh, data[:11])
    assert [t.shape[0] for t in x.parts] == [1, 1, 2, 1, 1, 2, 1, 2]
    assert [(r.start, r.stop) for r, _ in x.slices()][:2] == [(0, 1), (1, 2)]
    assert np.array_equal(gather(x), data[:11])
    x, = shard_batch(mesh, torch.from_numpy(data[:3]))
    assert len(x.parts) == 3 and np.array_equal(gather(x), data[:3])


def test_make_mesh_rules(monkeypatch):
    monkeypatch.setenv("SLA_TPU_MESH_CHANNELS", "3")
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(CPU8)
    with pytest.raises(ValueError, match="not divisible"):
        ref_par.make_mesh(jax.devices()[:8])
    monkeypatch.setenv("SLA_TPU_MESH_CHANNELS", "2")
    assert make_mesh(CPU8).shape == dict(ref_par.make_mesh(jax.devices()[:8]).shape)
    # device="cpu" shards 8 times unless SHARDS says otherwise; on CUDA the
    # shards take the cards in turn
    assert mesh_devices("cpu") == [torch.device("cpu")] * 8
    monkeypatch.setattr(sharding, "SHARDS", 2)
    assert mesh_devices("cpu") == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(sharding, "SHARDS", 3)
    assert mesh_devices("cuda") == [torch.device("cuda", i) for i in (0, 1, 0)]
    monkeypatch.setattr(sharding, "SHARDS", None)
    assert mesh_devices("cuda") == [torch.device("cuda", i) for i in (0, 1)]
    # no CUDA device: make_mesh() has nothing to take and says so
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


# ---- full pipeline: mesh encode byte-identical to host ----------------------


@pytest.mark.usefixtures("two_shards")
@pytest.mark.parametrize("C,preset", [(2, 2), (6, 0)])
def test_mesh_encode_byte_identical(C, preset):
    # sla_tpu fills its 8-shard grid with zero rows for either C; the port
    # cuts the rows in two with no padding (C=6: 18 rows, so block 1's
    # channels lie on both shards)
    _mesh_stream(_pcm(C, 12000, seed=C), preset)


def test_mesh_encode_single_block_row_padding():
    # one mono block: 1 row on an 8-shard mesh (sla_tpu's maximal padding;
    # the port's batch is one part on one shard)
    _mesh_stream(_pcm(1, 4000))


@pytest.mark.usefixtures("two_shards")
def test_mesh_segmented_encode_byte_identical(monkeypatch):
    # rolling-window segmented encode (SLA_TPU_SEGMENT_SAMPLES) on the mesh
    # backend: segment boundaries must not change a single byte
    pcm = _pcm(2, 20000, seed=11)
    host = _encode(st, pcm, "host")
    monkeypatch.setenv("SLA_TPU_SEGMENT_SAMPLES", "16384")
    assert _mesh_stream(pcm) == host


# ---- full pipeline: mesh decode ---------------------------------------------


@pytest.mark.usefixtures("two_shards")
@pytest.mark.parametrize("C", [2, 6])
def test_mesh_decode_pcm_exact(C):
    pcm = _pcm(C, 12000, seed=20 + C)
    _mesh_decode(_encode(st, pcm, "host"), pcm)


# ---- assert mode -------------------------------------------------------------


def _assert_mode_calls(mesh, ref_mesh):
    p, T, M = 8, 1, 4
    NB, NC, L = 2 * mesh.shape["blocks"], 1, 64
    data, coef, pitch, ltm = _inputs(NB, NC, L, p, T)
    d_data, d_coef = shard_batch(mesh, data.reshape(NB, L), coef.reshape(NB, p))
    pitch_r, ltm_r = pitch.reshape(NB), ltm.reshape(NB, T)
    r_data, r_coef, r_ltm = ref_par.shard_batch(ref_mesh, data, coef, ltm)
    r_pitch = ref_par.shard_batch(ref_mesh, pitch[..., None])[0][..., 0]
    return {
        "step": (lambda: sharded_encode_step(d_data, d_coef, pitch_r, ltm_r, p, T, M),
                 lambda: ref_par.sharded_encode_step(r_data, r_coef, r_pitch, r_ltm, p, T, M,
                                                     ref_mesh)),
        "stage1": (lambda: sharded_encode_stage1(d_data, d_coef, p),
                   lambda: ref_par.sharded_encode_stage1(r_data, r_coef, p, ref_mesh)),
        "stage2": (lambda: sharded_encode_stage2(d_data, pitch_r, ltm_r, T, M),
                   lambda: ref_par.sharded_encode_stage2(r_data, r_pitch, r_ltm, T, M, ref_mesh)),
        "decode": (lambda: sharded_decode_step(d_data, d_coef, pitch_r, ltm_r, p, T, M),
                   lambda: ref_par.sharded_decode_step(r_data, r_coef, r_pitch, r_ltm, p, T, M,
                                                       ref_mesh)),
    }


@pytest.mark.parametrize("which", ["step", "stage1", "stage2", "decode"])
def test_assert_mode_rejected_on_sharded_step(monkeypatch, which):
    calls = _assert_mode_calls(make_mesh(CPU8), ref_par.make_mesh(jax.devices()[:8]))
    port, ref = calls[which]
    monkeypatch.setenv("SLA_TPU_DEBUG_ASSERTS", "1")
    with pytest.raises(SLAError, match="not supported on the mesh path"):
        port()
    with pytest.raises(RefSLAError, match="not supported on the mesh path"):
        ref()


@pytest.mark.usefixtures("two_shards")
def test_assert_mode_demotes_mesh_encoder(monkeypatch):
    # the encoder demotes backend='mesh' to the checked single-device path
    # instead of raising; bytes must still match the host path
    pcm = _pcm(2, 15000, seed=31)
    host = _encode(st, pcm, "host")
    monkeypatch.setenv("SLA_TPU_DEBUG_ASSERTS", "1")
    assert _mesh_stream(pcm) == host


def test_assert_mode_mesh_decoder_raises(monkeypatch):
    # the decoder has no demotion: its mesh branch reaches
    # sharded_decode_step, which refuses assert mode in both packages
    # (sla_tpu's refuses while it traces, so its cache is cleared first)
    pcm = _pcm(2, 6000, seed=32)
    blob = _encode(st, pcm, "host")
    monkeypatch.setenv("SLA_TPU_DEBUG_ASSERTS", "1")
    with pytest.raises(SLAError, match="mesh path"):
        _decoder(st, "mesh", device_entropy="off").decode_whole(blob)
    jax.clear_caches()
    with pytest.raises(RefSLAError, match="mesh path"):
        _decoder(sla_tpu, "mesh", device_entropy="off").decode_whole(blob)


@pytest.mark.usefixtures("two_shards")
@pytest.mark.parametrize("C", [2, 6])
def test_mesh_decode_device_entropy_contrast(C):
    """backend='mesh' decodes the recursive-Rice payloads on the device by
    default (K9 on the decoder's device, its rows split onto the shards);
    on-device entropy and forced host entropy both give the exact PCM."""
    pcm = _pcm(C, 12000, seed=40 + C)
    blob = _encode(st, pcm, "host")
    _mesh_decode(blob, pcm, device_entropy="auto")
    _mesh_decode(blob, pcm, device_entropy="off")


# ---- channel-parallel meshes at the full-pipeline level ----------------------


@pytest.mark.usefixtures("two_shards")
def test_mesh_encode_channel_parallel_byte_identical(monkeypatch):
    """C=6 stream with SLA_TPU_MESH_CHANNELS=2: sla_tpu splits each
    block's six channel rows 3+3 over its channel axis; the port's grid
    shape changes no placement. Bytes must equal host."""
    pcm = _pcm(6, 12000, seed=61)
    monkeypatch.setenv("SLA_TPU_MESH_CHANNELS", "2")
    _mesh_stream(pcm)


@pytest.mark.usefixtures("two_shards")
def test_mesh_decode_channel_parallel_pcm_exact(monkeypatch):
    pcm = _pcm(6, 12000, seed=62)
    blob = _encode(st, pcm, "host")
    monkeypatch.setenv("SLA_TPU_MESH_CHANNELS", "2")
    _mesh_decode(blob, pcm)


@pytest.mark.usefixtures("two_shards")
def test_mesh_channel_parallel_indivisible_falls_back(monkeypatch):
    """C=3 cannot split over a 2-wide channel axis: sla_tpu falls back to
    pure block parallelism, the port cuts rows as always, and both stay
    byte- and PCM-exact."""
    pcm = _pcm(3, 12000, seed=63)
    monkeypatch.setenv("SLA_TPU_MESH_CHANNELS", "2")
    _mesh_decode(_mesh_stream(pcm), pcm)


# ---- mesh x random access / salvage / long-stream grouping -------------------


@pytest.mark.usefixtures("two_shards")
def test_mesh_decode_range_exact():
    """decode_range on the mesh backend: indexed window == sla_tpu's mesh
    window == the input slice."""
    pcm = _pcm(2, 20000, seed=64)
    blob = _encode(st, pcm, "host")
    dm = _decoder(st, "mesh", device_entropy="off")
    rm = _decoder(sla_tpu, "mesh", device_entropy="off")
    idx = dm.build_index(blob)
    ridx = rm.build_index(blob)
    for start, count in [(0, 3000), (4096, 4096), (7000, 9000), (19990, 100)]:
        _, win = dm.decode_range(blob, start, count, index=idx)
        _, ref = rm.decode_range(blob, start, count, index=ridx)
        want = pcm[:, start : min(start + count, 20000)]
        assert np.array_equal(win, want), (start, count)
        assert np.array_equal(win, ref), (start, count)


@pytest.mark.usefixtures("two_shards")
def test_mesh_decode_salvage_matches_host():
    """decode_salvage on the mesh backend recovers the same segments as the
    host backend and as sla_tpu's mesh (same resync points, exact PCM)."""
    pcm = _pcm(2, 24000, seed=65)
    blob = bytearray(_encode(st, pcm, "host"))
    blob[len(blob) // 2] ^= 0xFF  # corrupt one mid-stream block
    blob = bytes(blob)
    _, segs_host = _decoder(st, "host").decode_salvage(blob)
    _, segs_mesh = _decoder(st, "mesh", device_entropy="off").decode_salvage(blob)
    _, segs_ref = _decoder(sla_tpu, "mesh", device_entropy="off").decode_salvage(blob)
    assert len(segs_host) == len(segs_mesh) == len(segs_ref) >= 1
    for a, b, r in zip(segs_host, segs_mesh, segs_ref):
        assert a.byte_offset == b.byte_offset == r.byte_offset
        assert a.gap_before_bytes == b.gap_before_bytes == r.gap_before_bytes
        assert a.sample_offset == b.sample_offset == r.sample_offset
        assert np.array_equal(a.pcm, b.pcm) and np.array_equal(b.pcm, r.pcm)


@pytest.mark.usefixtures("two_shards")
def test_mesh_segmented_long_stream_decode(monkeypatch):
    """Mesh decode over bounded synthesis groups (the long-stream path):
    tiny groups make one stream span several mesh dispatches."""
    import sla_tpu.decoder as ref_dmod
    import sla_tpu_torch.decoder as dmod

    pcm = _pcm(2, 6 * 4096, seed=66)
    blob = _encode(st, pcm, "host")
    monkeypatch.setattr(dmod, "_synth_group_rows", lambda C, L: 2 * C)
    monkeypatch.setattr(ref_dmod, "_synth_group_rows", lambda C, L: 2 * C)
    _mesh_decode(blob, pcm)


# ---- the 'auto' rule, the narrowing fetch, the dry run -------------------------


@pytest.mark.parametrize("cards,want", [(2, "mesh"), (8, "mesh"), (1, "device")])
def test_auto_picks_the_mesh_with_more_than_one_card(monkeypatch, cards, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    cuda = torch.device("cuda")
    big = pipeline.DEFAULT_DEVICE_THRESHOLD
    assert pipeline.select_backend("auto", big, cuda) == want
    assert pipeline.select_backend("auto", big - 1, cuda) == "host"
    # a CPU device never picks the mesh under 'auto'; asked for, it is used
    assert pipeline.select_backend("auto", big, torch.device("cpu")) == "host"
    assert pipeline.select_backend("mesh", 1, torch.device("cpu")) == "mesh"


def test_mesh_cards_under_torch_distributed(monkeypatch):
    """Inside a torch.distributed group of more than one process (one
    process a card), a mesh spans only the caller's card, so 'auto' stays
    on 'device' however many cards the machine has."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    card = torch.device("cuda", 2)
    assert pipeline.mesh_cards(card) == [card]
    assert mesh_devices(card) == [card]
    big = pipeline.DEFAULT_DEVICE_THRESHOLD
    assert pipeline.select_backend("auto", big, card) == "device"
    monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    assert len(pipeline.mesh_cards(card)) == 4
    assert pipeline.select_backend("auto", big, card) == "mesh"


@pytest.mark.parametrize(
    "edge",
    [-32768, 32767, 32768, -32769, -(2**31), 2**31 - 1],
)
def test_fetch_int32_exact(edge):
    rng = np.random.default_rng(abs(edge) % 1009)
    x = rng.integers(-30000, 30000, (5, 97), dtype=np.int32)
    x[2, 40] = edge
    got = pipeline.fetch_int32(torch.from_numpy(x))
    assert got.dtype == np.int32 and got.shape == x.shape and np.array_equal(got, x)
    small = np.asarray([[-32768, 0, 32767]], dtype=np.int32)
    assert np.array_equal(pipeline.fetch_int32(torch.from_numpy(small)), small)


@pytest.mark.parametrize("chunk_mb", [256, 1])
def test_device_branch_fetches_both_residuals_narrowed(monkeypatch, chunk_mb):
    """The device branch fetches residual 1 and residual 2 of every filter
    chunk through fetch_int32 (one chunk at the default budget, several at
    1 MB); the stream still equals the host's."""
    calls, chunks = [], []
    real_fetch, real_chunk = pipeline.fetch_int32, st.Encoder._run_filter_chunk

    def fetch(x):
        calls.append(tuple(x.shape))
        return real_fetch(x)

    def chunk(enc, plan_rows):
        chunks.append(len(plan_rows))
        return real_chunk(enc, plan_rows)

    monkeypatch.setattr(pipeline, "fetch_int32", fetch)
    monkeypatch.setattr(st.Encoder, "_run_filter_chunk", chunk)
    monkeypatch.setenv("SLA_TPU_FILTER_CHUNK_MB", str(chunk_mb))
    pcm = _pcm(2, 60000, seed=70)
    blob = _encode(st, pcm, "device", preset=2, device_entropy="off")
    assert (len(chunks) == 1) == (chunk_mb == 256) and len(chunks) >= 1
    assert len(calls) == 2 * len(chunks)
    assert calls[0::2] == calls[1::2]  # residual 1 and 2 of each chunk
    monkeypatch.delenv("SLA_TPU_FILTER_CHUNK_MB")
    assert blob == _encode(st, pcm, "host", preset=2)


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip(n):
    entry.dryrun_multichip(n, device="cpu")
