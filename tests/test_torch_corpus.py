"""The port's corpus mode (sla_tpu_torch/corpus.py) and batched encode
(encoder.encode_whole_batch) against sla_tpu's, with device="cpu": the
same .sla and .wav bytes, the same manifests once their timing fields are
removed, and the same errors. Each side runs in its own directory with
relative paths, so the manifests' file keys match."""

import json
import pathlib
import shutil
import threading

import numpy as np
import pytest

import sla_tpu
import sla_tpu.corpus
import sla_tpu.encoder
from sla_tpu import wavio

import sla_tpu_torch as st
import sla_tpu_torch.corpus
import sla_tpu_torch.encoder

from .test_encode_decode import gen_wave

_TIMING = ("seconds", "compute_seconds", "write_seconds", "read_seconds", "stage_seconds")


def _clips():
    """Five short clips, stereo and mono, 16 and 24 bit, one silent."""
    spec = [("chirp", 2, 16), ("sine", 1, 16), ("noise", 2, 24), ("silence", 1, 16),
            ("gauss", 2, 16)]
    return [(f"c{i}_{kind}", gen_wave(kind, 5000 + 613 * i, ch, w, 0, seed=i), w)
            for i, (kind, ch, w) in enumerate(spec)]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus_inputs")
    (root / "wavs").mkdir()
    for name, pcm, w in _clips():
        wavio.write_wav(str(root / "wavs" / f"{name}.wav"),
                        wavio.WavFile(pcm.shape[0], 44100, w, pcm))
    # RIFF/WAVE with a 2-byte fmt body (tests/test_cli.py's malformed WAV)
    (root / "wavs" / "c9_bad.wav").write_bytes(
        b"RIFF" + (30).to_bytes(4, "little") + b"WAVE" + b"fmt "
        + (2).to_bytes(4, "little") + b"\x01\x00")
    return root


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in _TIMING}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _tree(root: pathlib.Path, sub: str) -> dict:
    out = {}
    for p in sorted((root / sub).rglob("*")):
        if p.is_file():
            data = p.read_bytes()
            out[p.name] = _strip(json.loads(data)) if p.suffix == ".json" else data
    return out


def _both(fn_name, inputs, tmp_path, monkeypatch, runs, sub="out"):
    """runs: list of (args, kwargs) for corpus.<fn_name>, each with paths
    relative to the inputs' copy. Returns (ref results, port results, port dir)."""
    got = {}
    for name, mod, kw in (("ref", sla_tpu.corpus, {}),
                          ("port", sla_tpu_torch.corpus, {"device": "cpu"})):
        work = tmp_path / name
        shutil.copytree(inputs, work)
        monkeypatch.chdir(work)
        res = [getattr(mod, fn_name)(*a, **k, **kw) for a, k in runs]
        got[name] = ([_strip(r.__dict__) for r in res], _tree(work, sub))
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1].keys() == got["ref"][1].keys()
    for k, v in got["ref"][1].items():
        assert got["port"][1][k] == v, k
    return got["ref"], got["port"], tmp_path / "port"


def _wavs(work=None):
    root = pathlib.Path("wavs") if work is None else work / "wavs"
    return sorted(root.glob("*.wav"))


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("filter_batch", [1, 4])
def test_encode_corpus_matches_sla_tpu(inputs, tmp_path, monkeypatch, filter_batch, overlap):
    files = sorted(p.relative_to(inputs) for p in _wavs(inputs))
    _, (results, tree), work = _both(
        "encode_corpus", inputs, tmp_path, monkeypatch,
        [((files, "out"), {"preset": 1, "filter_batch": filter_batch, "overlap_io": overlap})])
    assert results[0]["encoded"] == 5 and results[0]["failed"] == 1
    for name, pcm, _ in _clips():
        _, out = st.Decoder(device="cpu").decode_whole(tree[f"{name}.sla"])
        assert np.array_equal(out, pcm)


def test_encode_corpus_resume(inputs, tmp_path, monkeypatch):
    files = sorted(p.relative_to(inputs) for p in _wavs(inputs))
    (ref, _), _, _ = _both(
        "encode_corpus", inputs, tmp_path, monkeypatch,
        [((files[:2], "out"), {"preset": 0}),
         ((files, "out"), {"preset": 0, "filter_batch": 3})])
    assert ref[1]["skipped"] == 2


@pytest.mark.parametrize("index", [0, 1])
def test_encode_corpus_process_shards(inputs, tmp_path, monkeypatch, index):
    files = sorted(p.relative_to(inputs) for p in _wavs(inputs))
    assert (sla_tpu_torch.corpus.shard_files(files, index, 2)
            == sla_tpu.corpus.shard_files(files, index, 2))
    (ref, _), _, _ = _both(
        "encode_corpus", inputs, tmp_path, monkeypatch,
        [((files, "out"), {"preset": 2, "process_index": index, "process_count": 2,
                           "filter_batch": 2})])
    assert ref[0]["total_files"] == len(sla_tpu.corpus.shard_files(files, index, 2))


def test_output_names_and_merge(inputs, tmp_path, monkeypatch):
    paths = [pathlib.Path("a/x.wav"), pathlib.Path("b/x.wav"), pathlib.Path("c/y.wav")]
    monkeypatch.chdir(tmp_path)
    assert (sla_tpu_torch.corpus.output_names(paths)
            == sla_tpu.corpus.output_names(paths))
    files = sorted(p.relative_to(inputs) for p in _wavs(inputs))
    _both("encode_corpus", inputs, tmp_path, monkeypatch,
          [((files, "out"), {"preset": 0, "process_index": i, "process_count": 2})
           for i in (0, 1)])
    merged = {}
    for name, mod in (("ref", sla_tpu.corpus), ("port", sla_tpu_torch.corpus)):
        merged[name] = _strip(mod.merge_manifests(tmp_path / name / "out"))
    assert merged["port"] == merged["ref"]


@pytest.mark.parametrize("overlap", [True, False])
def test_decode_corpus_matches_sla_tpu(inputs, tmp_path, monkeypatch, overlap):
    src = tmp_path / "src"
    shutil.copytree(inputs, src)
    monkeypatch.chdir(src)
    sla_tpu.corpus.encode_corpus(_wavs(), "slas", preset=1)
    files = sorted(pathlib.Path("slas").glob("*.sla"))
    bad = bytearray(files[0].read_bytes())
    bad[len(bad) // 2] ^= 0xFF
    pathlib.Path("slas/z_bad.sla").write_bytes(bytes(bad))
    files.append(pathlib.Path("slas/z_bad.sla"))
    (ref, _), _, _ = _both(
        "decode_corpus", src, tmp_path / "cmp", monkeypatch,
        [((files, "dec"), {"overlap_writes": overlap}),
         ((files, "dec"), {}),
         ((files, "vo"), {"verify_only": True})], sub="dec")
    assert ref[0]["encoded"] == 5 and ref[0]["failed"] == 1
    assert ref[1]["skipped"] == 5


def test_encode_corpus_exception_ends_both_threads(inputs, tmp_path, monkeypatch):
    """An exception the chunk loop does not isolate propagates, and the
    reader and writer threads end with it (sla_tpu's loop hangs here)."""
    files = _wavs(inputs)
    calls = {"n": 0}
    real = sla_tpu_torch.corpus.Encoder.encode_whole

    def failing(self, data):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected")
        return real(self, data)

    monkeypatch.setattr(sla_tpu_torch.corpus.Encoder, "encode_whole", failing)
    box = {}

    def run():
        try:
            sla_tpu_torch.corpus.encode_corpus(files, tmp_path / "out", preset=0,
                                               overlap_io=True, device="cpu")
        except RuntimeError as e:
            box["err"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(30)
    assert not t.is_alive(), "encode_corpus hung after the exception"
    assert str(box.get("err")) == "injected"
    alive = [th.name for th in threading.enumerate()
             if th.name in ("sla-corpus-reader", "sla-corpus-writer")]
    assert alive == []


# -- encode_whole_batch ---------------------------------------------------------


def _jobs(mod, preset=1, n=(6000, 4500, 5200)):
    jobs = []
    for i, length in enumerate(n):
        ch = 2 if i % 2 == 0 else 1
        width = 16 if i < 2 else 24
        pcm = gen_wave("chirp" if ch == 2 else "sine", length, ch, width, 0, seed=30 + i)
        jobs.append((mod.WaveFormat(ch, width, 44100), mod.preset_parameter(preset, ch), pcm))
    return jobs


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("backend", ["host", "device"])
def test_encode_whole_batch_matches_sla_tpu(backend, verify):
    ref = sla_tpu.encoder.encode_whole_batch(
        _jobs(sla_tpu), sla_tpu.EncoderConfig(backend=backend, verify=verify))
    port = sla_tpu_torch.encoder.encode_whole_batch(
        _jobs(st), st.EncoderConfig(backend=backend, verify=verify), device="cpu")
    assert port == ref
    for blob, (_, _, pcm) in zip(port, _jobs(st)):
        assert np.array_equal(st.Decoder(device="cpu").decode_whole(blob)[1], pcm)


def test_encode_whole_batch_device_entropy_mode_is_per_batch(monkeypatch):
    """Two batches on one process: the second reads its own run's entropy
    mode, not the first's (both give sla_tpu's bytes)."""
    cfg_dev = st.EncoderConfig(backend="device")
    cfg_host = st.EncoderConfig(backend="host")
    want = sla_tpu.encoder.encode_whole_batch(_jobs(sla_tpu, n=(3000, 2500)),
                                              sla_tpu.EncoderConfig(backend="host"))
    for cfg in (cfg_dev, cfg_host):
        assert sla_tpu_torch.encoder.encode_whole_batch(
            _jobs(st, n=(3000, 2500)), cfg, device="cpu") == want


def test_encode_whole_batch_rejects_two_presets():
    def mixed(mod):
        jobs = _jobs(mod, n=(3000, 2000))
        wf, _, pcm = jobs[1]
        return [jobs[0], (wf, mod.preset_parameter(3, wf.num_channels), pcm)]

    with pytest.raises(sla_tpu.SLAError) as ref:
        sla_tpu.encoder.encode_whole_batch(mixed(sla_tpu))
    with pytest.raises(st.SLAError) as port:
        sla_tpu_torch.encoder.encode_whole_batch(mixed(st), device="cpu")
    assert int(port.value.result) == int(ref.value.result)
    assert str(port.value) == str(ref.value)
    assert sla_tpu_torch.encoder.encode_whole_batch([], device="cpu") == []
