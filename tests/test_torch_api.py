"""The port's public namespace and its entry points' device rule: every
name sla_tpu/__init__.py binds itself is bound by sla_tpu_torch too, and
every entry point of this package runs on the CUDA card unless the caller
passes device="cpu"."""

import types

import pytest
import torch

import sla_tpu

import sla_tpu_torch as st
import sla_tpu_torch.corpus
import sla_tpu_torch.encoder

from .test_encode_decode import gen_wave


def _own_names(mod) -> set[str]:
    """Public names the package binds in its own __init__ (its imports and
    definitions; submodules bound by their own import excluded)."""
    return {k for k, v in vars(mod).items()
            if not k.startswith("_") and not isinstance(v, types.ModuleType)}


def test_port_binds_every_public_name_of_sla_tpu():
    missing = _own_names(sla_tpu) - _own_names(st)
    assert not missing, sorted(missing)
    assert st.__version__ == sla_tpu.__version__
    assert st.SLA_FORMAT_VERSION == sla_tpu.SLA_FORMAT_VERSION
    assert [str(p) for p in st.PRESETS] == [str(p) for p in sla_tpu.PRESETS]


@pytest.mark.parametrize("name", sorted(_own_names(sla_tpu)))
def test_each_name_is_the_same_kind(name):
    ref, port = getattr(sla_tpu, name), getattr(st, name)
    assert type(port).__name__ == type(ref).__name__
    if isinstance(ref, type):
        assert port.__module__.startswith("sla_tpu_torch")
        assert port.__name__ == ref.__name__


def test_header_codec_matches_sla_tpu():
    pcm = gen_wave("chirp", 3000, 2, 16, 0, seed=2)
    enc = sla_tpu.Encoder(sla_tpu.EncoderConfig(backend="host"))
    enc.set_wave_format(sla_tpu.WaveFormat(2, 16, 44100))
    enc.set_encode_parameter(sla_tpu.PRESETS[1])
    blob = enc.encode_whole(pcm)
    ref, ref_status = sla_tpu.decode_header(blob)
    port, status = st.decode_header(blob)
    assert str(port) == str(ref) and int(status) == int(ref_status)
    assert st.encode_header(port) == sla_tpu.encode_header(ref) == blob[:43]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _job():
    pcm = gen_wave("sine", 3000, 1, 16, 0, seed=1)
    return st.WaveFormat(1, 16, 44100), st.preset_parameter(1, 1), pcm


def test_encode_whole_batch_needs_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sla_tpu_torch.encoder.encode_whole_batch([_job()])
    assert len(sla_tpu_torch.encoder.encode_whole_batch([_job()], device="cpu")) == 1


def test_optimize_encode_needs_a_card(no_card):
    wf, _, pcm = _job()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.optimize_encode(pcm, wf)


@pytest.mark.parametrize("fn", ["encode_corpus", "decode_corpus"])
def test_corpus_needs_a_card(no_card, tmp_path, fn):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(sla_tpu_torch.corpus, fn)([], tmp_path / "out")
    getattr(sla_tpu_torch.corpus, fn)([], tmp_path / "out", device="cpu")


_SHARD = r"""
import json, pathlib, sys
import torch.distributed as dist
from sla_tpu_torch.corpus import encode_corpus
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
files = sorted(pathlib.Path(sys.argv[4]).glob("*.wav"))
res = encode_corpus(files, out, preset=0, filter_batch=2, device="cpu")
print(json.dumps([res.total_files, res.encoded]))
dist.destroy_process_group()
"""


def test_corpus_process_grid_comes_from_torch_distributed(tmp_path):
    """Without a group one process owns the corpus; in a two-process gloo
    group each rank encodes its round-robin shard and writes its manifest."""
    import json
    import pathlib
    import subprocess
    import sys

    from sla_tpu import wavio

    assert sla_tpu_torch.corpus._process_grid() == (0, 1)
    (tmp_path / "wavs").mkdir()
    for i in range(5):
        pcm = gen_wave("sine", 2000 + 100 * i, 1, 16, 0, seed=i)
        wavio.write_wav(str(tmp_path / "wavs" / f"w{i}.wav"), wavio.WavFile(1, 44100, 16, pcm))
    repo = pathlib.Path(__file__).resolve().parent.parent
    init = f"file://{tmp_path / 'pg'}"
    procs = [subprocess.Popen([sys.executable, "-c", _SHARD, str(r), init,
                               str(tmp_path / "out"), str(tmp_path / "wavs")],
                              cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e[-2000:] for _, e in outs]
    assert [json.loads(o.splitlines()[-1]) for o, _ in outs] == [[3, 3], [2, 2]]
    assert sorted(f.name for f in (tmp_path / "out").glob("*.sla")) == [
        f"w{i}.sla" for i in range(5)]
    assert {f.name for f in (tmp_path / "out").glob("manifest_*.json")} == {
        "manifest_0.json", "manifest_1.json"}
