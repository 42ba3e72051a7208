"""Bulk corpus encode: many WAV files -> .sla with resume markers
(counterpart of sla_tpu/corpus.py).

The reference is a single-file batch codec; the corpus runner is its
missing "large-scale" mode (corpus-level resume). Design:

* **Work sharding** — the file list is sharded round-robin by
  (process_index, num_processes) for multi-process runs (data parallelism
  at whole-file granularity; the grid comes from torch.distributed when a
  group is initialized); within a process, files stream through the
  encoder whose filter stage batches (blocks x channels) rows per file, or
  per `filter_batch` files (encoder.encode_whole_batch).
* **Checkpoint/resume** — each completed file writes `<out>.done` via
  atomic rename; a restarted run skips completed files. A manifest JSON
  aggregates sizes/ratios at the end.
* **Failure isolation** — a file that fails to parse/encode is recorded in
  the manifest with its error and does not abort the run (the reference's
  graceful-degradation stance, SLAEncoder.c:561-565, applied corpus-wide).

Every encoder and decoder runs on the caller's `device` (None: the CUDA
card, as `Encoder` and `Decoder` take it).
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import hashlib
import json
import os
import pathlib
import time

from . import preset_parameter, wavio
from .decoder import Decoder, DecoderConfig
from .encoder import Encoder, EncoderConfig, encode_whole_batch, resolve_device
from .errors import SLAError
from .format import WaveFormat


@dataclasses.dataclass
class CorpusResult:
    total_files: int
    encoded: int
    skipped: int
    failed: int
    in_bytes: int
    out_bytes: int
    seconds: float
    # wall split (BASELINE.md footnote 4 made machine-checkable). Decode:
    # compute = read + decode, write = WAV serialize + publish. Encode:
    # compute = filter+entropy encode (reads live on the reader thread,
    # per-entry `read_seconds`), write = .sla publish. With the overlap
    # threads the parts overlap, so their sum may exceed `seconds`.
    compute_seconds: float = 0.0
    write_seconds: float = 0.0

    @property
    def ratio(self) -> float:
        return self.out_bytes / self.in_bytes if self.in_bytes else 0.0


def shard_files(files: list, index: int, count: int) -> list:
    """Round-robin file sharding across processes."""
    return [f for i, f in enumerate(files) if i % count == index]


def _process_grid() -> tuple[int, int]:
    """(rank, world size) of the torch.distributed group when one is
    initialized, else (0, 1): one process owns the whole corpus."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def output_names(paths: list[pathlib.Path]) -> dict[pathlib.Path, str]:
    """Collision-free output basename per input path.

    Same-stem inputs from different directories get a short stable hash of
    the absolute path appended, so outputs and resume markers never alias
    (hashing only on collision keeps the common case human-readable, and
    the hash is deterministic across resumed runs)."""
    by_stem: dict[str, list[pathlib.Path]] = {}
    for p in paths:
        by_stem.setdefault(p.stem, []).append(p)
    names: dict[pathlib.Path, str] = {}
    for stem, group in by_stem.items():
        if len(group) == 1:
            names[group[0]] = stem
        else:
            for p in group:
                digest = hashlib.blake2b(
                    str(p.resolve()).encode(), digest_size=4
                ).hexdigest()
                names[p] = f"{stem}-{digest}"
    return names


def encode_corpus(
    files: list[str | pathlib.Path],
    out_dir: str | pathlib.Path,
    preset: int = 2,
    resume: bool = True,
    process_index: int | None = None,
    process_count: int | None = None,
    encoder_config: EncoderConfig | None = None,
    verbose: bool = False,
    filter_batch: int = 1,
    overlap_io: bool = True,
    device=None,
) -> CorpusResult:
    """Encode a WAV corpus into out_dir, one .sla per input.

    Resume: files whose `.done` marker exists are skipped. Multi-process:
    pass process_index/process_count (default: the torch.distributed rank
    and world size when a group is initialized, else 0/1).

    filter_batch > 1 fuses that many files' blocks into one filter-stage
    batch (encoder.encode_whole_batch), so a corpus of short files gathers
    enough rows for the card instead of dispatching per small file.
    Streams are byte-identical to
    filter_batch=1. A failed batch falls over to per-file encoding so
    failure isolation is preserved.

    ``overlap_io=True`` (default) runs the NEXT chunk's WAV reads on a
    background reader thread and .sla publishes on a background writer
    thread, so file I/O overlaps the filter/entropy compute (the encode
    twin of decode_corpus's ``overlap_writes``). Streams are byte-identical
    either way; manifest counters stay single-threaded (read results and
    publish results merge on the main thread). Each manifest entry records
    ``read_seconds`` / ``compute_seconds`` (batch chunks: the chunk wall
    split evenly) / ``write_seconds``, and the result totals compute vs
    write so a compute regression can't hide inside I/O noise. An
    exception that escapes the chunk loop ends both threads before it
    propagates."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if process_index is None or process_count is None:
        process_index, process_count = _process_grid()

    all_paths = [pathlib.Path(f) for f in files]
    mine = shard_files(all_paths, process_index, process_count)
    t0 = time.time()
    encoded = skipped = failed = 0
    in_bytes = out_bytes = 0
    manifest: dict = {}

    config = encoder_config or EncoderConfig()
    device = resolve_device(device)
    enc = Encoder(config, device=device)
    # name map over the FULL corpus, not this shard: same-stem files sharded
    # to different processes must still get distinct outputs/markers
    names = output_names(all_paths)

    # sweep temp files a killed earlier incarnation of THIS shard left behind
    # (shards are disjoint, so only our own names — and our manifest slot —
    # can carry stale temps; other live workers' temps are never touched)
    for path in mine:
        # glob.escape: a '[' or '?' in the stem must match literally, not as a
        # pattern — an unescaped stem could sweep ANOTHER worker's live temp
        for stale in out_dir.glob(_glob.escape(names[path] + ".sla.tmp") + "*"):
            try:
                stale.unlink()
            except OSError:
                pass
    for stale in out_dir.glob(f"manifest_{process_index}.json.tmp*"):
        try:
            stale.unlink()
        except OSError:
            pass

    def publish_one(path: pathlib.Path, blob: bytes,
                    stage_times: dict | None, read_sec: float | None,
                    compute_sec: float | None) -> dict:
        """stat + temp write + atomic publish + resume marker; returns the
        manifest entry (with ``error`` on failure). Runs inline or on the
        writer thread — it touches only its own temp/output names, so the
        next chunk's encode can proceed; counters merge after join."""
        w0 = time.perf_counter()
        out_path = out_dir / (names[path] + ".sla")
        # stat the input BEFORE the .done marker exists: a late OSError
        # (input deleted mid-run) must not leave a published+marked file
        # recorded as failed in the manifest
        try:
            in_size = path.stat().st_size
        except OSError:
            in_size = 0
        entry: dict = {}
        if read_sec is not None:
            entry["read_seconds"] = round(read_sec, 6)
        if compute_sec is not None:
            entry["compute_seconds"] = round(compute_sec, 6)
        if stage_times:
            entry["stage_seconds"] = {k: round(v, 6) for k, v in stage_times.items()}
        try:
            # pid-suffixed temp: concurrent workers (or a resumed incarnation
            # racing a straggler) never clobber each other's in-flight writes
            tmp = out_path.parent / (out_path.name + f".tmp{os.getpid()}")
            tmp.write_bytes(blob)
            os.replace(tmp, out_path)  # atomic publish
            (out_dir / (names[path] + ".done")).touch()
        except OSError as e:
            entry["error"] = str(e)
            entry["write_seconds"] = round(time.perf_counter() - w0, 6)
            return entry
        entry["out"] = out_path.name
        entry["bytes"] = len(blob)
        entry["in_bytes"] = in_size
        entry["write_seconds"] = round(time.perf_counter() - w0, 6)
        return entry

    def record_failure(path: pathlib.Path, e: Exception) -> None:
        nonlocal failed
        failed += 1
        manifest[str(path)] = {"error": str(e)}
        if verbose:
            print(f"{path.name}: FAILED ({e})")

    def read_one(path: pathlib.Path):
        """WAV read + parse; returns (path, wav|None, error|None, seconds).
        Runs inline or on the reader thread (no shared state touched)."""
        r0 = time.perf_counter()
        try:
            wav = wavio.read_wav(str(path))
            err = None
        except (SLAError, ValueError, OSError) as e:
            wav, err = None, e
        return (path, wav, err, time.perf_counter() - r0)

    def encode_pre_read(path: pathlib.Path, wav):
        """Single-file encode of an already-read WAV; returns (blob,
        stage_times) or (None, None) after recording the failure."""
        try:
            enc.set_wave_format(
                WaveFormat(wav.num_channels, wav.bits_per_sample, wav.sampling_rate)
            )
            enc.set_encode_parameter(preset_parameter(preset, wav.num_channels))
            return enc.encode_whole(wav.data), enc.stage_times
        except (SLAError, ValueError, OSError) as e:
            record_failure(path, e)
            return None, None

    todo: list[pathlib.Path] = []
    for path in mine:
        done = out_dir / (names[path] + ".done")
        if resume and done.exists():
            skipped += 1
            # record the already-published output so a resumed run's manifest
            # (and any merge over manifests) still covers every file
            out_path = out_dir / (names[path] + ".sla")
            entry: dict = {"out": out_path.name, "skipped": True}
            try:
                entry["bytes"] = out_path.stat().st_size
            except OSError:
                pass
            manifest[str(path)] = entry
        else:
            todo.append(path)

    step = max(int(filter_batch), 1)
    chunks = [todo[i : i + step] for i in range(0, len(todo), step)]
    compute_s = 0.0
    write_s = 0.0

    # overlap_io: reader thread prefetches chunk k+1's WAVs and a writer
    # thread publishes chunk k-1's blobs while chunk k encodes. Bounded
    # queues cap in-flight PCM/blob memory; `writer_results` is written
    # only by the writer thread and read only after join.
    writer_results: dict[str, dict] = {}
    wq = rq = None
    wthread = rthread = None
    if overlap_io and chunks:
        import queue as _queue
        import threading

        wq = _queue.Queue(maxsize=2)

        def _writer() -> None:
            while True:
                job = wq.get()
                if job is None:
                    return
                key, path, blob, st, rs, cs = job
                writer_results[key] = publish_one(path, blob, st, rs, cs)

        wthread = threading.Thread(target=_writer, name="sla-corpus-writer")
        wthread.start()

        rq = _queue.Queue(maxsize=1)
        stop_reading = threading.Event()

        def _reader() -> None:
            for chunk in chunks:
                if stop_reading.is_set():
                    return
                rq.put([read_one(p) for p in chunk])
            rq.put(None)

        rthread = threading.Thread(target=_reader, name="sla-corpus-reader")
        rthread.start()

    def chunk_reads():
        if rq is not None:
            while True:
                got = rq.get()
                if got is None:
                    return
                yield got
        else:
            for chunk in chunks:
                yield [read_one(p) for p in chunk]

    # try/finally: an exception that escapes the loop must still end both
    # threads (the reader blocks on its full queue, the writer waits for its
    # sentinel), or the process would hang instead of showing the traceback
    try:
        for results in chunk_reads():
            for path, _wav, err, _rs in results:
                if err is not None:
                    record_failure(path, err)
            good = [(p, w, rs) for (p, w, e, rs) in results if e is None]
            if not good:
                continue
            c0 = time.perf_counter()
            emit: list[tuple] = []  # (path, blob, stage_times, read_seconds)
            if len(good) == 1 or step == 1:
                for path, wav, rs in good:
                    blob, st = encode_pre_read(path, wav)
                    if blob is not None:
                        emit.append((path, blob, st, rs))
            else:
                jobs = [
                    (
                        WaveFormat(w.num_channels, w.bits_per_sample, w.sampling_rate),
                        preset_parameter(preset, w.num_channels),
                        w.data,
                    )
                    for _p, w, _rs in good
                ]
                try:
                    blobs = encode_whole_batch(jobs, config, device=device)
                    emit = [(p, blob, None, rs)
                            for (p, w, rs), blob in zip(good, blobs)]
                except (SLAError, ValueError, OSError):
                    # isolate the failing file: batch fell over, redo one by one
                    for path, wav, rs in good:
                        blob, st = encode_pre_read(path, wav)
                        if blob is not None:
                            emit.append((path, blob, st, rs))
            chunk_compute = time.perf_counter() - c0
            compute_s += chunk_compute
            per_file = chunk_compute / max(len(emit), 1)
            for path, blob, st, rs in emit:
                if wq is not None:
                    wq.put((str(path), path, blob, st, rs, per_file))
                else:
                    writer_results[str(path)] = publish_one(
                        path, blob, st, rs, per_file
                    )
    finally:
        if rthread is not None:
            stop_reading.set()
            while rthread.is_alive():  # unblock a put on the full queue
                try:
                    rq.get(timeout=0.05)
                except _queue.Empty:
                    pass
            rthread.join()
        if wq is not None:
            while wthread.is_alive():
                try:
                    wq.put(None, timeout=0.05)
                    break
                except _queue.Full:
                    pass
            wthread.join()

    for key, entry in writer_results.items():
        manifest[key] = entry
        write_s += entry.get("write_seconds", 0.0)
        if "error" in entry:
            failed += 1
        else:
            encoded += 1
            in_bytes += entry.get("in_bytes", 0)
            out_bytes += entry["bytes"]
            if verbose:
                print(f"{pathlib.Path(key).name}: "
                      f"{entry.get('in_bytes', 0)} -> {entry['bytes']}")

    result = CorpusResult(
        total_files=len(mine),
        encoded=encoded,
        skipped=skipped,
        failed=failed,
        in_bytes=in_bytes,
        out_bytes=out_bytes,
        seconds=time.time() - t0,
        compute_seconds=compute_s,
        write_seconds=write_s,
    )
    manifest_path = out_dir / f"manifest_{process_index}.json"
    tmp = out_dir / f"manifest_{process_index}.json.tmp{os.getpid()}"
    tmp.write_text(
        json.dumps({"result": dataclasses.asdict(result), "files": manifest}, indent=1)
    )
    os.replace(tmp, manifest_path)  # atomic: a killed worker never leaves torn JSON
    return result


def decode_corpus(
    files: list[str | pathlib.Path],
    out_dir: str | pathlib.Path,
    resume: bool = True,
    process_index: int | None = None,
    process_count: int | None = None,
    decoder_config: DecoderConfig | None = None,
    verbose: bool = False,
    verify_only: bool = False,
    overlap_writes: bool = True,
    device=None,
) -> CorpusResult:
    """Decode a .sla corpus into out_dir, one .wav per input — the decode
    twin of :func:`encode_corpus` (the reference decodes one file per
    invocation, src/main.c:172-275; this is its bulk mode).

    Same machinery as the encode side: round-robin process sharding, atomic
    ``<name>.wav.done`` resume markers (suffix-distinct from encode's
    ``.done`` so the two directions can share a directory), pid-suffixed
    temps swept on restart, per-process ``decode_manifest_<i>.json``.
    Verification is the decoder's own CRC gates (stream header + per-block,
    on by default in :class:`DecoderConfig`); a corrupt file is recorded in
    the manifest with its error and does not abort the run.

    ``verify_only=True`` decodes (full CRC + synthesis) without writing any
    WAV or resume marker — the pure-compute integrity sweep; ``resume`` is
    ignored. ``overlap_writes=True`` (default) runs WAV serialization +
    publish on a background writer thread so file I/O overlaps the next
    file's decode — outputs are byte-identical, completion order is
    irrelevant (each file publishes atomically under its own name). Every
    manifest entry records ``compute_seconds`` (read + decode) and, when
    written, ``write_seconds``; the result totals both so a compute
    regression can't hide inside I/O noise (BASELINE.md footnote 4)."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if process_index is None or process_count is None:
        process_index, process_count = _process_grid()

    all_paths = [pathlib.Path(f) for f in files]
    mine = shard_files(all_paths, process_index, process_count)
    t0 = time.time()
    decoded = skipped = failed = 0
    in_bytes = out_bytes = 0
    manifest: dict = {}

    dec = Decoder(decoder_config or DecoderConfig(), device=device)
    names = output_names(all_paths)

    for path in mine:
        for stale in out_dir.glob(_glob.escape(names[path] + ".wav.tmp") + "*"):
            try:
                stale.unlink()
            except OSError:
                pass
    for stale in out_dir.glob(f"decode_manifest_{process_index}.json.tmp*"):
        try:
            stale.unlink()
        except OSError:
            pass

    todo: list[pathlib.Path] = []
    for path in mine:
        done = out_dir / (names[path] + ".wav.done")
        if resume and not verify_only and done.exists():
            skipped += 1
            out_path = out_dir / (names[path] + ".wav")
            entry: dict = {"out": out_path.name, "skipped": True}
            try:
                entry["bytes"] = out_path.stat().st_size
            except OSError:
                pass
            manifest[str(path)] = entry
        else:
            todo.append(path)

    compute_s = 0.0
    write_s = 0.0

    def write_one(path: pathlib.Path, header, pcm) -> dict:
        """WAV serialize + atomic publish + resume marker; returns the
        fields to merge into the file's manifest entry (or its error).
        Runs inline or on the writer thread — it touches only its own
        temp/output names, so decode of the NEXT file can proceed."""
        w0 = time.perf_counter()
        out_path = out_dir / (names[path] + ".wav")
        try:
            wf = header.wave_format
            body = wavio.serialize_wav(
                wavio.WavFile(wf.num_channels, wf.sampling_rate,
                              wf.bit_per_sample, pcm)
            )
            tmp = out_path.parent / (out_path.name + f".tmp{os.getpid()}")
            tmp.write_bytes(body)
            os.replace(tmp, out_path)  # atomic publish
            (out_dir / (names[path] + ".wav.done")).touch()
            return {"out": out_path.name, "bytes": len(body),
                    "write_seconds": round(time.perf_counter() - w0, 6)}
        except (OSError, ValueError) as e:
            return {"error": str(e),
                    "write_seconds": round(time.perf_counter() - w0, 6)}

    # single background writer: decode(file k+1) overlaps serialize+write of
    # file k. A bounded queue caps in-flight PCM buffers (each can be
    # hundreds of MB); results merge after join, so `manifest` and the
    # counters stay single-threaded.
    writer_results: dict[str, dict] = {}
    wq: "_queue.Queue | None" = None
    wthread = None
    if overlap_writes and not verify_only:
        import queue as _queue
        import threading

        wq = _queue.Queue(maxsize=2)

        def _writer() -> None:
            while True:
                job = wq.get()
                if job is None:
                    return
                key, path, header, pcm = job
                writer_results[key] = write_one(path, header, pcm)

        wthread = threading.Thread(target=_writer, name="sla-corpus-writer")
        wthread.start()

    for path in todo:
        c0 = time.perf_counter()
        try:
            blob = path.read_bytes()
            header, pcm = dec.decode_whole(blob)
        except (SLAError, ValueError, OSError) as e:
            failed += 1
            manifest[str(path)] = {"error": str(e)}
            if verbose:
                print(f"{path.name}: FAILED ({e})")
            continue
        dt = time.perf_counter() - c0
        compute_s += dt
        in_bytes += len(blob)
        entry = {
            "num_samples": int(header.num_samples),
            "compute_seconds": round(dt, 6),
        }
        if getattr(dec, "stage_times", None):
            entry["stage_seconds"] = {
                k: round(v, 6) for k, v in dec.stage_times.items()
            }
        manifest[str(path)] = entry
        if verify_only:
            decoded += 1
            entry["verified"] = True
            if verbose:
                print(f"{path.name}: verified ({len(blob)} bytes)")
            continue
        if wq is not None:
            wq.put((str(path), path, header, pcm))
        else:
            writer_results[str(path)] = write_one(path, header, pcm)

    if wq is not None:
        wq.put(None)
        wthread.join()

    for key, wres in writer_results.items():
        entry = manifest[key]
        entry.update(wres)
        write_s += wres.get("write_seconds", 0.0)
        if "error" in wres:
            failed += 1
        else:
            decoded += 1
            out_bytes += wres["bytes"]
            if verbose:
                print(f"{key}: -> {wres['bytes']}")

    result = CorpusResult(
        total_files=len(mine),
        encoded=decoded,
        skipped=skipped,
        failed=failed,
        in_bytes=in_bytes,
        out_bytes=out_bytes,
        seconds=time.time() - t0,
        compute_seconds=round(compute_s, 6),
        write_seconds=round(write_s, 6),
    )
    manifest_path = out_dir / f"decode_manifest_{process_index}.json"
    tmp = out_dir / f"decode_manifest_{process_index}.json.tmp{os.getpid()}"
    tmp.write_text(
        json.dumps({"result": dataclasses.asdict(result), "files": manifest}, indent=1)
    )
    os.replace(tmp, manifest_path)
    return result


def merge_manifests(out_dir: str | pathlib.Path, prefix: str = "manifest") -> dict:
    """Merge every per-process ``<prefix>_<i>.json`` in out_dir into one
    ``<prefix>.json`` covering the whole corpus (``prefix="decode_manifest"``
    merges the :func:`decode_corpus` side).

    Each process's shard is disjoint (``shard_files``), so file entries
    cannot conflict except when a killed worker's resumed run re-reports a
    file as ``skipped`` — the entry carrying real encode data wins. Totals
    are re-derived from the merged file map (a resumed process's
    ``skipped`` files were *encoded* by its earlier incarnation; summing
    per-process counters would double-count them)."""
    out_dir = pathlib.Path(out_dir)
    files: dict = {}
    processes = []
    for part in sorted(out_dir.glob(f"{prefix}_*.json")):
        if part.name == f"{prefix}.json":
            continue
        data = json.loads(part.read_text())
        processes.append({"manifest": part.name, "result": data.get("result", {})})
        for path, entry in data.get("files", {}).items():
            prev = files.get(path)
            if prev is None or (prev.get("skipped") and not entry.get("skipped")):
                files[path] = entry
    merged = {
        "total_files": len(files),
        "encoded": sum(1 for e in files.values() if "out" in e),
        "failed": sum(1 for e in files.values() if "error" in e),
        "out_bytes": sum(e.get("bytes", 0) for e in files.values() if "out" in e),
        "processes": processes,
        "files": files,
    }
    (out_dir / f"{prefix}.json").write_text(json.dumps(merged, indent=1))
    return merged
