"""FASTA/FASTQ reading, writing, and work batching.

The port's own copy of ``sassy_tpu/io/fastx.py`` (the port imports nothing
of the JAX package; tests/test_torch_surfaces.py holds the two equal).
Mirrors the reference CLI's input layer (sassy bin/input_iterator.rs):
records are streamed from fasta/fastq files (gzip transparently), grouped
into ~1 MiB text batches and <=64-pattern batches, and every text batch is
paired with every pattern batch (input_iterator.rs:110,188-204).

Each record is wrapped in a CachedRev after batching, as the reference
does (input_iterator.rs:131,178-182), but without a reversed copy: the
Searcher reads the reverse strand from the forward bytes.
"""

from __future__ import annotations

import gzip
import io
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

from ..search import CachedRev

DEFAULT_BATCH_BYTES = 1 << 20  # input_iterator.rs:7
DEFAULT_BATCH_PATTERNS = 64  # input_iterator.rs:9


@dataclass
class Record:
    rid: str
    seq: bytes
    qual: bytes | None = None
    #: populated by the batching layer for RC searches
    cached: CachedRev | None = None


def _open(path: str):
    """Open a fastx path; '' or '-' means stdin; .gz transparently."""
    if path in ("", "-"):
        data = sys.stdin.buffer
        # peek for gzip magic
        head = data.peek(2)[:2] if hasattr(data, "peek") else b""
        if head == b"\x1f\x8b":
            return gzip.open(data, "rb")
        return data
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def parse_fastx(fh) -> Iterator[Record]:
    """Parse FASTA or FASTQ from a binary file handle (auto-detected)."""
    buf = io.BufferedReader(fh) if not isinstance(fh, io.BufferedReader) else fh
    first = buf.peek(1)[:1]
    if not first:
        return
    if first == b">":
        yield from _parse_fasta(buf)
    elif first == b"@":
        yield from _parse_fastq(buf)
    else:
        raise ValueError(f"not a fasta/fastq stream (starts with {first!r})")


def _parse_fasta(fh) -> Iterator[Record]:
    rid = None
    chunks: list[bytes] = []
    for line in fh:
        line = line.rstrip(b"\r\n")
        if line.startswith(b">"):
            if rid is not None:
                yield Record(rid, b"".join(chunks))
            rid = line[1:].split()[0].decode() if len(line) > 1 else ""
            chunks = []
        else:
            chunks.append(line)
    if rid is not None:
        yield Record(rid, b"".join(chunks))


def _parse_fastq(fh) -> Iterator[Record]:
    while True:
        header = fh.readline()
        if not header:
            return
        header = header.rstrip(b"\r\n")
        if not header:
            continue
        if not header.startswith(b"@"):
            raise ValueError(f"bad fastq header: {header!r}")
        seq = fh.readline().rstrip(b"\r\n")
        plus = fh.readline()
        if not plus.startswith(b"+"):
            raise ValueError("bad fastq separator")
        qual = fh.readline().rstrip(b"\r\n")
        rid = header[1:].split()[0].decode() if len(header) > 1 else ""
        yield Record(rid, seq, qual)


# ---------------------------------------------------------------------------
# native reader (native/fastxio.cc via ctypes) with pure-Python fallback.
# Opt-in via SASSY_NATIVE_FASTX=1: on this host CPython's C-level line
# iteration parses plain fasta at ~1.2 GB/s, slightly ahead of the native
# single-pass parser (copy/page-fault bound), and gzip is
# decompression-bound either way — so the Python path is the default.
# The source is read, never written: g++ builds it into
# build/sassy_tpu_torch/libfastxio_<hash>.so at first use (``gxx.build``),
# never ``make -C native``, which writes the JAX package's native/. When
# that build or its load fails, a line on stderr says the Python path runs.

FASTX_SOURCE = Path(__file__).resolve().parents[2] / "native" / "fastxio.cc"
FASTX_FLAGS = ("-O3", "-fPIC", "-shared")

_NATIVE = None  # unresolved; False = unavailable


def build_native() -> Path:
    """The native reader's library, compiled unless this source is built
    already. Raises ``RuntimeError`` when g++ is missing or fails."""
    from .. import gxx

    return gxx.build("libfastxio", [FASTX_SOURCE], FASTX_FLAGS, libs=["-lz"])


def _native_lib():
    global _NATIVE
    if _NATIVE is None:
        import ctypes
        import os

        if os.environ.get("SASSY_NATIVE_FASTX") != "1":
            _NATIVE = False
            return _NATIVE
        try:
            lib = ctypes.CDLL(str(build_native()))
        except (OSError, RuntimeError) as e:
            print(f"sassy_tpu_torch: SASSY_NATIVE_FASTX=1 but the native "
                  f"reader is unavailable, parsing in Python: {e}",
                  file=sys.stderr)
            _NATIVE = False
            return _NATIVE

        class Batch(ctypes.Structure):
            _fields_ = [
                ("seq", ctypes.POINTER(ctypes.c_uint8)),
                ("ids", ctypes.POINTER(ctypes.c_uint8)),
                ("qual", ctypes.POINTER(ctypes.c_uint8)),
                ("seq_off", ctypes.POINTER(ctypes.c_uint64)),
                ("id_off", ctypes.POINTER(ctypes.c_uint64)),
                ("n", ctypes.c_uint64),
                ("has_qual", ctypes.c_int),
            ]

        lib.fastx_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(Batch)]
        lib.fastx_read.restype = ctypes.c_int
        lib.fastx_free.argtypes = [ctypes.POINTER(Batch)]
        lib.fastx_free.restype = None
        _NATIVE = (lib, Batch)
    return _NATIVE


def _read_fastx_native(path: str) -> list[Record] | None:
    got = _native_lib()
    if not got:
        return None
    import ctypes

    lib, Batch = got
    b = Batch()
    rc = lib.fastx_read(path.encode(), ctypes.byref(b))
    if rc != 0:
        lib.fastx_free(ctypes.byref(b))
        raise ValueError(f"fastx parse error {rc} in {path!r}")
    try:
        n = int(b.n)
        if n == 0:
            return []
        seq_off = ctypes.cast(
            b.seq_off, ctypes.POINTER(ctypes.c_uint64 * (n + 1))
        ).contents
        id_off = ctypes.cast(
            b.id_off, ctypes.POINTER(ctypes.c_uint64 * (n + 1))
        ).contents
        seq_all = ctypes.string_at(b.seq, seq_off[n])
        ids_all = ctypes.string_at(b.ids, id_off[n])
        qual_all = ctypes.string_at(b.qual, seq_off[n]) if b.has_qual else None
        out = []
        for i in range(n):
            s0, s1 = seq_off[i], seq_off[i + 1]
            out.append(
                Record(
                    ids_all[id_off[i] : id_off[i + 1]].decode(errors="replace"),
                    seq_all[s0:s1],
                    qual_all[s0:s1] if qual_all is not None else None,
                )
            )
        return out
    finally:
        lib.fastx_free(ctypes.byref(b))


def read_fastx(path: str) -> Iterator[Record]:
    if path not in ("", "-"):
        recs = _read_fastx_native(path)
        if recs is not None:
            yield from recs
            return
    fh = _open(path)
    yield from parse_fastx(fh)


def write_record(out, rec: Record) -> None:
    """Write one record in its native format (fastq iff it has qualities)."""
    if rec.qual is not None:
        out.write(f"@{rec.rid}\n".encode())
        out.write(rec.seq + b"\n+\n" + rec.qual + b"\n")
    else:
        out.write(f">{rec.rid}\n".encode())
        out.write(rec.seq + b"\n")


def write_record_text(out, rec: Record) -> None:
    """write_record for text-mode streams (the CLI's stdout)."""
    seq = rec.seq.decode(errors="replace")
    if rec.qual is not None:
        out.write(f"@{rec.rid}\n{seq}\n+\n{rec.qual.decode(errors='replace')}\n")
    else:
        out.write(f">{rec.rid}\n{seq}\n")


class _PrefetchDone:
    pass


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Run ``it`` in a reader thread, buffering up to ``depth`` items.

    This is the IO/compute overlap of the reference CLI's threaded
    InputIterator (bin/input_iterator.rs:56-205 feeding grep.rs:476-582):
    while the device scans batch N, the reader thread parses/decompresses
    and packs batch N+1, so wall time approaches max(parse, scan) instead
    of their sum. Order-preserving; producer exceptions re-raise in the
    consumer; abandoning the iterator (break / close) stops the thread.
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def producer():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(_PrefetchDone)
        except BaseException as e:  # noqa: BLE001 - propagate to consumer
            if not stop.is_set():
                q.put(e)

    t = threading.Thread(target=producer, daemon=True, name="sassy-prefetch")
    t.start()
    try:
        while True:
            got = q.get()
            if got is _PrefetchDone:
                return
            if isinstance(got, BaseException):
                raise got
            yield got
    finally:
        stop.set()
        # drain one slot so a blocked producer can observe the stop flag
        try:
            q.get_nowait()
        except Exception:
            pass
        t.join(timeout=5)


@dataclass
class WorkItem:
    """One unit of work: a pattern batch x a text batch from one file."""

    path: str
    batch_id: int
    pattern_ids: list[str]
    patterns: list[bytes]
    pattern_offset: int
    records: list[Record]
    record_offset: int


def iter_batches(
    paths: list[str],
    pattern_ids: list[str],
    patterns: list[bytes],
    batch_bytes: int = DEFAULT_BATCH_BYTES,
    batch_patterns: int = DEFAULT_BATCH_PATTERNS,
    rc: bool = True,
) -> Iterator[WorkItem]:
    """Yield (pattern batch x text batch) work items in deterministic order.

    Batch ids are sequential so downstream consumers can reorder output
    deterministically (grep.rs:544-572). ``rc`` is kept for the
    reference's signature: no record is copied reversed either way.
    """
    del rc
    pattern_batches = [
        (i, pattern_ids[i : i + batch_patterns], patterns[i : i + batch_patterns])
        for i in range(0, len(patterns), batch_patterns)
    ]
    batch_id = 0
    for path in paths:
        record_offset = 0
        batch: list[Record] = []
        size = 0

        def flush(batch, record_offset):
            nonlocal batch_id
            for rec in batch:
                rec.cached = CachedRev(rec.seq, cache=False)
            for poff, pids, pats in pattern_batches:
                yield WorkItem(path, batch_id, pids, pats, poff, batch, record_offset)
                batch_id += 1

        for rec in read_fastx(path):
            batch.append(rec)
            size += len(rec.seq)
            if size >= batch_bytes:
                yield from flush(batch, record_offset)
                record_offset += len(batch)
                batch = []
                size = 0
        if batch:
            yield from flush(batch, record_offset)
