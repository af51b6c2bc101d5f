"""Checkpointable streaming scans of genome-scale inputs.

The port's own copy of ``sassy_tpu/scan.py`` over the port's ``Searcher``
(tests/test_torch_surfaces.py holds their output files equal). The
reference is one-shot streaming with no persistence (SURVEY §5: no
checkpoint/resume exists there). For multi-hour scans (pattern
panels x whole genomes) this module adds shard-progress checkpointing: work
is split into (record, segment) units; completed units append their matches
to the output TSV and advance a JSON checkpoint, so a killed scan resumes
where it left off instead of rescanning.

Segmenting follows the engine's halo rule: a segment re-scans ``m + k``
chars of left context and owns only its own end positions, so per-segment
match sets concatenate exactly (search.rs:1018-1070 chunk-overlap rule at
file granularity).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
import numpy as np

from .io import fastx
from .profiles import as_bytes_array
from .search import Searcher

__all__ = ["GenomeScan", "ScanProgress"]


@dataclass
class ScanProgress:
    path: str
    unit: int = 0  # next (record, segment) unit index to process
    matches: int = 0
    #: output-file byte offset as of the last completed unit. A hard kill
    #: can leave a partially written unit in the output; resuming truncates
    #: back to this offset so interrupted + resumed output is byte-identical
    #: to an uninterrupted run.
    out_pos: int = 0
    #: optional extra consumer state saved with the checkpoint (the CLI
    #: stores its per-distance histogram here)
    hist: list | None = None
    #: invocation signature: resuming with different parameters (k,
    #: patterns, inputs, ...) would silently merge incompatible outputs,
    #: so consumers set this and check_sig() refuses a mismatch
    sig: str | None = None

    @staticmethod
    def load(path: str | None) -> "ScanProgress | None":
        if path is None:
            return None
        if os.path.exists(path):
            with open(path) as fh:
                d = json.load(fh)
            return ScanProgress(
                path, d["unit"], d["matches"],
                d.get("out_pos", 0), d.get("hist"), d.get("sig"),
            )
        return ScanProgress(path)

    def save(self) -> None:
        tmp = self.path + ".tmp"
        d = {"unit": self.unit, "matches": self.matches,
             "out_pos": self.out_pos}
        if self.hist is not None:
            d["hist"] = self.hist
        if self.sig is not None:
            d["sig"] = self.sig
        with open(tmp, "w") as fh:
            json.dump(d, fh)
        os.replace(tmp, self.path)

    def check_sig(self, sig: str) -> None:
        """Refuse to resume under different parameters; adopt ``sig`` on a
        fresh checkpoint."""
        if self.unit > 0 and self.sig is not None and self.sig != sig:
            raise ValueError(
                f"checkpoint {self.path!r} was written by a run with "
                f"different parameters ({self.sig!r} != {sig!r}); delete it "
                "or rerun with the original parameters"
            )
        self.sig = sig

    def reopen_output(self, out_path: str):
        """Open the output file for this progress state: truncate to the
        last checkpointed offset and append (crash-safe resume), or start
        fresh when nothing has completed yet."""
        if self.unit > 0 and os.path.exists(out_path):
            fh = open(out_path, "r+")
            fh.truncate(self.out_pos)
            fh.seek(self.out_pos)
            return fh, True
        return open(out_path, "w"), False


class GenomeScan:
    """Scan a fastx file with a pattern panel, checkpointing per segment.

    Args:
        searcher: configured :class:`Searcher` (rc, filters, trace, ...),
            on the device the scan runs on. Each segment is a fresh view of
            its record, so the single engine's prepared texts of finished
            segments are freed as the views die.
        segment_chars: max chars per device work unit; records larger than
            this are cut into halo-overlapped segments.
        checkpoint: JSON progress file (None disables persistence).
    """

    def __init__(
        self,
        searcher: Searcher,
        segment_chars: int = 1 << 26,
        checkpoint: str | None = None,
    ):
        self.searcher = searcher
        self.segment_chars = segment_chars
        self.checkpoint = checkpoint

    def _units(self, records, m: int, k: int):
        """Yield (unit_idx, record, seg_start, seg_end, halo_start)."""
        unit = 0
        halo = m + k
        for rec in records:
            n = len(rec.seq)
            if n <= self.segment_chars:
                yield unit, rec, 0, n, 0
                unit += 1
                continue
            start = 0
            while start < n:
                end = min(start + self.segment_chars, n)
                hs = max(0, start - halo)
                yield unit, rec, start, end, hs
                unit += 1
                start = end

    def scan(self, fastx_path: str, patterns, k: int, out_tsv: str) -> int:
        """Scan all records; returns total matches. Appends TSV rows
        ``pat_idx text_id cost strand start end`` per match and advances the
        checkpoint after each completed unit."""
        pats = [as_bytes_array(p) for p in patterns]
        m = max(len(p) for p in pats)
        prog = ScanProgress.load(self.checkpoint) or ScanProgress("")
        total = prog.matches
        out, resumed = prog.reopen_output(out_tsv)
        with out:
            if not resumed:
                out.write("pat_idx\ttext_id\tcost\tstrand\tstart\tend\n")
            for unit, rec, s0, s1, hs in self._units(
                fastx.read_fastx(fastx_path), m, k
            ):
                if unit < prog.unit:
                    continue  # already done (resume)
                seg = np.frombuffer(rec.seq, dtype=np.uint8)[hs:s1]
                matches = self.searcher.search(pats[0], seg, k) if len(
                    pats
                ) == 1 else self.searcher.search_patterns(pats, seg, k)
                kept = 0
                for mt in matches:
                    end_abs = mt.text_end + hs
                    # owner-computes: a segment owns end positions in
                    # (s0, s1]; the previous segment reported the halo's.
                    if not (s0 < end_abs <= s1):
                        continue
                    out.write(
                        f"{mt.pattern_idx}\t{rec.rid}\t{mt.cost}\t{mt.strand}"
                        f"\t{mt.text_start + hs}\t{end_abs}\n"
                    )
                    kept += 1
                out.flush()
                total += kept
                if self.checkpoint:
                    prog.path = self.checkpoint
                    prog.unit = unit + 1
                    prog.matches = total
                    prog.out_pos = out.tell()
                    prog.save()
        return total
