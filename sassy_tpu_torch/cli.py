"""Command-line interface of the port: grep / agrep / search / filter /
crispr / test, on the GPU (``--device cuda``, the default) or the CPU.

    python -m sassy_tpu_torch [--device cuda|cpu] search -p ACGT -k 1 reads.fa

The port's own copy of ``sassy_tpu/cli.py``, a behavioural port of the
reference CLI (sassy bin/{main,grep,crispr}.rs): same subcommands, flags,
TSV schema (README.md:211-253), pretty-printed grep output on stderr,
per-distance match histogram, PAM-filtered CRISPR search, and `--sam`
text-direction output, byte for byte as the JAX package's CLI prints them
(tests/test_torch_cli.py). search / grep / filter cut the records into
units, text batches of ``--batch-bytes`` (grep.rs:476-582's work items),
and search whole units up to ``GROUP_BYTES`` of records at a time: one
batched call a pattern batch over the group, the next group dispatched
before this one's output is written. Output order, and the ``--resume``
checkpoint after each unit, are those of a unit at a time.

``--device`` (or ``SASSY_DEVICE``) takes the place of the JAX CLI's
``--platform``; with "cuda" and no CUDA device the CLI exits non-zero and
never runs on the CPU instead. The JAX CLI's ``--engine`` names JAX
engines and has no counterpart here.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from operator import attrgetter

import numpy as np
import torch

from .io import fastx
from .matchrec import Match, Strand
from .pretty_print import (
    PrettyPrintDirection,
    PrettyPrintStyle,
    pretty_print,
)
from .profiles import Ascii, Iupac, as_bytes_array, get_profile
from .search import Searcher

#: record bytes of one grouped call of search / grep / filter: whole units
#: (text batches of --batch-bytes) up to this size, as crispr's batches
GROUP_BYTES = 32 << 20

TSV_HEADER = "pat_id\ttext_id\tcost\tstrand\tstart\tend\tmatch_region\tcigar\n"


def _bold(s):
    return f"\x1b[1m{s}\x1b[0m"


def _cyan_bold(s):
    return f"\x1b[1;36m{s}\x1b[0m"


# ---------------------------------------------------------------------------
# argument plumbing


def _add_base_args(p: argparse.ArgumentParser) -> None:
    g = p.add_mutually_exclusive_group()
    g.add_argument("-p", "--pattern", help="Pattern to search for")
    g.add_argument(
        "-l", "--pattern-file", help="File with one pattern per line"
    )
    g.add_argument(
        "-f", "--pattern-fasta", help="FASTA file of patterns"
    )
    p.add_argument(
        "--pattern-batch-size",
        type=int,
        default=fastx.DEFAULT_BATCH_PATTERNS,
        help="Patterns per batch (default 64)",
    )
    p.add_argument(
        "-k", type=int, required=True,
        help="Report matches up to (and including) this distance",
    )
    p.add_argument(
        "-a", "--alphabet", choices=["dna", "iupac"], default="iupac",
        help="Alphabet (default iupac; use agrep for ascii)",
    )
    p.add_argument(
        "--overhang", type=float, default=None,
        help="Cost per char of overhang alignment in [0,1]",
    )
    p.add_argument("--no-rc", action="store_true", help="Disable RC search")
    p.add_argument(
        "--max-n-frac", type=float, default=0.2,
        help="Max fraction of N bases in the matched region (default 0.2)",
    )
    p.add_argument(
        "--v2", action="store_true",
        help="Use the encoded-pattern batch path (results identical here)",
    )
    p.add_argument("-j", "--threads", type=int, default=None,
                   help="Accepted for compatibility (the device batches)")
    p.add_argument("-v", "--invert", action="store_true",
                   help="Only report non-matching records (filter output)")
    p.add_argument("--sam", action="store_true",
                   help="SAM-compatible output (text-direction region/cigar)")
    p.add_argument(
        "--batch-bytes", type=int, default=fastx.DEFAULT_BATCH_BYTES,
        help="Text bytes per device dispatch batch",
    )
    p.add_argument(
        "--resume", default=None, metavar="PROGRESS_JSON",
        help="Checkpoint file: save progress after each text batch and, "
             "if it exists, resume an interrupted run (requires the TSV "
             "output to be a file). Interrupted+resumed output is "
             "byte-identical to an uninterrupted run.",
    )
    p.add_argument("paths", nargs="*", help="Input fastx files (may be .gz)")


def get_patterns(args) -> tuple[list[str], list[bytes]]:
    """(ids, seqs) per grep.rs:624-661."""
    if args.pattern:
        return ["pattern"], [args.pattern.encode()]
    if args.pattern_file:
        ids, seqs = [], []
        with open(args.pattern_file) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    seqs.append(line.encode())
                    ids.append(str(len(seqs)))
        return ids, seqs
    if args.pattern_fasta:
        ids, seqs = [], []
        for rec in fastx.read_fastx(args.pattern_fasta):
            ids.append(rec.rid)
            seqs.append(rec.seq)
        return ids, seqs
    sys.exit("No --pattern, --pattern-file, or --pattern-fasta provided!")


def _stable_digest(seqs) -> str:
    """Process-stable digest of a sequence list (hash() is salted)."""
    import hashlib

    h = hashlib.sha1()
    for s in seqs:
        h.update(bytes(s))
        h.update(b"\x00")
    return h.hexdigest()[:16]


def _open_out(path: str | None):
    if path is None:
        return None, False
    if path in ("", "-"):
        return sys.stdout, True
    return open(path, "w"), False


def _format_match_region(profile, slice_, strand: Strand, sam: bool) -> str:
    if strand is Strand.RC and not sam:
        return bytes(profile.reverse_complement(slice_)).decode(errors="replace")
    return bytes(bytearray(slice_)).decode(errors="replace")


def _format_cigar(m: Match, sam: bool) -> str:
    if m.strand is Strand.RC and sam:
        return m.cigar.reversed().to_string()
    return m.cigar.to_string()


def print_statistics(hist: list[int], out=None) -> None:
    if out is None:
        out = sys.stderr
    total = sum(hist)
    print(f"\nStatistics: total {_bold(total)}", file=out)
    digits = len(str(max(hist) if hist else 0))
    print("dist: " + " ".join(_bold(str(i).rjust(digits)) for i in range(len(hist))),
          file=out)
    print("cnt:  " + " ".join(_bold(str(c).rjust(digits)) for c in hist), file=out)


# ---------------------------------------------------------------------------
# grep / search / filter (one engine, three frontends; grep.rs README:153-155)


def run_grep_family(args, grep: bool, search_out, filter_out) -> int:
    if args.invert and filter_out is None:
        print("Warning: --invert/-v has no effect without --filter",
              file=sys.stderr)
    paths = args.paths or [""]
    pids, pseqs = get_patterns(args)
    if not pseqs:
        sys.exit("No pattern sequences found")

    profile = get_profile(args.alphabet)
    rc = not args.no_rc
    searcher = Searcher(profile, rc=rc, alpha=args.overhang,
                        device=args.device)
    if args.alphabet == "iupac":
        searcher.set_max_n_frac(args.max_n_frac)

    resume = getattr(args, "resume", None)
    prog = None
    if resume is not None:
        from .scan import ScanProgress

        if search_out in (None, "", "-"):
            sys.exit("--resume requires TSV output to a file "
                     "(search -o FILE / grep --search FILE)")
        prog = ScanProgress.load(resume)
        try:
            prog.check_sig(
                f"k={args.k} rc={rc} alpha={args.overhang} "
                f"nfrac={args.max_n_frac} v2={args.v2} sam={args.sam} "
                f"bb={args.batch_bytes} pb={args.pattern_batch_size} "
                f"pats={len(pseqs)}:{_stable_digest(pseqs)} "
                f"paths={paths}"
            )
        except ValueError as e:
            sys.exit(str(e))
        search_fh, resumed = prog.reopen_output(search_out)
    else:
        search_fh, _ = _open_out(search_out)
        resumed = False
    filter_fh, _ = _open_out(filter_out)
    if search_fh is not None and not resumed:
        search_fh.write(TSV_HEADER)

    hist = (list(prog.hist) if prog is not None and prog.hist
            else [0] * (args.k + 1))
    pb = args.pattern_batch_size
    pattern_batches = [(off, pseqs[off : off + pb])
                       for off in range(0, len(pseqs), pb)]
    # fault injection for the resume tests: die (before checkpointing)
    # once this many text-batch units have written their output
    crash_after = int(os.environ.get("SASSY_CRASH_AFTER_UNIT", "-1"))

    def dispatch(group):
        """One batched call a pattern batch over the group's records, all
        in flight on the dispatch thread, over one text set (one upload
        and one pack a strand for all of them, dropped with the calls once
        the group is settled); their ``finish()``es."""
        texts = [r.cached for _, _, recs in group for r in recs]
        ts = searcher._text_set(texts)
        fins = []
        for _, pats in pattern_batches:
            if args.v2 and len({len(p) for p in pats}) == 1:
                fins.append(searcher._search_encoded_v2_async(
                    searcher.encode_patterns(pats), texts, args.k,
                    textset=ts))
            else:
                fins.append(searcher._search_many_batched_async(
                    [as_bytes_array(p) for p in pats], texts, args.k, False,
                    rc, textset=ts))
        return fins

    def settle(group, fins):
        """The group's output, record by record in unit order, each
        record's matches pattern batch by pattern batch (in a batch, the
        Searcher's order); a checkpoint after each unit."""
        per_text = [[] for _, _, recs in group for _ in recs]
        for (off, _), fin in zip(pattern_batches, fins):
            for m in fin():
                per_text[m.text_idx].append((off + m.pattern_idx, m))
        ti = 0
        for unit, path, recs in group:
            for rec in recs:
                matches = per_text[ti]
                ti += 1
                for _, m in matches:
                    hist[m.cost] += 1
                _emit_record(args, profile, path, rec, matches, pids, pseqs,
                             grep, search_fh, filter_fh)
            if prog is not None:
                search_fh.flush()
                if 0 <= crash_after <= unit:
                    raise SystemExit(130)
                prog.unit = unit + 1
                prog.matches = sum(hist)
                prog.hist = hist
                prog.out_pos = search_fh.tell()
                prog.save()

    # the reader thread parses group N+1 while group N scans, and group
    # N+1 is dispatched before group N's matches are finished and written
    groups = _groups(fastx.iter_batches(paths, pids, pseqs,
                                        batch_bytes=args.batch_bytes,
                                        batch_patterns=pb, rc=rc),
                     prog.unit if prog is not None else 0)
    inflight = None
    for group in fastx.prefetch(groups):
        fins = dispatch(group)
        if inflight is not None:
            settle(*inflight)
        inflight = (group, fins)
    if inflight is not None:
        settle(*inflight)
    print_statistics(hist)
    for fh in (search_fh, filter_fh):
        if fh is not None and fh is not sys.stdout:
            fh.close()
    return 0


def _groups(items, start: int = 0):
    """The units of ``fastx.iter_batches``' work items (a text batch, as
    the items of its first pattern batch give it), from unit ``start`` on
    (the earlier ones are done), as groups of (unit, path, records): as
    many whole units as hold at most ``GROUP_BYTES`` of records, and at
    least one."""
    group, size = [], 0
    units = (w for w in items if w.pattern_offset == 0)
    for unit, w in enumerate(units):
        if unit < start:
            continue
        n = sum(len(r.seq) for r in w.records)
        if group and size + n > GROUP_BYTES:
            yield group
            group, size = [], 0
        group.append((unit, w.path, w.records))
        size += n
    if group:
        yield group


def _emit_record(
    args, profile, path, rec, matches, pids, pseqs, grep, search_fh, filter_fh
):
    matches.sort(key=lambda pm: pm[1].text_start)
    if filter_fh is not None:
        if bool(matches) != args.invert:
            fastx.write_record_text(filter_fh, rec)
    if grep and matches:
        print(_bold(f"{_cyan_bold(path or '-')}>{_bold(rec.rid)}"), file=sys.stderr)
        for pi, m in matches:
            s = pretty_print(
                m, pids[pi], pseqs[pi], rec.seq,
                PrettyPrintDirection.TEXT, 20, PrettyPrintStyle.FULL,
            )
            print(s, file=sys.stderr)
    if search_fh is not None:
        seq = np.frombuffer(rec.seq, dtype=np.uint8)
        for pi, m in matches:
            region = _format_match_region(
                profile, seq[m.text_start : m.text_end], m.strand, args.sam
            )
            search_fh.write(
                f"{pids[pi]}\t{rec.rid}\t{m.cost}\t{m.strand}\t"
                f"{m.text_start}\t{m.text_end}\t{region}\t"
                f"{_format_cigar(m, args.sam)}\n"
            )


# ---------------------------------------------------------------------------
# agrep: line-based ascii grep (grep.rs:133-147, 198-307)


def run_agrep(args) -> int:
    pattern = args.pattern.encode()
    searcher = Searcher(Ascii(case_sensitive=True), rc=False,
                        device=args.device)
    hist = [0] * (args.k + 1)
    # all files in ONE batched dispatch (each dispatch costs a device
    # round trip); output stays grouped per file in argument order
    names = []
    texts = []
    for path in args.paths or [""]:
        if path in ("", "-"):
            texts.append(sys.stdin.buffer.read())
        else:
            with open(path, "rb") as fh:
                texts.append(fh.read())
        names.append(path)
    per_file: dict[int, list] = {}
    for m in searcher.search_many([pattern], texts, args.k):
        per_file.setdefault(m.text_idx, []).append(m)
    for ti, path in enumerate(names):
        matches = per_file.get(ti)
        if not matches:
            continue
        matches.sort(key=lambda m: m.text_start)
        print(_bold(f"{_cyan_bold(path or '-')}:"), file=sys.stderr)
        for m in matches:
            hist[m.cost] += 1
            s = pretty_print(
                m, "", pattern, texts[ti],
                PrettyPrintDirection.TEXT, args.context, PrettyPrintStyle.LINE,
            )
            print(s, file=sys.stderr)
            if args.context > 0:
                print("\x1b[36m---\x1b[0m", file=sys.stderr)
    print_statistics(hist)
    return 0


# ---------------------------------------------------------------------------
# crispr (bin/crispr.rs)


class _PamFilter:
    """crispr's PAM check on a candidate's end: the ``pam`` bytes (their
    complement on RC) must match, by the profile's own test, the first
    ``len(pam)`` of the last ``pam_length`` bytes before the end (``pam``
    is shorter than ``pam_length`` only for a guide that is). Called as a
    ``filter_fn`` with ``(pattern, text[:end], strand)``, or through
    ``mask_ends``, which the Searcher's finish uses: all ends of one text
    in one call."""

    def __init__(self, prof, pam: np.ndarray, pam_compl: np.ndarray,
                 pam_length: int):
        self.prof = prof
        self.ref = {Strand.FWD: pam, Strand.RC: pam_compl}
        self.pam_length = pam_length

    def __call__(self, _pattern, text_up_to_end, strand) -> bool:
        return bool(self.mask_ends(text_up_to_end,
                                   np.array([len(text_up_to_end)]),
                                   strand)[0])

    def mask_ends(self, text, ends, strand) -> np.ndarray:
        """A mask over ``ends`` (positions in ``text``, clipped to its
        length): False where fewer than ``pam_length`` bytes precede."""
        ref, pl = self.ref[strand], self.pam_length
        e = np.minimum(np.asarray(ends, np.int64), len(text))
        if not len(text):  # an empty tail: nothing to compare
            return e >= pl
        # the tail text[:e][-pl:] from its start s, compared as far as it
        # and the PAM both reach
        s = e - pl if pl > 0 else np.minimum(-pl, e)
        pos = s[:, None] + np.arange(len(ref))
        tail = np.asarray(text)[np.clip(pos, 0, len(text) - 1)]
        same = self.prof.is_match_bytes(tail, ref) | (pos >= e[:, None])
        return (e >= pl) & same.all(1)


def run_crispr(args) -> int:
    with open(args.guide) as fh:
        guides = [line.strip().encode() for line in fh if line.strip()]
    print(f"[GUIDES] Found {len(guides)} guides")
    if not guides:
        return 0
    if not (0.0 <= args.max_n_frac <= 1.0):
        sys.exit("[N-chars] Error: max_n_frac must be between 0 and 1.0")

    pam = guides[0][-args.pam_length :]
    for g in guides:
        if g[-args.pam_length :] != pam:
            sys.exit(
                "[PAM] One of the guide sequences has a PAM different than "
                "the provided PAM"
            )
    print(f"[PAM] Sequence: [{pam.decode()}]")
    print(f"[PAM] PAM used to filter: {pam.decode()}")
    print(f"[PAM] Edits in PAM are allowed: {args.allow_pam_edits}")
    print(f"[N-chars] Allowing up to {args.max_n_frac * 100:.1f}% N characters")

    prof = Iupac()
    pam_compl = np.frombuffer(prof.complement(pam), dtype=np.uint8)
    pam_arr = np.frombuffer(pam, dtype=np.uint8)

    prog = None
    if args.resume is not None:
        from .scan import ScanProgress

        if not args.output:
            sys.exit("--resume requires -o FILE")
        prog = ScanProgress.load(args.resume)
        try:
            prog.check_sig(
                f"k={args.k} rc={not args.no_rc} nfrac={args.max_n_frac} "
                f"pam={args.pam_length}:{args.allow_pam_edits} "
                f"bb={args.batch_bytes} path={args.path} "
                f"guides={len(guides)}:{_stable_digest(guides)}"
            )
        except ValueError as e:
            sys.exit(str(e))
        out, resumed = prog.reopen_output(args.output)
    else:
        out = open(args.output, "w") if args.output else sys.stdout
        resumed = False
    if not resumed:
        out.write(
            "guide\ttext_id\tcost\tstrand\tstart\tend\tmatch_region\tcigar\n"
        )

    searcher = Searcher(
        prof, rc=not args.no_rc, device=args.device
    ).with_max_n_frac(args.max_n_frac)

    filter_fn = _PamFilter(prof, pam_arr, pam_compl, args.pam_length)

    total = prog.matches if prog is not None else 0
    t0 = time.perf_counter()
    # all guides x a batch of records in ONE batched dispatch (the
    # reference instead threads over records, crispr.rs:188-261); the PAM
    # filter applies per candidate end position, after the batched scan.
    # 32 MiB batches: genome-scale contig sets then qualify for the
    # TextSet device-assembly path (one raw upload serves both strands),
    # and read-scale files still amortize the dispatch round trip
    batch_bytes = args.batch_bytes
    guide_strs = [g.decode() for g in guides]

    def dispatch(recs):
        texts = [r.seq for r in recs]
        return searcher.search_many_with_fn_async(
            guides, texts, args.k, True,
            None if args.allow_pam_edits else filter_fn,
        )

    def write_out(recs, matches):
        nonlocal total
        # record, then guide; a (guide, record) cell's matches in the
        # Searcher's order (a stable sort)
        seqs = [np.frombuffer(rec.seq, dtype=np.uint8) for rec in recs]
        for m in sorted(matches, key=attrgetter("text_idx", "pattern_idx")):
            total += 1
            region = _format_match_region(
                prof, seqs[m.text_idx][m.text_start : m.text_end], m.strand,
                False
            )
            out.write(
                f"{guide_strs[m.pattern_idx]}\t{recs[m.text_idx].rid}\t"
                f"{m.cost}\t{m.strand}\t{m.text_start}\t{m.text_end}\t"
                f"{region}\t{m.cigar.to_string()}\n"
            )

    def record_batches():
        pending: list = []
        pending_bytes = 0
        for rec in fastx.read_fastx(args.path):
            pending.append(rec)
            pending_bytes += len(rec.seq)
            if pending_bytes >= batch_bytes:
                yield pending
                pending, pending_bytes = [], 0
        if pending:
            yield pending

    crash_after = int(os.environ.get("SASSY_CRASH_AFTER_UNIT", "-1"))

    def settle(unit, recs, finish):
        write_out(recs, finish())
        if prog is not None:
            out.flush()
            if 0 <= crash_after <= unit:
                raise SystemExit(130)
            prog.unit = unit + 1
            prog.matches = total
            prog.out_pos = out.tell()
            prog.save()

    # double pipeline: the reader thread parses record batch N+1 while
    # batch N scans, and batch N+1's device scan is dispatched before
    # batch N's results are fetched/postprocessed/written
    inflight = None
    for unit, recs in enumerate(fastx.prefetch(record_batches())):
        if prog is not None and unit < prog.unit:
            continue
        fin = dispatch(recs)
        if inflight is not None:
            settle(*inflight)
        inflight = (unit, recs, fin)
    if inflight is not None:
        settle(*inflight)
    print("\nSummary")
    print(f"  Total targets found:   {total}")
    print(f"  Time taken: {time.perf_counter() - t0:.3f}s")
    if out is not sys.stdout:
        out.close()
    return 0


# ---------------------------------------------------------------------------
# test: diagnostics (reference lib.rs:187-281, `sassy test`)


def run_test(args) -> int:
    from .diagnostics import self_test

    info = self_test(100_000, verbose=False, device=args.device)
    for key, val in info.items():
        if key != "throughput_gbps":
            print(f"{key + ':':<14}{val}")
    print(f"{'throughput:':<14}{info['throughput_gbps']:.3f} GB/s "
          "(23bp, 100kb, k=1)")
    return 0


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    try:
        return _main(argv)
    except (BrokenPipeError, ValueError) as e:
        # downstream pager/head closed the pipe (e.g. `sassy-tpu-torch
        # search ... | head`: BrokenPipeError) or stdout itself (a write to
        # a closed file: ValueError): exit quietly like grep does, not with
        # a traceback. Any other ValueError is the caller's to see.
        if isinstance(e, ValueError) and not sys.stdout.closed:
            raise
        # Reopen stdout on devnull so the interpreter's shutdown flush of
        # the broken pipe does not raise a second time.
        try:
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        except (OSError, ValueError):
            pass
        return 141  # 128 + SIGPIPE, the conventional shell status


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="sassy-tpu-torch",
        description="Approximate string matching on an NVIDIA GPU "
                    "(PyTorch and CUDA)",
    )
    ap.add_argument(
        "--device", default=os.environ.get("SASSY_DEVICE", "cuda"),
        choices=["cuda", "cpu"],
        help="Device to search on (default cuda; also settable via "
             "SASSY_DEVICE). 'cpu' runs the kernels' plain PyTorch versions; "
             "'cuda' without a CUDA device exits with an error.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("grep", help="Search and pretty-print matches")
    _add_base_args(g)
    g.add_argument("-C", "--context", type=int, default=20)
    g.add_argument("--search", "--matches", nargs="?", const="-", default=None,
                   help="TSV output file ('-' or empty for stdout)")
    g.add_argument("--filter", nargs="?", const="-", default=None,
                   help="Filtered records output file")

    a = sub.add_parser("agrep", help="Line-based ascii grep")
    a.add_argument("pattern")
    a.add_argument("k", type=int)
    a.add_argument("-C", "--context", type=int, default=0)
    a.add_argument("paths", nargs="*")

    s = sub.add_parser("search", help="Search, TSV to stdout")
    _add_base_args(s)
    s.add_argument("--filter", nargs="?", const="-", default=None)
    s.add_argument("-o", "--output", default="-",
                   help="TSV output file (default stdout)")

    f = sub.add_parser("filter", help="Filter matching records to stdout")
    _add_base_args(f)
    f.add_argument("--search", "--matches", nargs="?", const="-", default=None)

    c = sub.add_parser("crispr", help="CRISPR guide search with PAM filter")
    c.add_argument("-g", "--guide", required=True,
                   help="File with guide sequences (including PAM)")
    c.add_argument("-k", type=int, required=True)
    c.add_argument("-o", "--output", default=None)
    c.add_argument("--max-n-frac", type=float, required=True)
    c.add_argument("-j", "--threads", type=int, default=None)
    c.add_argument("--pam-length", type=int, default=3)
    c.add_argument("--allow-pam-edits", action="store_true")
    c.add_argument("--no-rc", action="store_true")
    c.add_argument("--batch-bytes", type=int, default=32 << 20,
                   help="Record bytes per device dispatch batch")
    c.add_argument("--resume", default=None, metavar="PROGRESS_JSON",
                   help="Checkpoint file: save progress per record batch "
                        "and resume an interrupted run (requires -o FILE)")
    c.add_argument("path")

    sub.add_parser("test", help="Device/feature diagnostics + throughput")

    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("sassy-tpu-torch: --device cuda, but no CUDA device is "
                 "available; pass --device cpu (or SASSY_DEVICE=cpu) to run "
                 "on the CPU")
    if args.cmd == "grep":
        return run_grep_family(args, True, args.search, args.filter)
    if args.cmd == "search":
        return run_grep_family(args, False, args.output, args.filter)
    if args.cmd == "filter":
        return run_grep_family(args, False, args.search, "-")
    if args.cmd == "agrep":
        return run_agrep(args)
    if args.cmd == "crispr":
        return run_crispr(args)
    if args.cmd == "test":
        return run_test(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
