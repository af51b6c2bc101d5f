#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sassy_tpu_torch) on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an sm_90a GPU (H100) and
the CUDA toolkit.

The four search-path scan kernels (q1meta, q2meta, q1, q2) read each
tile's window straight from the packed planes through its descriptor
(myers_torch.Windows); every hold below hands kernel and plain version
the same descriptor, the plain version gathering the windows
(windows_plain). No search path on the card builds a window tensor:
counts() counts the calls of windows_plain (which build_windows and
TextSet.windows go through) since counts_zero(), and require() and
selected() fail a card run where that count is not 0. Phases 11, 15 and 20 also hold scan
launches captured from their main-path runs (captured_scans, hold_scan)
against their plain versions, timed beside their bounds. Phases:

1. the card (nvidia-smi), the toolchain (features()), and the build of
   the ten kernel sources (q1meta, q2meta, q1, q2, the qN family, the
   row-step ablations, the word-level and the position-level candidate
   selections, the text pack, the host finish's traceback) from
   sassy_tpu_torch/csrc/ with one nvcc call;
2. kernel vs plain: the q1meta scan kernel against its plain PyTorch
   version on the windows of a 1 GiB text (the H100 tile plan, a 23 bp
   pattern at k=3), bit for bit on all five outputs, for the pure, iupac
   and ascii eq and for a 100 bp pattern (M > 64); both timed; then the
   select_words kernel (the state chain inside) on the pure outputs as
   the engine runs it, with and without all_minima, against its plain
   version, the chain and the selection (every selection comparison: the
   columns equal after a lexsort, the word level's in the same order;
   both timed), and one call split by CUDA events into its counting and
   scanning launches, the host read and the writing launch; then the
   pack kernel against its plain version, bit for bit, for DNA, IUPAC
   and ascii with and without case folding, on that 1 GiB of ACGT and on
   1 GiB of every byte value, and for DNA on 2^31 + 33 bytes of every
   value (made on the card, freed after), each timed beside pack_bound;
   then the text set's pack kernel (batch.pack_set, as TextSet.planes
   calls it) against its plain version (pack_set_plain), bit for bit, on
   both strands of a mixed-length set of every byte value with empty and
   1-byte texts (DNA, IUPAC with 7 overshoot steps, ascii folded), of
   nanopore_full's 33,400 x 10 kbp reads (DNA, IUPAC with 7 steps) and of
   a one-text set of off_targets_full's 3.12 Gbp made on the card (DNA),
   each timed beside pack_bound;
3. end to end at full size: Searcher("dna", rc=True, device="cuda")
   .search over 1 GiB of random ACGT with mutated copies of the pattern
   planted on both strands; every copy must come back, through the
   kernel, with the cost and CIGAR of its one planted substitution; the
   phases of one strand are timed (the upload and the pack apart), and
   both strands' preparation from one upload; the search must upload the
   text once and launch the pack kernel once (the forward strand) and
   the text set's pack kernel once (the reverse strand, read backwards
   from the same bytes); then a read-only copy is searched twice, both
   calls timed: the first prepares both strands from one upload, the
   second uploads and packs nothing, and both return the same matches;
4. end to end, the card against the port's CPU path (the plain version
   of the kernel) on a 50 kbp slice: search and search_all at k in
   {0, 1, 3}, Match for Match with CIGAR. The CPU path is held to the
   numpy oracle by tests/test_torch_search.py, and the card to it by
   tests/test_torch_cuda.py;
5. kernel vs plain, batched: the q2meta kernel against its plain version
   on the piece windows of one dispatch chunk of phase 6 below (its
   first ~8.7k pieces of 321 words), k=3, bit for bit on all five
   outputs: first that chunk exactly as phase 6 launches it (all 96
   barcodes), then Q = 8 patterns of one row bucket with different
   lengths for pure, iupac, ascii and 97-104 bp patterns (M > 64); each
   pattern's slice also against the q1meta kernel; both timed; the
   select_words kernel on the first case's outputs as phase 6 runs it;
   then q2meta at evals/configs/off_targets_full.toml's dispatch chunk:
   312 random 23 bp guides over ~28 Mbp made on the card, in pieces of
   the width the batched engine gives 3.12 Gbp, one full chunk as
   BatchEngine.scan launches it, bit for bit and timed beside its bound;
6. end to end at full size, batched: the nanopore shape of
   evals/configs/nanopore_full.toml, 96 random 24 bp barcodes against
   33,400 random 10 kbp reads (334 Mbp), k=3, through
   Searcher("dna", rc=True, device="cuda").search_many; every read holds
   one barcode copy with one substitution at offset 5000 (even reads on
   the forward strand, odd reads as the reverse complement), and each
   must come back with its pattern, read, strand, cost 1 and CIGAR,
   through q2meta and never q1meta, its planes one launch of the text
   set's pack kernel a strand and no plain set pack; every read with any
   other match, and
   a sample of the others, is searched again on the port's CPU path (the
   plain versions), Match for Match with CIGAR; the phases of one strand
   are timed, with its host finish's split (filters, the trace: the
   traceback kernel's uploads, launch and one copy, Match build), as is
   the main run's finish, and the async dispatch is shown to return
   before its work; the main run's traceback launch of the forward strand
   is held bit for bit against trace_plain and timed beside its bound;
7. batched vs single on the card: 4 barcodes over 200 reads, search_many
   against the per-pair Searcher.search results (q1meta), and
   search_encoded_patterns(rc_anchor="end") against per-pattern search,
   Match for Match with CIGAR;
8. overhang, single engine, word-level path, 1 GiB:
   Searcher("iupac", rc=True, alpha=0.5).search of a 23 bp pattern at
   k=3 (7 overshoot steps: the q1meta scan with its tail tile), twice:
   exact copies hanging 4 chars off the text's start and off its end, on
   one strand each and then on the other, and a mutated interior copy;
   each must come back as the port's CPU path finds it on a 50 kbp slice
   holding the same end; q1meta launched, q1 never; one strand timed;
   the select_words kernel on the tail tile and the n_prev strip;
9. q1 vs plain and the single position-level path, 1 GiB: the q1 kernel
   against its plain version on the overlaid windows of a 120 bp IUPAC
   pattern at k=10, alpha 0.1 (101 overshoot steps), bit for bit, both
   timed; then Searcher("iupac", rc=True, alpha=0.1).search of it, with
   copies hanging 10 chars off both ends, checked as in phase 8; q1
   launched, q1meta never; the device memory peak; the select_positions
   kernel on the planted text's q1 outputs, and one call of it split by
   CUDA events into its walk, scan, host read and writing launch;
10. q2 vs plain: the q2 kernel against its plain version on the first
   dispatch chunk of phase 11b's position-level run (8 patterns of
   120 bp, k=10, alpha 0.1), bit for bit, each pattern's slice against
   q1; both timed; the select_positions_tiles kernel (the pieces' walk
   in select_positions.cu, the state chain inside) over the whole chunk
   as phase 11b selects it on the card, in one call, against the plain
   version chained over the CPU path's sub-ranges of the chunk with the
   carry passed along (same order, same carry out), split as in phase 9;
   then over the chunk's first sub-range alone against its plain version;
11. batched overhang at the nanopore shape, 33,400 fresh random 10 kbp
   reads: (a) search_many of 96 x 24 bp barcodes, k=3, alpha 0.5, an
   exact barcode copy hanging 4 chars off the start or the end of every
   16th read (q2meta, never q2, q1 or q1meta); (b) search_many of
   8 x 120 bp patterns, k=10, alpha 0.1, copies hanging 10 chars off the
   ends of every 64th read (q2, never q2meta); every planted copy must
   come back with its pattern, read, strand, cost and CIGAR, and every
   read with another match, plus 64 sampled reads, is searched again on
   the port's CPU path, Match for Match; the text set's pack kernel
   launched (both strands' planes with their overshoot), no plain set
   pack; the phases of one strand are timed;
12. the kernel-design family (scan_qn: U patterns per thread, the row
   loop kept or unrolled, WU words per iteration) at the nanopore
   dispatch chunk of the tool's own inputs (96 x 24 bp, 8,710 pieces of
   320 words, iupac eq): every member the tool runs against the plain
   version and against q2 (scan_q), bit for bit, and timed beside its
   bound and registers; the one-pattern-per-thread member also with the
   pure and the ascii eq; then the entry point itself,
   sassy_tpu_torch.tools.kernel_qn's run() in all three modes at the
   nanopore shape and at 8 x 64 bp, which must launch every member;
13. the row-step ablations (scan_variant: full, noeq, nomem, nostore) at
   the windows of 1 GiB for a 24 bp pattern: each against its plain
   version, full's vp against q1's, timed; then
   sassy_tpu_torch.tools.kernel_variants' run(), which must launch all
   four;
14. ascii end to end at full width: 1 GiB of random printable bytes with
   a few bytes outside that range, a 28 byte pattern, case-insensitive,
   k=3, copies planted with known edits (case swapped, one substitution,
   one byte above 127, one deletion, one insertion);
   Searcher(Ascii(case_sensitive=False), device="cuda").search and
   search_all must return each with its cost and CIGAR, as the port's CPU
   path finds it on a 50 kbp slice, through q1meta with the ascii eq; the
   strand's phases timed, the device memory peak logged; then search_many
   of four ascii patterns over 2,000 texts of 10 kB against the CPU path
   on the planted texts and a sample (q2meta);
15. the hierarchical suffix prefilter: the single path at 1 GiB with an
   80 bp pattern at k=3 (32 suffix rows) and planted copies on both
   strands, with the prefilter forced on and forced off (its gate, the
   work the suffix scan must save, set to 0 and to a value no plan
   reaches): equal Match lists, the flagged tiles counted, one strand's
   device path with and without the prefilter and the prefilter's steps
   timed in turns, also for a 160 bp pattern; the batched path at the
   nanopore shape with 8 x 72 bp at k=2 (32 suffix rows), on and off,
   equal Match lists, one strand's phases timed, and its dispatch with
   and without the prefilter in turns, also over fewer reads;
16. bench.py's loop on the port, through sassy_tpu_torch.tools.bench's
   run(): 1 GiB of random ACGT on the card with a 23 bp pattern planted
   three times with one substitution, TorchEngine.prepare, a warm
   candidates, 20 sequential candidates (median, p10, p90, best) and 3
   batches of 8 depth-2 pipelined candidates_async calls, then q1meta
   alone on the same windows under CUDA events; every list holds the
   planted ends and equals the warm one; candidates_async returns before
   its dispatch ends; q1meta only;
17. the command line on the card, in subprocesses (`cli_child`: a command
   as `python -m sassy_tpu_torch ...` runs it, or several through
   `sassy_tpu_torch.cli.main`, each with the kernels' launch counts read
   and a check that neither JAX nor the reference package was imported):
   (a) crispr at evals/configs/off_targets.toml's
   shape, 32 guides of 20 random bases + NGG at k=3 over a 128 Mbp FASTA
   of 4 contigs (each with a run of 10,000 N), one guide copy with one
   substitution every 1 Mbp on alternating strands, every 4th with its PAM
   broken: every intact copy in the TSV with its cost and CIGAR and no
   broken one, then with --allow-pam-edits the broken ones too; (b)
   search at evals/configs/nanopore.toml's shape, 96 barcodes of 24 bp at
   k=3 over 6,400 reads of 10 kbp with one copy planted per read, every
   copy in the TSV, in one batched call a group of units (32 MiB of
   records) and pattern batch, no more; the runs of (a) and (b) with
   their batched calls and wall split into dispatch, waits for the
   device, the host finish (filters, the trace, Match build), and the
   device's busy share; (c) search, search --sam, search --overhang 0.5,
   grep, filter -v and agrep on a 32-read subset (and 1 MB of printable
   text), --device cuda and --device cpu equal byte for byte on stdout
   and stderr; (d) (b) with --resume at 4 MiB units, killed after
   its fourth unit, inside the first group (exit 130), and rerun: the TSV
   equals an uninterrupted run's; (e) test;
18. GenomeScan over (a)'s genome with one guide, 2^24-char segments with
   an m + k halo, checkpointed: its rows equal Searcher.search over each
   whole contig, and with the Searcher kept alive the device memory after
   the scan is within 64 MiB of its value before (each segment is a fresh
   array, and its prepared texts go with it);
19. the evals, the refcost oracle, the C ABI and the examples: the
   refcost oracle builds from native/refcost.cc into build/ and leaves
   native/ byte for byte as it was; the port's evals harness
   (sassy_tpu_torch.evals.bench_suite) in this process on the card,
   nanopore at evals/configs/nanopore.toml's full scale (6,400 reads of
   10 kbp, 96 x 24 bp, k = 3 and 4) and text_scaling, pattern_scaling,
   off_targets, throughput_m and throughput_n at scale 0.05, one rep
   each: every CSV with the reference's header, search and tiling
   counting the same matches, the edlib columns filled, nanopore
   counting the matches of evals/output-v5e/nanopore_results.csv (6420
   and 6652), q2meta launched by the batched benches and q1meta by the
   throughput rows; the port's C ABI built with g++ and its example run
   on the card (3 matches, one on the reverse strand); the four examples
   (sassy_tpu_torch.examples) as subprocesses on the card and with
   --device cpu, all started at once: exit 0, the same match lines, the
   kernels of each launched on the card (the launch counts of these
   subprocesses come from a sitecustomize on their PYTHONPATH); modes'
   --device cpu run, and a second card run it is compared with, take the
   module constants of tests/test_torch_examples.py (MODES_SMALL);
20. the sharded search (sassy_tpu_torch.parallel) on the card, through
   q1meta, q2meta, q1 and q2 only (the plain versions refuse to run), each
   run's lists equal to the card's single engine's and its last_stats
   passing the owner-computes checks, its steps (pack and upload, halo
   exchange, scan, chain, selection, gather) timed and the device memory
   peak logged: (a) one process holding a 2 x 4 grid of slots over 1 GiB
   of random ACGT, fresh for each run, with a mutated copy straddling each
   of the three shard edges: 8 x 23 bp at k=3 (q2meta), 2 x 23 bp (q1meta;
   the second all 'A', with a plateau of cost 0 across edge 1 and a step
   of equal costs across edge 2 that must not be reported), 4 x 23 bp and
   2 x 23 bp at alpha 0.5 (q2 and q1, position level; exact copies
   hanging off both ends) and 80 bp at k=3 with the suffix prefilter
   forced on and off (equal lists);
   (b) 2^31 + 2^27 bases made on the card, 4 shards, 4 x 23 bp with copies
   ending past 2^31, against BatchEngine over the one text; (c) two
   processes sharing the one card over gloo (initialize's share_cards),
   4 slots each, 64 Mbp, equal to one process's 8 slots, importing
   neither JAX nor the reference; (d) multihost.initialize and
   global_search as one NCCL rank, 4 slots, against the single engine;
   (e) graft_entry.dryrun_multichip(8), counting the launches of its
   sharded searches alone, and entry() on the card; the selection
   kernels on a slot of a later shard (select_positions with min_pos,
   owned_end and state0, (a)'s overhang q2) and on the slot past 2^31
   ((b), select_words);
21. the port's tools (sassy_tpu_torch.tools) on the card through their
   run(), the plain scans and selections made to refuse: (a) one round
   of the differential soak (tools.soak: the 16 signatures, 8,000 pairs,
   each against the numpy oracle in a pool of processes), which must launch
   q1meta, q2meta, q1 and q2; (b) bench_oneshot at 10 kbp, 100 kbp and
   1 Mbp; (c) bench_traceback over 1,000 planted matches in 8 MB, traced
   and untraced counts equal (its ratio against the 10x criterion is
   logged only); (d) bench_io_overlap over a 16 Mbp genome, the crispr
   command line in a subprocess that imports neither JAX nor the
   reference, the steady pass finding the matches of the first; (e)
   profile_readset, 8 patterns over 16 MB as reads and as one text, with
   equal match counts (the copies planted every 5,000 bases never cross
   an edge of the 10,000-base reads); its soak round's launches join
   phase 20's in rows 1-4 of the kernels line.

After each main-path run of phases 3, 6, 8, 9, 11, 20 and 21a no plain
selection and no plain pack (nor the text set's plain pack) ran, and the
selection kernel of its level launched (the pack kernel too in phase 3
and over phase 20's runs, the text set's pack kernel in phases 3, 6 and
11); the pack kernel's launches there are row 12 of the kernels line
(times from phase 2: DNA on 1 GiB of ACGT, the other cases under the
row's "profiles" key), the text set's pack kernel's row 13 (times from
phase 2: nanopore_full's reads, forward, DNA; the other cases under
"cases"), the traceback kernel's row 14 (its launches there, the host
finish of both engines; times from phase 6's forward strand, the main
path's own launch captured and held bit for bit against trace_plain, as
are phase 9's, 11a's, 11b's and phase 14's ascii search_many's, under
the row's "holds" key; no plain traceback ran, and it launched in phases
3, 6, 8, 9 and 11), the selections' rows 10-11 (select_words, the
chained call; select_positions, with the pieces' kernel select_positions_tiles
as a record of its own under the row's "pieces" key), whose times are
phase 2's (without all_minima), phase 9's and phase 10's (the whole
chunk; the first sub-range's under the record's "sub_range" key). Row
2's record of q2meta is phase 5's nanopore chunk, with the
off_targets_full chunk under its "off_targets_full" key. The sharded runs
that hold a selection to its plain version capture its arguments in a
second, untimed run. The plain selections, the plain packs and the plain
traceback refuse to run wherever the plain scans do (phases 20 and 21).

The script imports neither JAX nor anything of the reference package.

Progress goes to stdout. The line before the last is the kernels' JSON
record; the last line is {"ok": true, "device": {...}}. Any failure exits
non-zero without that line.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

#: bound_ms and bound_by of one scan launch and of one selection call (the
#: kernels line): the H100 bounds of PERF.md section 6, kept in the package
#: beside cost_model
from sassy_tpu_torch.diagnostics import scan_bound as bound
from sassy_tpu_torch.diagnostics import select_bound

DEVICE = "cuda"
SEED = 0
N_TEXT = 1 << 30
K = 3
PATTERN_LEN = 23
LONG_PATTERN_LEN = 100
SLICE = 50_000
REPS = 10
#: the nanopore read set (evals/configs/nanopore_full.toml)
N_BARCODES = 96
BARCODE_LEN = 24
N_READS = 33_400
READ_LEN = 10_000
PLANT_AT = 5_000
#: phase 5's off_targets_full chunk: evals/configs/off_targets_full.toml's
#: guides and genome, and the bases made on the card for one full chunk
OFF_GUIDES = 312
OFF_GENOME_BP = 3_120_000_000
OFF_CHUNK_BP = 28_000_000
#: phase 5's pattern batch, phase 6's reads checked on the CPU path, and
#: phase 7's pairs
Q_KERNEL = 8
READS_CPU = 64
Q_SINGLE = 4
READS_SINGLE = 200
#: the planted copies' one edit: a substitution at this pattern index
MUT_AT = 11
#: phases 8-11: overhang. (alpha, k, pattern length, chars a planted copy
#: hangs off a text end) of the word-level cases (7 overshoot steps) and
#: the position-level ones (101 steps)
OH_WORD = (0.5, 3, 23, 4)
OH_POS = (0.1, 10, 120, 10)
#: phase 11: planted reads of (a) and (b), reads checked on the CPU path
OH_EVERY_A = 16
OH_EVERY_B = 64
OH_Q_B = 8
OH_SAMPLE = 64

#: phase 12-13: the seed of the tools' numpy generator
TOOL_SEED = 0
#: phase 14: ascii. Pattern, texts of search_many and those checked on the
#: CPU path besides the planted ones
ASCII_PATTERN = b"The Quick Brown Fox: 42 dogs"
ASCII_TEXTS = 2_000
ASCII_SAMPLE = 64
#: phase 15: (pattern length, k) of the single and the batched prefilter
#: runs (32 suffix rows each), and the batched pattern count
HIER_SINGLE = (80, 3)
HIER_BATCH = (72, 2)
HIER_Q = 8
#: smaller read sets the batched prefilter is also timed at, and the
#: turns and launches per turn of phase 15's timings
HIER_FEWER_READS = (8192, 2048, 256)
HIER_TURNS = 3
HIER_REPS = 5
#: a gate that no plan reaches: the prefilter forced off
NEVER = 1 << 62
#: phase 16: the seed of tools.bench's text and pattern (its default)
BENCH_SEED = 42
#: phase 17a: crispr at evals/configs/off_targets.toml's shape: guides,
#: contigs of the genome, a guide copy every CRISPR_EVERY bp, a run of
#: CRISPR_N_RUN 'N' per contig, k
CRISPR_GUIDES = 32
CRISPR_CONTIGS = 4
CRISPR_CONTIG_BP = 32_000_000
CRISPR_EVERY = 1_000_000
CRISPR_N_RUN = 10_000
CRISPR_K = 3
#: phase 17b-d: the reads of evals/configs/nanopore.toml (64 Mbp), the
#: subset run on both devices, the bytes of printable text for agrep, and
#: the resume run's batch bytes and the unit it is killed after
CLI_READS = 6_400
CLI_SUBSET = 32
AGREP_BYTES = 1 << 20
RESUME_BATCH = 4 << 20
#: seconds a CLI subprocess of phase 17 may take (each takes under 30 s
#: on the card): a stuck one dumps its threads' stacks at this less 30 s
#: and fails the phase, well inside the script's own limit
CLI_TIMEOUT = 240
RESUME_CRASH = 3
#: phase 18: GenomeScan's segment, and how far the device memory after the
#: scan may lie from its value before
SEGMENT = 1 << 24
SCAN_MEM_SLACK = 64 << 20

# phase 19: the evals harness (nanopore.toml at full scale; the other
# benches cut by EVAL_SCALE), the C ABI, the examples
EVAL_SMALL = ("text_scaling", "pattern_scaling", "off_targets",
              "throughput_m", "throughput_n")
EVAL_SCALE = 0.05
#: n_matches of evals/output-v5e/nanopore_results.csv (same numpy seeds)
NANOPORE_WANT = {3: 6420, 4: 6652}
#: each example and the kernels it launches on the card
EXAMPLES = {"all_vs_all_barcodes": ("q2meta",),
            "modes": ("q1meta", "q2meta"),
            "search_all_alignments": ("q1meta",),
            "genome_scan_resume": ("q1meta", "q2meta")}

# phase 20: the sharded search (sassy_tpu_torch.parallel). (a) one
# process, a SHARD_GRID (pattern groups, text shards) grid of slots on the
# card over SHARD_TEXT random bases; SHARD_Q counts patterns of
# PATTERN_LEN bp: the q2meta run, the q1meta run and the overhang q1 run
# (one pattern a slot), the overhang q2 run at SHARD_ALPHA; then one
# pattern of SHARD_LONG (length, k) with the prefilter forced on and off;
# (b) SHARD_BIG bases made on the card, past 2^31, over SHARD_BIG_DT
# shards; (c) SHARD_PROCS processes on the one card over gloo and (d) one
# NCCL rank, both over SHARD_MID bases
SHARD_TEXT = 1 << 30
SHARD_GRID = (2, 4)
SHARD_Q = (8, 2, 4)
SHARD_ALPHA = 0.5
SHARD_LONG = (80, 3)
SHARD_BIG = (1 << 31) + (1 << 27)
#: (b)'s copies end past this position
SHARD_PAST = 1 << 31
SHARD_BIG_DT = 4
SHARD_MID = 64_000_000
SHARD_PROCS = 2
#: phase 21: the port's tools on the card. The soak's seed (one round of
#: its 16 signatures, 8,000 pairs), bench_traceback's planted matches and
#: text, bench_io_overlap's genome, profile_readset's patterns and bytes
SOAK_SEED = 21
TRACEBACK_MATCHES, TRACEBACK_MB = 1000, 8.0
IO_OVERLAP_MB = 16
READSET_Q, READSET_MB = 8, 16
ONESHOT_REPS = 5
#: phase 19: examples/modes.py's CPU run (and the card run it is compared
#: with) at the module constants tests/test_torch_examples.py uses
MODES_SMALL = {"N_PATTERNS": 4, "N_TEXTS": 5, "TEXT_LEN": 300, "K": 8}

ROOT = Path(__file__).resolve().parent
#: phase 17-18's files (build/ is not committed)
CLI_DIR = ROOT / "build" / "chip_smoke_cli"
#: phase 19's files
P19_DIR = ROOT / "build" / "chip_smoke_p19"
#: phase 20's files
P20_DIR = ROOT / "build" / "chip_smoke_p20"
#: the subprocess of run_cli
_CLI_CHILD = ("import sys, chip_smoke; "
              "sys.exit(chip_smoke.cli_child(sys.argv[1]))")
#: a rank of phase 20c
_SHARD_CHILD = ("import sys, chip_smoke; "
                "sys.exit(chip_smoke.shard_child(*sys.argv[1:]))")
#: phase 19's modes run at MODES_SMALL, on the device named by argv[1]
_MODES_SMALL = ("import sys; import sassy_tpu_torch.examples.modes as m; "
                + "; ".join(f"m.{k} = {v}" for k, v in MODES_SMALL.items())
                + "; m.main(device=sys.argv[1])")


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def counts_zero():
    """Set every kernel's launch count, and the plain selections', the
    plain packs' and the plain traceback's call counts, to 0."""
    from sassy_tpu_torch import traceback
    from sassy_tpu_torch.ops import batch, myers_cuda, myers_torch

    for fn in (myers_cuda.scan_meta, myers_cuda.scan_q_meta, myers_cuda.scan,
               myers_cuda.scan_q, myers_cuda.scan_qn,
               myers_cuda.scan_variant, myers_cuda.pack,
               myers_cuda.pack_set, myers_cuda.trace_windows):
        fn.launches = 0
    traceback.trace_plain.calls = 0
    myers_cuda.scan_qn.members = {}
    myers_cuda.scan_variant.members = {}
    myers_torch.pack_plain.calls = 0
    batch.pack_set_plain.calls = 0
    myers_torch.windows_plain.calls = 0
    select_restore(dict.fromkeys(select_state(), 0))


def window_builds() -> int:
    """Window gathers since ``counts_zero``: the calls of
    ``windows_plain``, which ``build_windows`` and ``TextSet.windows`` go
    through. No search path on the card builds an (NW, P, T) window
    tensor (the scan kernels read the planes through descriptors):
    ``require`` and ``selected`` fail a card run where it is not 0."""
    from sassy_tpu_torch.ops import myers_torch

    return myers_torch.windows_plain.calls


#: launches of the pack kernel in the main path's runs (phases 3, 8, 9, 20
#: and 21a), row 12 of the kernels line
PACKED = {"launches": 0}
#: launches of the text set's pack kernel in the main path's runs (phases
#: 6, 11 and 21a: every batched search's planes; phases 3, 8 and 9: the
#: single engine's reverse strand), row 13
PACKED_SET = {"launches": 0}
#: launches of the traceback kernel in the main path's runs (phases 3, 6,
#: 8, 9 and 11: both engines' host finish), row 14
TRACED = {"launches": 0}
#: the traceback kernel held against its plain version on a launch
#: captured from a main-path run (hold_trace), by label: phase 6's forward
#: strand is row 14's record, the others go under its "holds" key
TRACE_HOLDS = {}


#: the selection entry points of ops/minima.py that the engines call, and
#: their kernels' rows
SELECT_ENTRIES = {"select_words_chained": "select_words_chained",
                  "select_candidates": "select_positions",
                  "select_candidates_tiles": "select_positions_tiles",
                  "select_candidates_chained": "select_positions_tiles"}
#: launches of the selection kernels in the main path's runs (phases 3, 6,
#: 8, 9, 11, 20 and 21a), rows 10-11 of the kernels line
SELECTED = dict.fromkeys(SELECT_ENTRIES.values(), 0)


def select_state() -> dict:
    """The selection kernels' launch counts and the plain versions' call
    counts."""
    from sassy_tpu_torch.ops import minima, myers_cuda

    got = {kernel: getattr(myers_cuda, kernel).launches
           for kernel in SELECTED}
    for name in SELECT_ENTRIES:
        got[name + "_plain"] = getattr(minima, name + "_plain").calls
    return got


def select_restore(state: dict) -> None:
    from sassy_tpu_torch.ops import minima, myers_cuda

    for kernel in SELECTED:
        getattr(myers_cuda, kernel).launches = state[kernel]
    for name in SELECT_ENTRIES:
        getattr(minima, name + "_plain").calls = state[name + "_plain"]


def selected(what: str, used: tuple) -> dict:
    """After a main-path run that began with ``counts_zero()``: no plain
    selection ran, each kernel ``used`` launched; the launches join
    ``SELECTED``; no plain pack ran (nor the text set's plain pack, the
    PyTorch gathers and masks it composes), and the pack kernels' launches
    join ``PACKED`` and ``PACKED_SET`` (under the result's "pack" and
    "pack_set" keys)."""
    from sassy_tpu_torch.ops import batch, myers_cuda, myers_torch

    got = select_state()
    plain = {k: v for k, v in got.items() if k.endswith("_plain") and v}
    if plain:
        fail(f"{what} ran the plain selections {plain}")
    for name in used:
        if not got[name]:
            fail(f"{what} launched no {name} kernel")
    for name in SELECTED:
        SELECTED[name] += got[name]
    if myers_torch.pack_plain.calls:
        fail(f"{what} ran the plain pack {myers_torch.pack_plain.calls} "
             "times")
    if batch.pack_set_plain.calls:
        fail(f"{what} ran the text set's plain pack "
             f"{batch.pack_set_plain.calls} times")
    if DEVICE != "cpu" and window_builds():
        fail(f"{what} built windows {window_builds()} times: a search path "
             "on the card gathered (NW, P, T) windows")
    got["pack"] = myers_cuda.pack.launches
    PACKED["launches"] += got["pack"]
    got["pack_set"] = myers_cuda.pack_set.launches
    PACKED_SET["launches"] += got["pack_set"]
    from sassy_tpu_torch import traceback

    if DEVICE != "cpu" and traceback.trace_plain.calls:
        fail(f"{what} ran the plain traceback {traceback.trace_plain.calls} "
             "times")
    got["trace"] = myers_cuda.trace_windows.launches
    TRACED["launches"] += got["trace"]
    return got


def traced(what: str, got: dict, least: int = 1) -> None:
    """A main-path run's ``selected`` counts: the traceback kernel launched
    ``least`` times or more (the host finish traced on the card)."""
    if got["trace"] < least:
        fail(f"{what} launched the traceback kernel {got['trace']} times")


@contextlib.contextmanager
def captured_traces():
    """Record the arguments of every ``myers_cuda.trace_windows`` call in
    the block, in order; every call goes through and counts its launches
    as it would."""
    from sassy_tpu_torch.ops import myers_cuda

    calls = []
    fn = myers_cuda.trace_windows

    def rec(*a, **kw):
        calls.append(a)
        return fn(*a, **kw)

    # the wrapper counts where it launches through the module's name
    rec.launches = fn.launches
    myers_cuda.trace_windows = rec
    try:
        yield calls
    finally:
        fn.launches = rec.launches
        myers_cuda.trace_windows = fn


def hold_trace(label: str, args) -> dict:
    """A captured traceback call held on its inputs: the kernel again
    (one launch a chunk) and its plain version (``trace_plain``, on the same
    tensors on the card) bit for bit on every output (start, total cost,
    pattern start and end, failed, every op); the kernel timed under CUDA
    events, the plain version on the host clock, beside
    ``diagnostics.trace_bound``. The hold's own launches are not counted.
    The record goes into ``TRACE_HOLDS[label]``."""
    import numpy as np
    import torch

    from sassy_tpu_torch import traceback
    from sassy_tpu_torch.diagnostics import trace_bound
    from sassy_tpu_torch.ops import myers_cuda

    _, pcodes, cand, _, prof, fill, _, chunk = args
    m, B = pcodes.shape[1], cand.shape[1]
    before = myers_cuda.trace_windows.launches
    plain_before = traceback.trace_plain.calls
    got = myers_cuda.trace_windows(*args).cpu().numpy()
    t0 = time.perf_counter()
    want = traceback.trace_plain(*args).numpy()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ms = cuda_ms(lambda: myers_cuda.trace_windows(*args), REPS)
    myers_cuda.trace_windows.launches = before
    traceback.trace_plain.calls = plain_before
    a, b = (traceback.unpack_trace(x, m, fill) for x in (got, want))
    err = max((int(np.abs(x.astype(np.int64) - y.astype(np.int64)).max())
               for x, y in zip(a, b) if x.size), default=0)
    same = np.array_equal(got, want)
    rec = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
           **trace_bound(cand.cpu().numpy(), want, m, fill, prof.planes,
                         pcodes.shape[0]),
           "candidates": B, "m": m, "fill": fill,
           "launches_a_call": -(-B // chunk), "failed": int(b[5].sum())}
    log(f"{label}: the traceback kernel vs plain: {B} candidates of "
        f"{prof.name}, m={m}, fill {fill}, {rec['launches_a_call']} "
        f"launch(es) a call: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
        f"{rec['ops']} ops, {rec['bytes']} bytes), bit-equal={same} "
        f"max_abs_err={err}")
    if not same:
        fail(f"{label}: the traceback kernel != its plain version")
    TRACE_HOLDS[label] = rec
    return rec


@contextlib.contextmanager
def captured_selection(keep=None):
    """Record the arguments of a call of each selection entry point in the
    block (the first, or the first for which ``keep(name, args, kwargs)``
    holds) as {name: (args, kwargs)}; every call goes through."""
    from sassy_tpu_torch.ops import minima

    calls = {}
    saved = {name: getattr(minima, name) for name in SELECT_ENTRIES}

    def recording(name):
        fn = saved[name]

        def rec(*a, **kw):
            if name not in calls and (keep is None or keep(name, a, kw)):
                calls[name] = (a, kw)
            return fn(*a, **kw)
        return rec

    for name in SELECT_ENTRIES:
        setattr(minima, name, recording(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(minima, name, fn)


def cuda_once(fn):
    """One call's result and its milliseconds (CUDA events)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def hold_selection(label: str, name: str, call) -> dict:
    """A selection kernel against its plain version: the entry point
    ``name`` of ops/minima.py on the card and its plain version on the
    same inputs (``call``, captured where a phase ran it), equal after a
    lexsort of the columns (they are integers); both timed with CUDA
    events (the kernel over REPS calls, the plain version once). Leaves
    the launch counts as it found them. Returns the record."""
    import numpy as np

    from sassy_tpu_torch.ops import minima

    a, kw = call
    state = select_state()
    entry = getattr(minima, name)
    plain = getattr(minima, name + "_plain")
    got, got_carry = columns_and_carry(entry(*a, **kw))
    ref, plain_ms = cuda_once(lambda: plain(*a, **kw))
    ref, ref_carry = columns_and_carry(ref)
    ms = cuda_ms(lambda: entry(*a, **kw), REPS)
    select_restore(state)
    order = (slice(None), np.lexsort(got[::-1]))
    same = got.shape == ref.shape and bool(
        (got[order] == ref[(slice(None), np.lexsort(ref[::-1]))]).all())
    same = same and (got_carry is None or (got_carry == ref_carry).all())
    rec = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": 0,
           "candidates": got.shape[1],
           **select_bound(name, a, kw, got.shape[1])}
    log(f"{label}: {SELECT_ENTRIES[name]} ({name}) vs plain: "
        f"{got.shape[1]} candidates, equal after a lexsort={same} (in the "
        f"same order={got.shape == ref.shape and bool((got == ref).all())})"
        f"{'' if got_carry is None else ', carry out equal'}"
        f", kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    if name == "select_words_chained":  # the kernels keep the plain order
        same = same and got.shape == ref.shape and bool((got == ref).all())
    if not same:
        fail(f"{label}: the {SELECT_ENTRIES[name]} kernel != its plain "
             f"version: {got.shape} {ref.shape}")
    return rec


def columns_and_carry(got):
    """A selection's columns on the host, and its carry (the chained
    entry's) or None."""
    if isinstance(got, tuple):
        return got[0].cpu().numpy(), got[1].cpu().numpy()
    return got.cpu().numpy(), None


#: the C entry point of each chained entry point's kernel
SPLIT_ENTRY = {"select_candidates": "sassy_select_positions",
               "select_candidates_chained": "sassy_select_positions_tiles",
               "select_words_chained": "sassy_select_words"}


def select_split(label: str, name: str, call) -> dict:
    """One call of a selection entry point split by CUDA events around
    each of its kernel's launches: the walk (the word level: the count)
    and the scan, the gap before the writing launch (the host read of the
    total and the output's allocation) and the writing launch, in ms.
    Leaves the launch counts as it found them."""
    import torch

    from sassy_tpu_torch.ops import minima, myers_cuda

    lib = myers_cuda._lib()
    real = getattr(lib, SPLIT_ENTRY[name])
    marks = []

    class Marked:
        def __getattr__(self, attr):
            return getattr(lib, attr)

    def launch(*a):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        err = real(*a)
        ev[1].record()
        marks.append(ev)
        return err

    marked = Marked()
    setattr(marked, SPLIT_ENTRY[name], launch)
    saved = myers_cuda._lib
    state = select_state()
    a, kw = call
    getattr(minima, name)(*a, **kw)  # warm
    torch.cuda.synchronize()
    myers_cuda._lib = lambda: marked
    try:
        getattr(minima, name)(*a, **kw)
        torch.cuda.synchronize()
    finally:
        myers_cuda._lib = saved
        select_restore(state)
    ms = lambda x, y: x.elapsed_time(y)  # noqa: E731
    first = "count" if name == "select_words_chained" else "walk"
    split = {"launches": len(marks), first: ms(*marks[0]),
             "scan": ms(*marks[1]),
             "read": ms(marks[1][1], marks[2][0]) if len(marks) > 2 else 0.0,
             "write": ms(*marks[2]) if len(marks) > 2 else 0.0,
             "call": ms(marks[0][0], marks[-1][1])}
    log(f"{label}: one {name} call split by CUDA events: "
        + ", ".join(f"{k} {v:.4f} ms" if k != "launches" else f"{v} launches"
                    for k, v in split.items()))
    return split


#: the scan kernels of the search paths, their plain versions and the
#: launch functions their wrappers call (argument lists: the wrapper's,
#: with the library first and the stream last)
SCAN_HOLDS = {"scan_meta": ("launch", "scan_meta_plain", True),
              "scan_q_meta": ("launch_q", "scan_q_meta_plain", True),
              "scan": ("launch_scan", "scan_plain", False),
              "scan_q": ("launch_scan_q", "scan_q_plain", False)}


@contextlib.contextmanager
def captured_scans():
    """Record the arguments of every scan-kernel launch in the block, in
    order, as [(wrapper name, args)]: the window descriptor the engine
    handed the kernel and the rest, as the wrapper took them. Nothing
    more is launched."""
    from sassy_tpu_torch.ops import myers_cuda

    calls = []
    saved = {}
    for name, (launcher, _, _) in SCAN_HOLDS.items():
        fn = saved[launcher] = getattr(myers_cuda, launcher)

        def rec(lib, *a, _name=name, _fn=fn):
            calls.append((_name, a[:-1]))
            return _fn(lib, *a)
        setattr(myers_cuda, launcher, rec)
    try:
        yield calls
    finally:
        for launcher, fn in saved.items():
            setattr(myers_cuda, launcher, fn)


def hold_scan(label: str, name: str, args) -> dict:
    """One captured scan launch held on its descriptor: the kernel again
    and its plain version (``windows_plain``, then the scan) on the same
    inputs, bit for bit; the kernel timed over REPS launches beside
    ``scan_bound``. Leaves the launch counts as it found them. Returns
    the record."""
    import torch

    from sassy_tpu_torch.ops import myers_cuda, myers_torch

    launches = {n: getattr(myers_cuda, n).launches for n in SCAN_HOLDS}
    gathers = myers_torch.windows_plain.calls
    kernel = getattr(myers_cuda, name)
    plain = getattr(myers_cuda, SCAN_HOLDS[name][1])
    got = kernel(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    err = max((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
              for a, b in zip(got, ref))
    del got, ref
    ms = cuda_ms(lambda: kernel(*args), REPS)
    for n, v in launches.items():
        getattr(myers_cuda, n).launches = v
    myers_torch.windows_plain.calls = gathers
    win = args[0]
    pm = args[4] if SCAN_HOLDS[name][2] else args[2]
    Q = pm.shape[0] if pm.dim() == 3 else 1
    rec = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
           **bound(args[-1], Q, pm.shape[-2], win.shape,
                   SCAN_HOLDS[name][2])}
    NW, P, T = win.shape
    log(f"{label}: {name} on descriptors (NW={NW} P={P} T={T}, planes "
        f"{tuple(win.planes.shape)}) vs plain: bit-equal={same} "
        f"max_abs_err={err}, kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}), "
        f"{rec['bound_ms'] / ms:.1%} of it")
    if not same:
        fail(f"{label}: {name} on descriptors != its plain version")
    return rec


def hold_engine_select(label: str, run, keep=None, with_call=False):
    """``run()`` (an engine's selection step) with its selection call
    captured, then that call held against its plain version; the launches
    of ``run()`` are not counted. Returns the record (and, ``with_call``,
    the call)."""
    state = select_state()
    with captured_selection(keep) as calls:
        run()
    select_restore(state)
    if len(calls) != 1:
        fail(f"{label}: expected one selection call, got {list(calls)}")
    ((name, call),) = calls.items()
    held = hold_selection(label, name, call)
    return (held, call) if with_call else held


def counts() -> dict:
    from sassy_tpu_torch.ops import myers_cuda

    return {"q1meta": myers_cuda.scan_meta.launches,
            "q2meta": myers_cuda.scan_q_meta.launches,
            "q1": myers_cuda.scan.launches, "q2": myers_cuda.scan_q.launches,
            "qn": myers_cuda.scan_qn.launches,
            "variants": myers_cuda.scan_variant.launches,
            "windows": window_builds()}


def require(launched: dict, used: tuple, unused: tuple, what: str,
            least: int = 2):
    """The kernels ``used`` launched ``least`` times or more, those
    ``unused`` never; on the card no window builder ran (``windows``)."""
    if DEVICE != "cpu" and launched.get("windows"):
        fail(f"{what} built windows {launched['windows']} times: a search "
             "path on the card gathered (NW, P, T) windows")
    for name in used:
        if launched[name] < least:
            fail(f"{what} launched {name} {launched[name]} times")
    for name in unused:
        if launched[name]:
            fail(f"{what} launched {name} {launched[name]} times")


def random_acgt(gen, n: int):
    import torch

    bases = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=DEVICE)
    return bases[torch.randint(0, 4, (n,), generator=gen, device=DEVICE)]


def kernel_vs_plain(gen, text_dev):
    """Phase 2. Returns the headline (pure) records of q1meta and of the
    word-level selection: times and error."""
    import torch

    from sassy_tpu_torch import profiles
    from sassy_tpu_torch.ops import myers_cuda
    from sassy_tpu_torch.ops.myers_torch import TorchEngine

    eng = TorchEngine(DEVICE)
    dna = profiles.Dna()
    pattern = random_acgt(gen, PATTERN_LEN).cpu().numpy()
    long_pattern = random_acgt(gen, LONG_PATTERN_LEN).cpu().numpy()
    t0 = time.perf_counter()
    prep = eng.prepare(dna, text_dev)
    prep_ascii = eng.prepare(profiles.Ascii(), text_dev)
    torch.cuda.synchronize()
    log(f"phase 2: packed {N_TEXT >> 20} MiB for dna and ascii in "
        f"{time.perf_counter() - t0:.3f} s")
    cases = [
        ("pure", dna, prep, pattern),
        ("iupac", dna, prep, pattern),
        ("ascii", profiles.Ascii(), prep_ascii, pattern),
        ("pure, M>64", dna, prep, long_pattern),
    ]
    head = None
    for label, prof, p, pat in cases:
        inp = eng.build_inputs(prof, prof.encode(pat), p, K)
        if label == "iupac":
            inp.eq_mode = "iupac"
        args = (inp.windows, inp.tile0, inp.valid_from, inp.valid_to,
                inp.pmasks, inp.is_pad, inp.h_init, inp.m_real,
                inp.boundary_m, inp.k, inp.eq_mode)
        got = myers_cuda.scan_meta(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = myers_cuda.scan_meta_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(
            (a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
            for a, b in zip(got, ref)
        )
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        ms = cuda_ms(lambda: myers_cuda.scan_meta(*args), REPS)
        NW, P, T = inp.windows.shape
        log(f"phase 2: {label}: eq={inp.eq_mode} M={inp.pmasks.shape[0]} "
            f"NW={NW} P={P} T={T} kernel {ms:.3f} ms, plain {plain_ms:.1f} ms,"
            f" bit-equal={same} max_abs_err={err}")
        if not same:
            fail(f"kernel != plain for {label}")
        if head is None:
            head = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                    **bound(inp.eq_mode, 1, inp.pmasks.shape[0],
                            inp.windows.shape, True)}
            # the selection of these outputs as the engine runs it
            for all_minima in (True, False):
                inp.all_minima = all_minima
                head_sw, call = hold_engine_select(
                    f"phase 2: {label}, all_minima={all_minima}",
                    lambda: eng.select(inp, got), with_call=True)
            head_sw["split"] = select_split(
                f"phase 2: {label}", "select_words_chained", call)
            del call
        del got, ref
    return head, head_sw


#: phase 2's pack profiles: DNA and IUPAC (table5), ascii folded and not
#: (byte, with the validity plane)
PACK_PROFILES = ("dna", "iupac", "ascii_fold", "ascii")
#: phase 2's text past 2^31 positions (made on the card, freed after)
PACK_PAST = (1 << 31) + 33


def pack_profile(name: str):
    from sassy_tpu_torch import profiles

    return {"dna": profiles.Dna(), "iupac": profiles.Iupac(),
            "ascii_fold": profiles.Ascii(case_sensitive=False),
            "ascii": profiles.Ascii(case_sensitive=True)}[name]


def random_bytes(gen, n: int):
    """``n`` bytes of every value on the card, drawn 2^28 at a time."""
    import torch

    out = torch.empty(n, dtype=torch.uint8, device=DEVICE)
    for c0 in range(0, n, 1 << 28):
        c1 = min(n, c0 + (1 << 28))
        out[c0:c1] = torch.randint(0, 256, (c1 - c0,), generator=gen,
                                   device=DEVICE, dtype=torch.uint8)
    return out


def hold_pack(label: str, text, prof) -> dict:
    """The pack kernel (``myers_torch.pack`` on the card) against
    ``pack_plain`` on the same text, bit for bit, as ``PreparedText``
    calls it (the n bytes, the bucketed words); the kernel timed over REPS
    launches and the plain version once, both with CUDA events, beside
    ``pack_bound``. Leaves the launch counts as it found them."""
    import torch

    from sassy_tpu_torch.diagnostics import pack_bound
    from sassy_tpu_torch.ops import myers_cuda, myers_torch, plan

    n = text.numel()
    gw = plan._bucket_words(plan.cdiv(n, 32) + plan.TAIL_RESERVE_WORDS)
    args = (text, n // 32, n % 32, prof.planes, prof.eq_mode == "ascii",
            prof.pack_mode, prof.pack_shift, prof.pack_mask,
            tuple(prof.pack_plane_masks), prof.pack_fold_case, gw)
    launches = myers_cuda.pack.launches
    calls = myers_torch.pack_plain.calls
    got = myers_torch.pack(*args)
    ref, plain_ms = cuda_once(lambda: myers_torch.pack_plain(*args))
    same = torch.equal(got, ref)
    err = 0 if same else int((got.to(torch.int64) - ref.to(torch.int64))
                             .abs().max())
    del got, ref
    ms = cuda_ms(lambda: myers_torch.pack(*args), REPS)
    myers_cuda.pack.launches = launches
    myers_torch.pack_plain.calls = calls
    rec = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
           **pack_bound(n, prof.planes, prof.eq_mode == "ascii", gw)}
    log(f"{label}: pack ({prof.name}, planes {prof.planes}"
        f"{' + validity' if prof.eq_mode == 'ascii' else ''}) of {n} bytes "
        f"vs plain: bit-equal={same}, kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}), {rec['bound_ms'] / ms:.1%} of it")
    if not same:
        fail(f"{label}: the pack kernel != its plain version, max abs "
             f"difference {err}")
    return rec


def pack_vs_plain(gen, text_dev) -> dict:
    """Phase 2's pack: the kernel against its plain version at 1 GiB for
    the four profiles, on phase 2's ACGT text and on bytes of every value,
    then on a text of PACK_PAST bytes of every value made on the card.
    Returns the DNA record on the ACGT text (row 12), with the others
    under its "profiles" key."""
    import torch

    head = None
    others = {}
    noise = random_bytes(gen, N_TEXT)
    for name in PACK_PROFILES:
        prof = pack_profile(name)
        rec = hold_pack(f"phase 2: {name}, {N_TEXT >> 20} MiB of ACGT",
                        text_dev, prof)
        others[name] = {key: rec[key] for key in ("ms", "plain_ms",
                                                  "bound_ms", "bound_by")}
        rec_noise = hold_pack(f"phase 2: {name}, {N_TEXT >> 20} MiB of "
                              "every byte value", noise, prof)
        others[name + ", every byte"] = {
            key: rec_noise[key] for key in ("ms", "plain_ms", "bound_ms",
                                            "bound_by")}
        if head is None:
            head = rec
    del noise
    torch.cuda.empty_cache()
    big = random_bytes(gen, PACK_PAST)
    rec = hold_pack(f"phase 2: dna, {PACK_PAST} bytes (past 2^31)", big,
                    pack_profile("dna"))
    others[f"dna, {PACK_PAST} bytes"] = {key: rec[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by")}
    del big
    torch.cuda.empty_cache()
    head["profiles"] = others
    return head


#: phase 2's mixed-length text set for the text set's pack (empty and
#: 1-byte texts among them; every byte value)
PACK_SET_MIXED = (0, 1, 0, 31, 32, 33, 1, 0, 4133, 70_001, 1, 0)


def hold_pack_set(label: str, data, tables, width: int, prof,
                  reverse: bool, steps: int) -> dict:
    """The text set's pack kernel (``batch.pack_set`` on the card, as
    ``TextSet.planes`` calls it) against ``pack_set_plain`` on the same
    bytes and tables, bit for bit; the kernel timed over REPS launches and
    the plain version once, both with CUDA events, beside ``pack_bound``
    (the texts' bytes read once, the planes written once). Leaves the
    launch and call counts as it found them."""
    import torch

    from sassy_tpu_torch.diagnostics import pack_bound
    from sassy_tpu_torch.ops import batch, myers_cuda, myers_torch

    args = (data, *tables, width, prof, reverse, steps)
    launches = myers_cuda.pack_set.launches
    calls = (batch.pack_set_plain.calls, myers_torch.pack_plain.calls)
    got = batch.pack_set(*args)
    ref, plain_ms = cuda_once(lambda: batch.pack_set_plain(*args))
    same = torch.equal(got, ref)
    err = 0 if same else int((got.to(torch.int64) - ref.to(torch.int64))
                             .abs().max())
    del got, ref
    ms = cuda_ms(lambda: batch.pack_set(*args), REPS)
    myers_cuda.pack_set.launches = launches
    batch.pack_set_plain.calls, myers_torch.pack_plain.calls = calls
    n_bytes = int(tables[1].sum())
    rec = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
           **pack_bound(n_bytes, prof.planes, prof.eq_mode == "ascii",
                        width, texts=tables[1].numel())}
    log(f"{label}: text set pack ({prof.name}, "
        f"{'reverse' if reverse else 'forward'}, {steps} steps) of "
        f"{tables[1].numel()} texts, {n_bytes} bytes, {width} words vs "
        f"plain: bit-equal={same}, kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}), {rec['bound_ms'] / ms:.1%} of it")
    if not same:
        fail(f"{label}: the text set's pack kernel != its plain version, "
             f"max abs difference {err}")
    return rec


def pack_set_vs_plain(gen) -> dict:
    """Phase 2's text set pack: the kernel against its plain version on a
    mixed-length set of every byte value (DNA, IUPAC with 7 overshoot
    steps, ascii folded), on nanopore_full's read set (33,400 x 10 kbp of
    ACGT: DNA, and IUPAC with 7 steps, as phase 11a's overhang search packs
    it), and on a one-text set of off_targets_full's 3.12 Gbp made on the
    card, each on both strands. Returns the nanopore forward DNA record
    (row 13) with the others under its "cases" key."""
    import numpy as np
    import torch

    from sassy_tpu_torch.ops import batch
    from sassy_tpu_torch.ops.myers_torch import aligned_words

    def hold_all(name, data, tables_of, words_of, cases):
        recs = {}
        for prof_name, steps in cases:
            prof = pack_profile(prof_name)
            for reverse in (False, True):
                label = (f"{name}, {prof_name}, "
                         f"{'reverse' if reverse else 'forward'}, "
                         f"{steps} steps")
                recs[label] = hold_pack_set(
                    f"phase 2: {label}", data, tables_of(steps),
                    aligned_words(words_of(steps) + 1), prof, reverse, steps)
        return recs

    rng = np.random.default_rng(SEED + 3)
    mixed = batch.TextSet([rng.integers(0, 256, n, dtype=np.uint8)
                           for n in PACK_SET_MIXED], DEVICE)
    recs = hold_all("mixed set", mixed.data(), mixed.tables, mixed.words,
                    (("dna", 0), ("iupac", 7), ("ascii_fold", 0)))
    reads = random_acgt(gen, N_READS * READ_LEN).cpu().numpy().reshape(
        N_READS, READ_LEN)
    ts = batch.TextSet(list(reads), DEVICE)
    nano = hold_all(f"{N_READS} x {READ_LEN} bp", ts.data(), ts.tables,
                    ts.words, (("dna", 0), ("iupac", 7)))
    head = next(iter(nano.values()))
    recs.update(nano)
    del ts, reads
    genome = random_acgt_chunked(gen, OFF_GENOME_BP)
    n = OFF_GENOME_BP

    def one_text(steps):
        wofs = [0, -(-(n + steps) // 32)]
        return tuple(torch.tensor(v, dtype=torch.int64, device=DEVICE)
                     for v in ([0], [n], wofs))

    recs.update(hold_all(f"one text of {n} bp", genome, one_text,
                         lambda steps: -(-(n + steps) // 32),
                         (("dna", 0),)))
    del genome
    torch.cuda.empty_cache()
    head["cases"] = {label: {key: rec[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by")}
        for label, rec in recs.items()}
    return head


def mutated(pattern):
    """A copy with one substitution at ``MUT_AT``, as bench.py plants."""
    out = pattern.copy()
    out[MUT_AT] = ord("A") if out[MUT_AT] != ord("A") else ord("C")
    return out


def plant(text, pattern, rc_pattern, n: int):
    """Mutated copies (one substitution, as bench.py plants them) on both
    strands at fixed offsets. Returns [(strand, start)]."""
    mut = mutated(pattern)
    rc_mut = rc_pattern(mut)
    sites = [("FWD", 12345, mut), ("FWD", n // 2, mut),
             ("RC", n // 3, rc_mut), ("RC", n - 5000, rc_mut)]
    for _, off, seq in sites:
        text[off : off + len(seq)] = seq
    return [(s, off) for s, off, _ in sites]


def end_to_end(gen):
    """Phase 3. Returns the kernel's launch count in the main-path run."""
    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher, profiles
    from sassy_tpu_torch.ops import myers_cuda
    from sassy_tpu_torch.ops.myers_torch import _upload

    dna = profiles.Dna()
    pattern = random_acgt(gen, PATTERN_LEN).cpu().numpy()
    text = random_acgt(gen, N_TEXT).cpu().numpy()
    rc = lambda s: np.frombuffer(dna.reverse_complement(s), np.uint8)  # noqa: E731
    sites = plant(text, pattern, rc, N_TEXT)
    searcher = Searcher("dna", rc=True, device=DEVICE)
    eng = searcher.engine
    pcodes = dna.encode(pattern)

    # the phases of the forward strand, each ended by a synchronise; the
    # first run pays one-time costs (allocator growth, first launches)
    names = ("upload", "pack", "windows", "scan kernel", "selection",
             "traceback")
    for run in ("cold", "warm"):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        text_dev = _upload(text, eng.device)
        mark()
        prep = eng.prepare(dna, text_dev)
        mark()
        inp = eng.build_inputs(dna, pcodes, prep, K)
        mark()
        outs = eng.scan(inp)
        mark()
        cands = eng.select(inp, outs).cpu()
        mark()
        host_finish(searcher, pattern, pcodes, text, K, cands, prep)
        mark()
        log(f"phase 3: forward strand, {N_TEXT >> 20} MiB, {run}: "
            + ", ".join(f"{nm} {(b - a) * 1e3:.1f} ms"
                        for nm, a, b in zip(names, marks, marks[1:]))
            + f" ({cands.shape[1]} candidates)")
        del text_dev, prep, inp, outs

    # both strands' planes from one upload, timed apart (the text is
    # writeable, so nothing is kept)
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pair = eng.prepare_strands(dna, text)
        torch.cuda.synchronize()
        log(f"phase 3: both strands prepared from one upload, {run}: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        del pair

    with counted_uploads() as uploads:
        counts_zero()
        t0 = time.perf_counter()
        matches = searcher.search(pattern, text, K)
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        launches = myers_cuda.scan_meta.launches
        got = selected("phase 3", ("select_words_chained",))
        traced("phase 3", got)
    log(f"phase 3: Searcher.search, both strands, {N_TEXT >> 20} MiB: "
        f"{e2e:.3f} s, "
        f"{len(matches)} matches, scan kernel launches {launches}, uploads "
        f"{uploads['n']}, pack kernel launches {got['pack']}, text set "
        f"pack kernel launches {got['pack_set']}")
    if (uploads["n"], got["pack"], got["pack_set"]) != (1, 1, 1):
        fail(f"phase 3: the two-strand search made {uploads['n']} uploads, "
             f"{got['pack']} pack launches and {got['pack_set']} set pack "
             "launches, not one each")
    if launches < 2:
        fail(f"the search launched the scan kernel {launches} times")
    searched_twice(searcher, pattern, text, matches)

    # each planted copy, aligned as it was planted: one substitution
    m = PATTERN_LEN
    want_cigar = f"{MUT_AT}=1X{m - MUT_AT - 1}="
    for strand, off in sites:
        got = [x for x in matches
               if x.text_start == off and x.strand.name == strand]
        if len(got) != 1:
            fail(f"planted {strand} copy at {off}: got {got}")
        g = got[0]
        if (g.text_end != off + m or g.cost != 1
                or g.cigar.to_string() != want_cigar):
            fail(f"planted {strand} copy at {off}: {g}, want cost 1, "
                 f"cigar {want_cigar}")
        log(f"phase 3: planted {strand} copy at {off}: found, cost {g.cost}, "
            f"cigar {g.cigar.to_string()}")
    return launches, text, pattern


@contextlib.contextmanager
def counted_uploads():
    """Count the host texts ``myers_torch._upload`` sends to the card (the
    count under the yielded dict's "n")."""
    from sassy_tpu_torch.ops import myers_torch

    upload = myers_torch._upload
    got = {"n": 0}

    def counting(text, device):
        got["n"] += 1
        return upload(text, device)

    myers_torch._upload = counting
    try:
        yield got
    finally:
        myers_torch._upload = upload


def searched_twice(searcher, pattern, text, want):
    """Phase 3's warm search: a read-only copy of the text searched twice
    on both strands; the first search uploads once and launches the pack
    and the text set's pack once each, the second uploads and launches
    neither (the pair of prepared strands is kept while the copy lives);
    both return phase 3's Match list. Logs both calls' times."""
    import numpy as np
    import torch

    frozen = np.frombuffer(text.tobytes(), np.uint8)
    for call, want_launched in (("first", (1, 1, 1)), ("second", (0, 0, 0))):
        with counted_uploads() as uploads:
            counts_zero()
            t0 = time.perf_counter()
            got = searcher.search(pattern, frozen, K)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            n = selected(f"phase 3, read-only copy, {call} search",
                         ("select_words_chained",))
        launched = (uploads["n"], n["pack"], n["pack_set"])
        log(f"phase 3: Searcher.search of a read-only copy, both strands, "
            f"{call} call: {took:.3f} s, {len(got)} matches, uploads "
            f"{launched[0]}, pack launches {launched[1]}, set pack "
            f"launches {launched[2]}")
        if launched != want_launched:
            fail(f"phase 3: the {call} search of a read-only copy made "
                 f"(uploads, packs, set packs) {launched}, not "
                 f"{want_launched}")
        if [(m.sort_key(), m.cigar.to_string()) for m in got] != [
                (m.sort_key(), m.cigar.to_string()) for m in want]:
            fail(f"phase 3: the {call} search of a read-only copy returned "
                 "other matches")
    del frozen
    torch.cuda.empty_cache()


def against_cpu(text, pattern):
    """Phase 4: the port on the card equals its CPU path."""
    from sassy_tpu_torch import Searcher, profiles

    mid = len(text) // 2
    piece = text[mid - SLICE // 2 : mid + SLICE // 2].copy()
    # exact copies on both strands, beside the mutated one at the middle
    rc = profiles.Dna().reverse_complement(pattern)
    piece[1000 : 1000 + len(pattern)] = pattern
    piece[3000 : 3000 + len(pattern)] = list(rc)
    port = Searcher("dna", rc=True, device=DEVICE)
    plain = Searcher("dna", rc=True, device="cpu")
    for k in (0, 1, 3):
        for fn in ("search", "search_all"):
            got = getattr(port, fn)(pattern, piece, k)
            want = getattr(plain, fn)(pattern, piece, k)
            same = bool(want) and len(got) == len(want) and all(
                a.same_as(b) and a.cigar.to_string() == b.cigar.to_string()
                for a, b in zip(got, want)
            )
            log(f"phase 4: {fn} k={k}: {len(got)} matches, equal={same}")
            if not same:
                fail(f"{fn} k={k} differs from the CPU path")


def nanopore_reads(gen, n_reads: int = N_READS):
    """Phase 6's read set: (n_reads, READ_LEN) uint8 random ACGT, the
    barcodes, and one mutated barcode copy planted in every read."""
    import numpy as np

    reads = random_acgt(gen, n_reads * READ_LEN).cpu().numpy().reshape(
        n_reads, READ_LEN)
    barcodes = random_acgt(gen, N_BARCODES * BARCODE_LEN).cpu().numpy()
    barcodes = barcodes.reshape(N_BARCODES, BARCODE_LEN)
    mutated = barcodes.copy()
    col = mutated[:, MUT_AT]
    mutated[:, MUT_AT] = np.where(col != ord("A"), ord("A"), ord("C"))
    comp = np.arange(256, dtype=np.uint8)
    comp[list(b"ACGT")] = list(b"TGCA")
    rc_mutated = comp[mutated[:, ::-1]]
    i = np.arange(n_reads)
    site = slice(PLANT_AT, PLANT_AT + BARCODE_LEN)
    reads[0::2, site] = mutated[i[0::2] % N_BARCODES]
    reads[1::2, site] = rc_mutated[i[1::2] % N_BARCODES]
    return reads, barcodes


def q_kernel_vs_plain(reads, barcodes):
    """Phase 5. Returns the headline (pure) record: times and error."""
    import torch

    from sassy_tpu_torch import profiles
    from sassy_tpu_torch.ops import myers_cuda
    from sassy_tpu_torch.ops.batch import BatchEngine, TextSet

    eng = BatchEngine(DEVICE)
    texts = list(reads)
    dna, ascii_ = profiles.Dna(), profiles.Ascii()
    ts = TextSet(texts, DEVICE)
    # phase 6's piece plan and its first dispatch chunk
    (g96,) = eng.groups(dna, [dna.encode(p) for p in barcodes], ts, K)
    pp = ts.piece_plan(g96.halo, g96.w_chars)
    q0, q1, t0, t1 = next(eng.chunks(g96, pp))
    tiles = slice(t0, t1)
    # 8 patterns of one row bucket, 24 down to 17 bp: mixed m_real
    short = [barcodes[q, : BARCODE_LEN - q] for q in range(Q_KERNEL)]
    long_ = [reads[q, 100 : 204 - q] for q in range(Q_KERNEL)]  # M = 104
    g_dna = eng.groups(dna, [dna.encode(p) for p in short], ts, K)[0]
    start = time.perf_counter()
    # the pieces' descriptors: the kernels read their windows from the
    # planes (the plain versions gather them)
    win_dna = ts.descriptor(dna, pp, False, t0, t1)
    win_ascii = ts.descriptor(ascii_, pp, False, t0, t1)
    torch.cuda.synchronize()
    log(f"phase 5: descriptors of pieces {t0}..{t1} of {pp.T} for dna and "
        f"ascii (planes included) in {time.perf_counter() - start:.3f} s")
    # the first case is phase 6's first launch, as BatchEngine.scan issues
    # it: patterns q0..q1 of the 96
    cases = [
        ("pure, phase 6's chunk", g96, slice(q0, q1), win_dna),
        ("pure", g_dna, slice(None), win_dna),
        ("iupac", g_dna, slice(None), win_dna),
        ("ascii", eng.groups(ascii_, [ascii_.encode(p) for p in short], ts,
                             K)[0], slice(None), win_ascii),
        ("pure, M>64", eng.groups(dna, [dna.encode(p) for p in long_], ts,
                                  K)[0], slice(None), win_dna),
    ]
    head = None
    for label, g, qs, win in cases:
        eq_mode = "iupac" if label == "iupac" else g.eq_mode
        args = (win, pp.true_start[tiles], pp.valid_from[tiles],
                pp.valid_to[tiles], g.pmasks[qs], g.is_pad[qs], g.h_init[qs],
                g.m_real[qs], g.boundary_m[qs], K, eq_mode)
        got = myers_cuda.scan_q_meta(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = myers_cuda.scan_q_meta_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(
            (a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
            for a, b in zip(got, ref)
        )
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        del ref
        # each pattern's slice against the q1meta kernel
        pm, pad, hi, mr, bm = args[4:9]
        q1 = all(
            all(torch.equal(a, b[q]) for a, b in zip(myers_cuda.scan_meta(
                *args[:4], pm[q], pad[q], hi[q], int(mr[q]), int(bm[q]), K,
                eq_mode), got))
            for q in range(pm.shape[0])
        )
        ms = cuda_ms(lambda: myers_cuda.scan_q_meta(*args), REPS)
        NW, P, T = win.shape
        m_real = sorted(set(mr.tolist()))
        log(f"phase 5: {label}: eq={eq_mode} Q={pm.shape[0]} M={pm.shape[1]} "
            f"m_real={m_real} NW={NW} P={P} T={T} kernel "
            f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bit-equal={same} "
            f"max_abs_err={err}, slices equal q1meta={q1}")
        if not (same and q1):
            fail(f"q2meta != plain or q1meta for {label}")
        if head is None:
            head = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                    **bound(eq_mode, pm.shape[0], pm.shape[1], win.shape,
                            True)}
            # its selection, as BatchEngine.select runs it in phase 6
            carry = torch.zeros((pm.shape[0], 1), dtype=torch.int32,
                                device=DEVICE)
            hold_engine_select(
                f"phase 5: {label}", lambda: eng.select(
                    got, g, pp, q0, tiles.start, tiles.stop, K, False,
                    carry))
        del got
    head["off_targets_full"] = off_targets_chunk()
    return head


def off_targets_chunk() -> dict:
    """Phase 5, last: q2meta against its plain version on one full dispatch
    chunk of evals/configs/off_targets_full.toml's shape (OFF_GUIDES
    guides of PATTERN_LEN bp over OFF_GENOME_BP, pieces of the width
    _piece_width gives that text), over OFF_CHUNK_BP random bases made on
    the card, bit for bit; timed beside its bound."""
    import torch

    from sassy_tpu_torch import profiles
    from sassy_tpu_torch.ops import myers_cuda
    from sassy_tpu_torch.ops.batch import BatchEngine, TextSet, _piece_width

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    dna = profiles.Dna()
    guides = random_acgt(gen, OFF_GUIDES * PATTERN_LEN).cpu().numpy()
    guides = [dna.encode(g) for g in guides.reshape(OFF_GUIDES, PATTERN_LEN)]
    eng = BatchEngine(DEVICE)
    ts = TextSet([random_acgt(gen, OFF_CHUNK_BP).cpu().numpy()], DEVICE)
    (g,) = eng.groups(dna, guides, ts, K)
    g.w_chars = _piece_width([OFF_GENOME_BP], 0, g.halo, g.Q, g.pair_bytes)
    pp = ts.piece_plan(g.halo, g.w_chars)
    q0, q1, t0, t1 = next(eng.chunks(g, pp))
    if (q0, q1) != (0, g.Q) or t1 == pp.T:
        fail(f"phase 5: {OFF_CHUNK_BP} bases hold no full chunk of "
             f"{pp.T} pieces: {(q0, q1, t0, t1)}")
    win = ts.descriptor(dna, pp, False, t0, t1)
    args = (win, pp.true_start[t0:t1], pp.valid_from[t0:t1],
            pp.valid_to[t0:t1], g.pmasks, g.is_pad, g.h_init, g.m_real,
            g.boundary_m, K, g.eq_mode)
    got = myers_cuda.scan_q_meta(*args)
    torch.cuda.synchronize()
    t_plain = time.perf_counter()
    ref = myers_cuda.scan_q_meta_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t_plain) * 1e3
    err = max((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
              for a, b in zip(got, ref))
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    del got, ref
    ms = cuda_ms(lambda: myers_cuda.scan_q_meta(*args), REPS)
    rec = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
           **bound(g.eq_mode, g.Q, g.pmasks.shape[1], win.shape, True)}
    rec.update(share=rec["bound_ms"] / ms, Q=g.Q, NW=win.shape[0],
               T=win.shape[2], threads=g.Q * win.shape[2])
    log(f"phase 5: off_targets_full's chunk: eq={g.eq_mode} Q={g.Q} "
        f"M={g.pmasks.shape[1]} NW={win.shape[0]} T={win.shape[2]} "
        f"({rec['threads']} threads) kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bit-equal={same} max_abs_err={err}, bound "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), "
        f"{rec['share']:.1%} of it")
    if not same:
        fail("q2meta != plain at off_targets_full's chunk")
    return rec


def finish_split_text(sp: dict) -> str:
    """A ``Searcher.last_finish_split`` as one clause: its steps' host
    times and sizes, the Match build split into its steps and the
    collector's passes during them."""
    if "trace" in sp:  # the kernel: uploads, launches, the one copy
        trace = (f"trace {sp['trace'] * 1e3:.1f} ms ({sp.get('windows', 0)} "
                 "windows)")
    else:
        trace = (f"window gather {sp.get('gather', 0) * 1e3:.1f} ms "
                 f"({sp.get('windows', 0)} windows), fill "
                 f"{sp.get('fill', 0) * 1e3:.1f} ms, walk "
                 f"{sp.get('walk', 0) * 1e3:.1f} ms")
    return (f"filters {sp.get('filters', 0) * 1e3:.1f} ms "
            f"({sp.get('candidates', 0)} candidates, {sp.get('kept', 0)} "
            f"kept), {trace}, Match build "
            f"{sp.get('build', 0) * 1e3:.1f} ms ({sp.get('matches', 0)} "
            f"matches: unpack {sp.get('unpack', 0) * 1e3:.1f} ms, CIGARs "
            f"{sp.get('cigars', 0) * 1e3:.1f} ms, Match objects "
            f"{sp.get('match_objects', 0) * 1e3:.1f} ms; the collector's "
            f"passes in them {sp.get('gc_passes', 0)}, "
            f"{sp.get('gc_s', 0) * 1e3:.1f} ms)")


def batched_strand_phases(label, searcher, prof, pats, texts, k, alpha):
    """The phases of the forward strand of a batched search: the engine's
    own dispatch, with its window, scan and selection steps timed (each
    ended by a synchronise); the first run pays one-time costs. The warm
    run also finishes the candidates on the host, as ``search_many`` does,
    with the finish's split."""
    import torch

    from sassy_tpu_torch import Strand
    from sassy_tpu_torch.ops import batch

    pcodes = [prof.encode(p) for p in pats]
    for run in ("cold", "warm"):
        acc = dict.fromkeys(("windows", "prefilter", "scan", "select"), 0.0)

        def timed(obj, name, key):
            fn = getattr(obj, name)

            def wrapper(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                acc[key] += time.perf_counter() - t0
                return out
            setattr(obj, name, wrapper)

        eng = batch.BatchEngine(DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts = batch.TextSet(texts, DEVICE)
        (g,) = eng.groups(prof, pcodes, ts, k, alpha)
        ts.planes(prof, False, g.steps)
        torch.cuda.synchronize()
        t_pack = time.perf_counter() - t0
        timed(ts, "windows", "windows")
        timed(eng, "flagged_pieces", "prefilter")
        timed(eng, "scan", "scan")
        timed(eng, "select", "select")
        pp = ts.piece_plan(g.halo, g.w_chars, g.steps)
        found = eng.dispatch(prof, ts, g, k, False, False)
        t0 = time.perf_counter()
        flat = batch._decode(batch._fetch(found), len(pats), len(texts),
                             True)
        t_decode = time.perf_counter() - t0
        post = "not run"  # the host finish has no cold cost to show
        if run == "warm":
            t0 = time.perf_counter()
            ms = searcher._finish_many_batched(
                [(Strand.FWD, pats, pcodes, lambda: flat)], ts, k, None)
            post = (f"{(time.perf_counter() - t0) * 1e3:.1f} ms "
                    f"({len(ms)} matches: "
                    f"{finish_split_text(searcher.last_finish_split)})")
        n_chunks = len(list(eng.chunks(g, pp)))
        log(f"{label}: forward strand, {len(pats)} x {len(pats[0])} bp over "
            f"{len(texts)} x {READ_LEN} bp, {run}: upload+pack "
            f"{t_pack * 1e3:.1f} ms, piece windows "
            f"{acc['windows'] * 1e3:.1f} ms, suffix prefilter "
            f"{acc['prefilter'] * 1e3:.1f} ms, kernel "
            f"{acc['scan'] * 1e3:.1f} ms, selection {acc['select'] * 1e3:.1f} ms, host copy+decode "
            f"{t_decode * 1e3:.1f} ms, host finish {post} "
            f"(M={g.pmasks.shape[1]} eq={g.eq_mode} steps={g.steps} "
            f"pieces={pp.T} NW={pp.NW} chunks={n_chunks})")
        del ts, eng, found, flat


def batched_end_to_end(reads, barcodes):
    """Phase 6. Returns the q2meta launch count of the main-path run."""
    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher, profiles
    from sassy_tpu_torch.ops import batch, myers_cuda

    dna = profiles.Dna()
    texts = list(reads)
    pats = list(barcodes)
    pcodes = [dna.encode(p) for p in pats]
    searcher = Searcher("dna", rc=True, device=DEVICE)

    batched_strand_phases("phase 6", searcher, dna, pats, texts, K, None)

    # the async dispatch returns before its device work ends: dispatch
    # both strands, then wait for each
    eng = batch.BatchEngine(DEVICE)
    ts = batch.TextSet(texts, DEVICE)
    ccodes = [dna.encode(np.frombuffer(dna.complement(p), np.uint8))
              for p in pats]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin = eng.candidates_many_async(dna, pcodes, ts, K)
    rfin = eng.candidates_many_async(dna, ccodes, ts, K, reverse=True)
    t1 = time.perf_counter()
    fin()
    t2 = time.perf_counter()
    rfin()
    t3 = time.perf_counter()
    log(f"phase 6: candidates_many_async of both strands returned in "
        f"{(t1 - t0) * 1e3:.1f} ms; the forward finish() after "
        f"{(t2 - t0) * 1e3:.1f} ms, the reverse after {(t3 - t0) * 1e3:.1f} "
        "ms")
    del eng, ts

    counts_zero()
    t0 = time.perf_counter()
    with captured_traces() as traces:
        matches = searcher.search_many(pats, texts, K)
        torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launches = myers_cuda.scan_q_meta.launches
    single = myers_cuda.scan_meta.launches
    got = selected("phase 6", ("select_words_chained",))
    traced("phase 6", got, least=2)
    n_set = got["pack_set"]
    log(f"phase 6: Searcher.search_many, both strands: {e2e:.3f} s, "
        f"{len(matches)} matches, q2meta launches {launches}, q1meta "
        f"launches {single}, text set pack kernel launches {n_set}, one-text "
        f"pack kernel launches {got['pack']}, plain set packs 0; its host "
        f"finish, both strands: "
        f"{finish_split_text(searcher.last_finish_split)}")
    if launches < 2 or single or n_set < 2:
        fail(f"search_many launched q2meta {launches}, q1meta {single} and "
             f"the text set's pack kernel {n_set} times")
    # the forward strand's traceback, as the main path launched it
    hold_trace("phase 6: the forward strand", traces[0])
    del traces

    want_cigar = f"{MUT_AT}=1X{BARCODE_LEN - MUT_AT - 1}="
    planted = {}
    for m in matches:
        if m.text_start == PLANT_AT:
            planted.setdefault((m.pattern_idx, m.text_idx, m.strand.name),
                               []).append(m)
    for i in range(N_READS):
        key = (i % N_BARCODES, i, "FWD" if i % 2 == 0 else "RC")
        got = planted.get(key, [])
        if (len(got) != 1 or got[0].cost != 1
                or got[0].text_end != PLANT_AT + BARCODE_LEN
                or got[0].cigar.to_string() != want_cigar):
            fail(f"planted copy {key}: got {got}, want cost 1, cigar "
                 f"{want_cigar}")
    log(f"phase 6: all {N_READS} planted copies found with their pattern, "
        f"read, strand, cost 1 and cigar {want_cigar}")

    # every read with a match besides its planted copy, and a sample of the
    # rest, against the port's CPU path (the plain kernel versions)
    extra = {m.text_idx for m in matches
             if m.text_start != PLANT_AT or m.pattern_idx != m.text_idx
             % N_BARCODES or m.strand.name != ("FWD", "RC")[m.text_idx % 2]}
    reads_cpu = sorted(extra | set(range(0, N_READS, N_READS // READS_CPU)))
    where = {t: i for i, t in enumerate(reads_cpu)}
    t0 = time.perf_counter()
    cpu = Searcher("dna", rc=True, device="cpu").search_many(
        pats, [texts[t] for t in reads_cpu], K)
    t_cpu = time.perf_counter() - t0
    for m in cpu:
        m.text_idx = reads_cpu[m.text_idx]
    key = lambda m: (m.pattern_idx, m.text_idx, m.strand.name,  # noqa: E731
                     m.text_start, m.text_end, m.cost)
    got = sorted((m for m in matches if m.text_idx in where), key=key)
    cpu.sort(key=key)
    same = len(got) == len(cpu) and all(
        a.same_as(b) and a.cigar.to_string() == b.cigar.to_string()
        for a, b in zip(got, cpu))
    log(f"phase 6: {len(extra)} reads with other matches "
        f"({len(matches) - N_READS} matches) and {len(reads_cpu)} reads in "
        f"all against the CPU path ({t_cpu:.1f} s): {len(got)} matches, "
        f"equal={same}")
    if not same:
        fail("search_many differs from the CPU path on the checked reads")
    return launches


def batched_vs_single(reads, barcodes):
    """Phase 7: the batched engine equals the per-pair single-pattern
    engine on the card."""
    from sassy_tpu_torch import Searcher

    searcher = Searcher("dna", rc=True, device=DEVICE)
    pats = list(barcodes[:Q_SINGLE])
    texts = list(reads[:READS_SINGLE])
    key = lambda m: (m.pattern_idx, m.text_idx, m.strand.name,  # noqa: E731
                     m.text_start, m.text_end, m.cost)

    def same(got, want):
        got, want = sorted(got, key=key), sorted(want, key=key)
        return bool(want) and len(got) == len(want) and all(
            a.same_as(b) and a.cigar.to_string() == b.cigar.to_string()
            for a, b in zip(got, want))

    batched = searcher.search_many(pats, texts, K)
    single = []
    for qi, p in enumerate(pats):
        for ti, t in enumerate(texts):
            for m in searcher.search(p, t, K):
                m.pattern_idx, m.text_idx = qi, ti
                single.append(m)
    ok = same(batched, single)
    log(f"phase 7: search_many {len(pats)} x {len(texts)} reads: "
        f"{len(batched)} matches, per-pair search {len(single)}, equal={ok}")
    if not ok:
        fail("search_many differs from the per-pair single-pattern search")

    text = reads[:READS_SINGLE].reshape(-1)
    enc = searcher.encode_patterns(pats, rc_anchor="end")
    batched = searcher.search_encoded_patterns(enc, text, K)
    single = []
    for qi, p in enumerate(pats):
        for m in searcher.search(p, text, K):
            m.pattern_idx = qi
            single.append(m)
    ok = same(batched, single)
    log(f"phase 7: search_encoded_patterns(rc_anchor='end') over "
        f"{len(text)} bp: {len(batched)} matches, per-pattern search "
        f"{len(single)}, equal={ok}")
    if not ok:
        fail("search_encoded_patterns differs from per-pattern search")


def _rc_table():
    import numpy as np

    comp = np.arange(256, dtype=np.uint8)
    comp[list(b"ACGTRY")] = list(b"TGCAYR")
    return lambda seq: comp[seq[::-1]]


def planted_end(pattern, strand: str, where: str, hang: int, n: int):
    """An exact copy of ``pattern`` on ``strand`` hanging ``hang`` chars off
    the ``where`` end of a text of length n. Returns (offset, bytes, the
    Match's (text_start, text_end, pattern_start, pattern_end))."""
    m = len(pattern)
    seq = pattern if strand == "FWD" else _rc_table()(pattern)
    at, part = (0, seq[hang:]) if where == "start" else (
        n - (m - hang), seq[: m - hang])
    # the forward copy off the start and the reverse one off the end lose
    # the pattern's head; the others its tail
    lost_head = (strand == "FWD") == (where == "start")
    return at, part, (at, at + m - hang) + ((hang, m) if lost_head
                                             else (0, m - hang))


def host_finish(searcher, pattern, pcodes, text, k: int, cands, prep):
    """One strand's candidates ((2, N) end positions and costs, on the
    host) through the Searcher's host finish as one (pattern, text) cell,
    as ``Searcher.search`` runs it: the filters, the traceback (on the
    planes of ``prep``, its ``PreparedText``) and the Match build."""
    import numpy as np

    from sassy_tpu_torch import Strand, spans
    from sassy_tpu_torch.traceback import StrandPlanes

    pos, cost = cands.numpy().astype(np.int64)
    order = np.lexsort((cost, pos))
    zeros = np.zeros(len(pos), np.int64)
    lens = np.array([len(text)], np.int64)
    split: dict = {}
    with spans.bound(split):
        found = searcher._finish_strand(
            [pattern], [pcodes], [text], lens,
            (zeros, zeros, pos[order], cost[order]), k, None, Strand.FWD,
            lambda: StrandPlanes(prep.planes, np.zeros(1, np.int64)))
        out = searcher._matches([found], lens)
    searcher.last_finish_split = split
    return out


def single_strand_phases(label, searcher, prof, pattern, text, k):
    """The phases of one strand of a single-pattern search, each ended by a
    synchronise; the first run pays one-time costs."""
    import torch

    eng = searcher.engine
    pcodes = prof.encode(pattern)
    names = ("upload+pack", "plan+windows", "scan kernel", "selection",
             "traceback")
    for run in ("cold", "warm"):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        prep = eng.prepare(prof, text)
        mark()
        inp = eng.build_inputs(prof, pcodes, prep, k, searcher.alpha,
                               searcher.max_overhang)
        mark()
        outs = eng.scan(inp)
        mark()
        cands = eng.select(inp, outs).cpu()
        mark()
        host_finish(searcher, pattern, pcodes, text, k, cands, prep)
        mark()
        log(f"{label}: forward strand, {len(text) >> 20} MiB, {run}, "
            f"{'word' if inp.fast else 'position'} level (T="
            f"{inp.windows.shape[2]} NW={inp.windows.shape[0]}): "
            + ", ".join(f"{nm} {(b - a) * 1e3:.1f} ms"
                        for nm, a, b in zip(names, marks, marks[1:]))
            + f" ({cands.shape[1]} candidates)")
        del prep, inp, outs


def fields(mt, shift: int = 0):
    return (mt.text_start + shift, mt.text_end + shift, mt.pattern_start,
            mt.pattern_end, mt.cost, mt.strand.name, mt.cigar.to_string())


def check_sites(label, matches, sites, pattern, text, k, alpha):
    """Each planted site [(strand, where, offset, want)] comes back once,
    as the port's CPU path finds it on a slice of SLICE chars holding the
    same text end (or the interior copy); an exact copy off an end also
    with its predicted span, cost floor(alpha * hang) and CIGAR."""
    from sassy_tpu_torch import Searcher

    n = len(text)
    cpu = Searcher("iupac", rc=True, alpha=alpha, device="cpu")
    for strand, where, at, want in sites:
        off = {"start": 0, "end": n - SLICE}.get(where, at - SLICE // 2)

        def pick(ms, n_here, shift):
            return [fields(x, shift) for x in ms if x.strand.name == strand
                    and {"start": x.text_start == 0,
                         "end": x.text_end == n_here}.get(
                             where, x.text_start + shift == at)]

        got = pick(matches, n, 0)
        ref = pick(cpu.search(pattern, text[off : off + SLICE], k), SLICE,
                   off)
        if len(got) != 1 or got != ref:
            fail(f"{label}: planted {strand} copy at the {where} ({at}): "
                 f"card {got}, CPU path on the slice {ref}")
        if want is not None and got[0][:5] != want:
            fail(f"{label}: planted {strand} copy at the {where}: {got[0]}, "
                 f"want {want}")
        log(f"{label}: planted {strand} copy at the {where} ({at}): found "
            f"as on the CPU path: span {got[0][:2]}, pattern {got[0][2:4]}, "
            f"cost {got[0][4]}, cigar {got[0][6]}")


def overhang_single(gen, text):
    """Phase 8: the word-level overhang path at 1 GiB."""
    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher, profiles

    alpha, k, m, hang = OH_WORD
    iupac = profiles.Iupac()
    pattern = random_acgt(gen, m).cpu().numpy()
    n = len(text)
    mid = n // 5
    mutated = pattern.copy()
    mutated[MUT_AT] = ord("A") if mutated[MUT_AT] != ord("A") else ord("C")
    text[mid : mid + m] = mutated
    searcher = Searcher("iupac", rc=True, alpha=alpha, device=DEVICE)
    cost = int(np.floor(np.float32(alpha) * np.float32(hang)))
    for variant, (s_start, s_end) in enumerate((("FWD", "RC"),
                                                 ("RC", "FWD"))):
        sites = [("FWD", "mid", mid, None)]
        for strand, where in ((s_start, "start"), (s_end, "end")):
            at, part, span = planted_end(pattern, strand, where, hang, n)
            text[at : at + len(part)] = part
            sites.append((strand, where, at, span + (cost,)))
        if variant == 0:
            single_strand_phases("phase 8", searcher, iupac, pattern, text, k)
            eng = searcher.engine
            inp = eng.build_inputs(iupac, iupac.encode(pattern),
                                   eng.prepare(iupac, text), k, alpha,
                                   searcher.max_overhang)
            if not (inp.fast and inp.n_prev and inp.text_end is not None):
                fail(f"phase 8: expected the word level with a strip, got "
                     f"fast={inp.fast} n_prev={inp.n_prev}")
            hold_engine_select(
                f"phase 8: the tail tile and a {inp.n_prev}-word strip",
                lambda: eng.select(inp, eng.scan(inp)))
            del inp
        counts_zero()
        t0 = time.perf_counter()
        matches = searcher.search(pattern, text, k)
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        launched = counts()
        log(f"phase 8: Searcher.search with alpha {alpha}, both strands, "
            f"{n >> 20} MiB, copies {s_start} off the start and {s_end} off "
            f"the end: {e2e:.3f} s, {len(matches)} matches, launches "
            f"{launched}")
        require(launched, ("q1meta",), ("q1", "q2", "q2meta"), "phase 8")
        traced("phase 8", selected("phase 8", ("select_words_chained",)))
        check_sites("phase 8", matches, sites, pattern, text, k, alpha)


def overhang_position_level(gen, text):
    """Phase 9: q1 against its plain version, and the position-level
    single path at 1 GiB. Returns q1's record."""
    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher, profiles
    from sassy_tpu_torch.ops import myers_cuda

    alpha, k, m, hang = OH_POS
    iupac = profiles.Iupac()
    planted = random_acgt(gen, m).cpu().numpy()
    pattern = planted.copy()  # two IUPAC codes: the iupac eq
    pattern[[30, 90]] = [ord("R"), ord("Y")]
    planted[30] = ord("A") if planted[30] in b"CT" else planted[30]
    planted[90] = ord("C") if planted[90] in b"AG" else planted[90]
    n = len(text)

    searcher = Searcher("iupac", rc=True, alpha=alpha, device=DEVICE)
    eng = searcher.engine
    prep = eng.prepare(iupac, text)
    inp = eng.build_inputs(iupac, iupac.encode(pattern), prep, k, alpha)
    if inp.fast or inp.eq_mode != "iupac":
        fail(f"phase 9: expected the position-level iupac path, got fast="
             f"{inp.fast} eq={inp.eq_mode}")
    args = (inp.windows, inp.tile0, inp.pmasks, inp.is_pad, inp.h_init,
            inp.m_real, inp.boundary_m, inp.eq_mode)
    got = myers_cuda.scan(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = myers_cuda.scan_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
              for a, b in zip(got, ref))
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    del got, ref
    ms = cuda_ms(lambda: myers_cuda.scan(*args), REPS)
    NW, P, T = inp.windows.shape
    log(f"phase 9: q1 vs plain: eq={inp.eq_mode} M={inp.pmasks.shape[0]} "
        f"NW={NW} P={P} T={T} (steps {inp.max_pos - inp.n_text}) kernel "
        f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bit-equal={same} "
        f"max_abs_err={err}")
    if not same:
        fail("q1 != plain")
    record = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
              **bound(inp.eq_mode, 1, inp.pmasks.shape[0], inp.windows.shape,
                      False)}
    del prep, inp, args

    mid = 2 * n // 5
    mutated = planted.copy()
    mutated[MUT_AT] = ord("A") if mutated[MUT_AT] != ord("A") else ord("C")
    text[mid : mid + m] = mutated
    cost = int(np.floor(np.float32(alpha) * np.float32(hang)))
    sites = [("FWD", "mid", mid, None)]
    for strand, where in (("FWD", "start"), ("RC", "end")):
        at, part, span = planted_end(planted, strand, where, hang, n)
        text[at : at + len(part)] = part
        sites.append((strand, where, at, span + (cost,)))
    # the selection of the planted text's forward strand as the engine
    # runs it
    inp = eng.build_inputs(iupac, iupac.encode(pattern),
                           eng.prepare(iupac, text), k, alpha)
    record["select"], call = hold_engine_select(
        "phase 9: the single position level, planted copies",
        lambda: eng.select(inp, eng.scan(inp)), with_call=True)
    record["select"]["split"] = select_split(
        "phase 9: the single position level", "select_candidates", call)
    del inp, call
    single_strand_phases("phase 9", searcher, iupac, pattern, text, k)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts_zero()
    t0 = time.perf_counter()
    with captured_traces() as traces:
        matches = searcher.search(pattern, text, k)
        torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launched = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 9: Searcher.search with alpha {alpha}, both strands, "
        f"{n >> 20} MiB, position level: {e2e:.3f} s, {len(matches)} "
        f"matches, launches {launched}, device memory peak {peak:.2f} GiB")
    require(launched, ("q1",), ("q1meta", "q2", "q2meta"), "phase 9")
    traced("phase 9", selected("phase 9", ("select_positions",)))
    hold_trace("phase 9: the forward strand, position level", traces[0])
    del traces
    check_sites("phase 9", matches, sites, pattern, text, k, alpha)
    record["launches"] = launched["q1"]
    return record


def overhang_reads(gen):
    """Phase 11's read set: (N_READS, READ_LEN) uint8 random ACGT."""
    return random_acgt(gen, N_READS * READ_LEN).cpu().numpy().reshape(
        N_READS, READ_LEN)


def plant_reads(reads, pats, every: int, hang: int, first: int = 0) -> dict:
    """An exact copy hanging ``hang`` chars off the start or the end of
    every ``every``-th read from ``first`` on, alternating the pattern,
    strand and end.
    Returns {(pattern, read, strand): (text_start, text_end,
    pattern_start, pattern_end)}."""
    want = {}
    for j, i in enumerate(range(first, len(reads), every)):
        q = j % len(pats)
        strand = "FWD" if j % 2 == 0 else "RC"
        where = "start" if (j // 2) % 2 == 0 else "end"
        at, part, span = planted_end(pats[q], strand, where, hang,
                                     reads.shape[1])
        reads[i, at : at + len(part)] = part
        want[(q, i, strand)] = span
    return want


def q2_vs_plain(reads, pats):
    """Phase 10: q2 against its plain version on the first dispatch chunk
    of phase 11b's position-level group. Returns the record."""
    import torch

    from sassy_tpu_torch import profiles
    from sassy_tpu_torch.ops import myers_cuda
    from sassy_tpu_torch.ops.batch import BatchEngine, TextSet

    alpha, k = OH_POS[:2]
    iupac = profiles.Iupac()
    eng = BatchEngine(DEVICE)
    ts = TextSet(list(reads), DEVICE)
    (g,) = eng.groups(iupac, [iupac.encode(p) for p in pats], ts, k, alpha)
    if g.fast:
        fail("phase 10: expected a position-level group")
    pp = ts.piece_plan(g.halo, g.w_chars, g.steps)
    q0, q1, t0, t1 = next(eng.chunks(g, pp))
    win = ts.descriptor(iupac, pp, False, t0, t1)
    args = (win, pp.true_start[t0:t1], g.pmasks[q0:q1], g.is_pad[q0:q1],
            g.h_init[q0:q1], g.m_real[q0:q1], g.boundary_m[q0:q1], g.eq_mode)
    got = myers_cuda.scan_q(*args)
    torch.cuda.synchronize()
    start = time.perf_counter()
    ref = myers_cuda.scan_q_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - start) * 1e3
    err = max((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
              for a, b in zip(got, ref))
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    one = all(
        all(torch.equal(a, b[q]) for a, b in zip(myers_cuda.scan(
            *args[:2], args[2][q], args[3][q], args[4][q], int(args[5][q]),
            int(args[6][q]), g.eq_mode), got))
        for q in range(q1 - q0))
    ms = cuda_ms(lambda: myers_cuda.scan_q(*args), REPS)
    NW, P, T = win.shape
    log(f"phase 10: q2 vs plain on the first of {len(list(eng.chunks(g, pp)))}"
        f" dispatch chunks: eq={g.eq_mode} Q={q1 - q0} M={g.pmasks.shape[1]} "
        f"NW={NW} P={P} T={T} (steps {g.steps}) kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bit-equal={same} max_abs_err={err}, slices "
        f"equal q1={one}")
    if not (same and one):
        fail("q2 != plain or q1")
    carry = torch.zeros((q1 - q0, 1), dtype=torch.int32, device=DEVICE)
    ranges = list(eng.select_ranges(g, pp, q1 - q0, t0, t1, "cpu"))
    # the selection of the whole chunk, as phase 11b runs it on the card
    if list(eng.select_ranges(g, pp, q1 - q0, t0, t1, "cuda")) != [(t0, t1)]:
        fail("phase 10: the card's selection is not one call a chunk")
    held = hold_chunk_selection(
        "phase 10: phase 11b's selection of the whole chunk",
        lambda: eng.select(got, g, pp, q0, t0, t1, k, False, carry),
        [(s0 - t0, s1 - t0) for s0, s1 in ranges])
    # and of its first sub-range alone, the shape the CPU path selects
    s0, s1 = ranges[0]
    part = tuple(o[..., s0 - t0 : s1 - t0] for o in got)
    held["sub_range"] = hold_engine_select(
        f"phase 10: the chunk's first sub-range, pieces {s0}..{s1}",
        lambda: eng.select(part, g, pp, q0, s0, s1, k, False, carry))
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            **bound(g.eq_mode, q1 - q0, g.pmasks.shape[1], win.shape, False),
            "select": held}


def hold_chunk_selection(label: str, run, ranges) -> dict:
    """``run()`` (BatchEngine.select over a whole dispatch chunk) with its
    chained selection call captured; the kernel over the whole chunk
    (timed over REPS calls) against the plain version chained over the
    sub-ranges ``ranges`` (chunk-local), the carry passed along (timed
    once): the columns in the same order and the carry out equal. The
    call's split by CUDA events. Returns the record."""
    import numpy as np
    import torch

    from sassy_tpu_torch.ops import minima

    state = select_state()
    with captured_selection() as calls:
        run()
    select_restore(state)
    if list(calls) != ["select_candidates_chained"]:
        fail(f"{label}: expected one chained selection call: {list(calls)}")
    a, kw = calls["select_candidates_chained"]
    T = a[0].shape[-1]

    def plain_ranges():
        cols, carry = [], a[12]
        for s0, s1 in ranges:
            part = [x[..., s0:s1] if i in (*range(9), 11) else x
                    for i, x in enumerate(a)]
            part[12] = carry
            got, carry = minima.select_candidates_chained_plain(*part, **kw)
            got[1] += s0
            cols.append(got)
        return torch.cat(cols, 1), carry

    got, got_carry = columns_and_carry(
        minima.select_candidates_chained(*a, **kw))
    ref, plain_ms = cuda_once(plain_ranges)
    ref, ref_carry = columns_and_carry(ref)
    ms = cuda_ms(lambda: minima.select_candidates_chained(*a, **kw), REPS)
    select_restore(state)
    ref = ref[:, np.lexsort(ref[::-1])]
    same = got.shape == ref.shape and bool((got == ref).all())
    same_carry = bool((got_carry == ref_carry).all())
    rec = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": 0,
           "candidates": got.shape[1], "pieces": T,
           "plain_ranges": len(ranges),
           **select_bound("select_candidates_chained", a, kw, got.shape[1])}
    log(f"{label}: select_positions_tiles (select_candidates_chained) over "
        f"Q={a[0].shape[0]} x {T} pieces of {a[0].shape[1]} words vs plain "
        f"chained over {len(ranges)} sub-ranges: {got.shape[1]} candidates, "
        f"in the same order={same}, carry out equal={same_carry}, kernel "
        f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    if not (same and same_carry):
        fail(f"{label}: the select_positions_tiles kernel over the chunk != "
             f"its plain version over the sub-ranges")
    rec["split"] = select_split(label, "select_candidates_chained", (a, kw))
    return rec


def batched_overhang(label, reads, pats, case, want, used, unused,
                     selection):
    """Phase 11a/b: search_many with overhang over the read set through
    the ``selection`` kernel; every planted copy, then the CPU path on the
    reads with other matches and a sample. Returns the launch counts of the
    main-path run."""
    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher, profiles

    alpha, k, _, hang = case
    m = len(pats[0])
    texts = list(reads)
    searcher = Searcher("iupac", rc=True, alpha=alpha, device=DEVICE)
    batched_strand_phases(label, searcher, profiles.Iupac(), pats, texts, k,
                          alpha)
    counts_zero()
    t0 = time.perf_counter()
    with captured_scans() as scans, captured_traces() as traces:
        matches = searcher.search_many(pats, texts, k)
        torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launched = counts()
    log(f"{label}: Searcher.search_many with alpha {alpha}, both strands: "
        f"{e2e:.3f} s, {len(matches)} matches, launches {launched}")
    require(launched, used, unused, label)
    got = selected(label, (selection,))
    traced(label, got, least=2)
    n_set = got["pack_set"]
    log(f"{label}: text set pack kernel launches {n_set}, plain set packs 0")
    if n_set < 2:
        fail(f"{label}: the text set's pack kernel launched {n_set} times")
    # the last dispatch chunk's launch (the reverse strand's planes)
    hold_scan(f"{label}: the last of {len(scans)} scan launches", *scans[-1])
    hold_trace(f"{label}: the forward strand", traces[0])
    del traces

    cost = int(np.floor(np.float32(alpha) * np.float32(hang)))
    cigar = f"{m - hang}="
    found = set()
    for x in matches:
        key = (x.pattern_idx, x.text_idx, x.strand.name)
        if (want.get(key) == fields(x)[:4] and x.cost == cost
                and x.cigar.to_string() == cigar):
            found.add(key)
    missing = sorted(set(want) - found)
    if missing:
        fail(f"{label}: {len(missing)} planted copies missing, e.g. "
             f"{missing[:3]}: "
             f"{[x for x in matches if x.text_idx == missing[0][1]]}")
    log(f"{label}: all {len(want)} planted copies found with their pattern, "
        f"read, strand, span, cost {cost} and cigar {cigar}")

    extra = {x.text_idx for x in matches
             if (x.pattern_idx, x.text_idx, x.strand.name) not in found}
    planted = sorted({i for _, i, _ in want})
    step = max(1, len(planted) // (OH_SAMPLE // 2))
    sample = set(planted[::step][: OH_SAMPLE // 2])
    sample |= set(range(1, len(texts), len(texts) // (OH_SAMPLE // 2)))
    reads_cpu = sorted(extra | sample)
    where = {t: i for i, t in enumerate(reads_cpu)}
    t0 = time.perf_counter()
    cpu = Searcher("iupac", rc=True, alpha=alpha, device="cpu").search_many(
        pats, [texts[t] for t in reads_cpu], k)
    t_cpu = time.perf_counter() - t0
    for x in cpu:
        x.text_idx = reads_cpu[x.text_idx]
    key = lambda x: (x.pattern_idx, x.text_idx) + fields(x)  # noqa: E731
    got = sorted(key(x) for x in matches if x.text_idx in where)
    ref = sorted(key(x) for x in cpu)
    log(f"{label}: {len(extra)} reads with other matches and "
        f"{len(reads_cpu)} reads in all against the CPU path ({t_cpu:.1f} "
        f"s): {len(got)} matches, equal={got == ref}")
    if got != ref:
        fail(f"{label}: search_many differs from the CPU path on the checked "
             "reads")
    return launched


def _equal_all(got, ref) -> tuple[bool, int]:
    """Bit equality and the largest absolute difference of two tuples of
    int32 tensors."""
    import torch

    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    err = max((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()
              for a, b in zip(got, ref))
    return same, err


def qn_family():
    """Phase 12. Returns {row: record} for the kernels line: "q" (U = 1,
    loop), "qn" (U > 1, loop), "unroll" (rows unrolled, WU = 1) and
    "unroll_w" (WU > 1), each with the launches of the tool's own run."""
    import numpy as np
    import torch

    from sassy_tpu_torch.ops import myers_cuda
    from sassy_tpu_torch.ops.myers_torch import Windows
    from sassy_tpu_torch.tools import kernel_qn, timing

    inputs = kernel_qn.read_inputs(np.random.default_rng(TOOL_SEED), DEVICE,
                                   kernel_qn.N_BARCODES,
                                   kernel_qn.BARCODE_LEN, None, None)
    res = timing.built_resources()
    members = []
    for mode in ("main", "unroll", "wunroll"):
        members += [m for m in kernel_qn.MODES[mode] if m[1:] not in
                    [x[1:] for x in members]]
    rows = {}
    for eq in ("iupac", "pure", "ascii"):
        args = inputs[eq]
        Q, M = args[2].shape[:2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = myers_cuda.scan_qn_plain(*args, eq)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        # the yardstick q2 reads the same windows through a descriptor
        q2_args = (Windows.of(args[0]), *args[1:])
        yard = myers_cuda.scan_q(*q2_args, eq)
        ms_q2 = cuda_ms(lambda: myers_cuda.scan_q(*q2_args, eq), REPS)
        b = bound(eq, Q, M, args[0].shape, False)
        log(f"phase 12: eq={eq} Q={Q} M={M} NW={args[0].shape[0]} "
            f"P={args[0].shape[1]} T={args[0].shape[2]}: plain "
            f"{plain_ms:.1f} ms, scan_q (q2) {ms_q2:.3f} ms, bound "
            f"{b['bound_ms']:.3f} ms by {b['bound_by']}")
        for name, U, unroll, WU in members:
            if eq != "iupac" and (U, unroll, WU) != (1, False, 1):
                continue
            got = myers_cuda.scan_qn(*args, eq, U, unroll, WU)
            torch.cuda.synchronize()
            same, err = _equal_all(got, ref)
            same_q2, _ = _equal_all(got, yard)
            del got
            ms = cuda_ms(lambda: myers_cuda.scan_qn(*args, eq, U, unroll, WU),
                         REPS)
            regs = timing.registers(res, "scan_qn_kernel",
                                    kernel_qn.EQ_INDEX[eq], U,
                                    M if unroll else 0, WU)
            log(f"phase 12: {name} eq={eq} U={U} unroll={unroll} WU={WU}: "
                f"kernel {ms:.3f} ms ({ms / ms_q2:.3f} of q2), registers "
                f"{regs}, bit-equal to plain={same} to q2={same_q2} "
                f"max_abs_err={err}")
            if not (same and same_q2):
                fail(f"scan_qn {name} eq={eq} != plain or q2")
            row = ("q" if (U, unroll, WU) == (1, False, 1) else "qn"
                   if not unroll else "unroll" if WU == 1 else "unroll_w")
            # the kernels line takes each row's iupac member with U = 2
            # (U = 1 for "q"): the designs the reference scripts compare
            if eq == "iupac" and U == (1 if row == "q" else 2) and (
                    row not in rows):
                rows[row] = {"ms": ms, "plain_ms": plain_ms,
                             "max_abs_err": err, **b}
        del ref, yard, q2_args
    del inputs
    torch.cuda.empty_cache()

    # the main path of these kernels: the tool's own entry point
    counts_zero()
    t0 = time.perf_counter()
    for shape in ("nanopore", "long"):
        kernel_qn.run(shape, ("main", "unroll", "wunroll"), DEVICE,
                      TOOL_SEED, log=lambda msg: log(f"phase 12: tool: {msg}"))
    launched = dict(myers_cuda.scan_qn.members)
    log(f"phase 12: tools.kernel_qn.run at both shapes in "
        f"{time.perf_counter() - t0:.1f} s, launches per (U, unroll, WU): "
        f"{ {str(k): v for k, v in sorted(launched.items())} }")
    for _, U, unroll, WU in members:
        if not launched.get((U, unroll, WU)):
            fail(f"the tool never launched scan_qn U={U} unroll={unroll} "
                 f"WU={WU}")
    pick = {"q": lambda m: m == (1, False, 1),
            "qn": lambda m: not m[1] and m[0] > 1,
            "unroll": lambda m: m[1] and m[2] == 1,
            "unroll_w": lambda m: m[1] and m[2] > 1}
    for row, rec in rows.items():
        rec["launches"] = sum(v for m, v in launched.items() if pick[row](m))
    torch.cuda.empty_cache()
    return rows


def row_step_ablations():
    """Phase 13. Returns the record of the ``full`` variant."""
    import numpy as np
    import torch

    from sassy_tpu_torch.ops import myers_cuda
    from sassy_tpu_torch.ops.myers_torch import Windows
    from sassy_tpu_torch.tools import kernel_variants, timing

    win, pm = kernel_variants.single_inputs(
        np.random.default_rng(TOOL_SEED), DEVICE, N_TEXT >> 20, None, None)
    NW, P, T = win.shape
    M = pm.shape[0]
    res = timing.built_resources()
    zeros = torch.zeros(M, dtype=torch.int32, device=DEVICE)
    # the yardstick q1 reads the same windows through a descriptor
    q1_args = (Windows.of(win),
               torch.zeros(T, dtype=torch.bool, device=DEVICE), pm, zeros,
               torch.ones_like(zeros), M, M, "iupac")
    vp_q1 = myers_cuda.scan(*q1_args)[0]
    b = bound("iupac", 1, M, win.shape, False, vp_only=True)
    log(f"phase 13: M={M} NW={NW} P={P} T={T}: the ablations' bound "
        f"{b['bound_ms']:.3f} ms by {b['bound_by']}")
    errs = {}
    for v in myers_cuda.VARIANTS:
        got = myers_cuda.scan_variant(win, pm, v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = myers_cuda.scan_variant_plain(win, pm, v)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        same, err = _equal_all((got,), (ref,))
        if v == "full":
            same = same and torch.equal(got, vp_q1)
        del got, ref
        log(f"phase 13: {v}: plain {plain_ms:.1f} ms, bit-equal={same} "
            f"max_abs_err={err}" + (" (vp equal to q1's)" if v == "full"
                                    else ""))
        if not same:
            fail(f"scan_variant {v} != plain")
        errs[v] = (plain_ms, err)
    # timed after the comparisons, in turns: the first launches after the
    # plain versions' allocations run slow
    record = None
    for turn in range(2):
        ms_q1 = cuda_ms(lambda: myers_cuda.scan(*q1_args), REPS)
        times = {v: cuda_ms(lambda: myers_cuda.scan_variant(win, pm, v), REPS)
                 for v in myers_cuda.VARIANTS}
        log(f"phase 13: turn {turn}: scan (q1) {ms_q1:.3f} ms, " + ", ".join(
            f"{v} {ms:.3f} ms" for v, ms in times.items()))
        if record is None or times["full"] < record["ms"]:
            record = {"ms": times["full"], "plain_ms": errs["full"][0],
                      "max_abs_err": errs["full"][1], **b}
    log("phase 13: registers: " + ", ".join(
        f"{v} {timing.registers(res, 'scan_variant_kernel', i)}"
        for v, i in myers_cuda.VARIANTS.items()))
    del win, pm, vp_q1, q1_args
    torch.cuda.empty_cache()

    counts_zero()
    t0 = time.perf_counter()
    kernel_variants.run("single", DEVICE, TOOL_SEED, N_TEXT >> 20,
                        log=lambda msg: log(f"phase 13: tool: {msg}"))
    launched = dict(myers_cuda.scan_variant.members)
    log(f"phase 13: tools.kernel_variants.run in "
        f"{time.perf_counter() - t0:.1f} s, launches {launched}")
    for v in myers_cuda.VARIANTS:
        if not launched.get(v):
            fail(f"the tool never launched scan_variant {v}")
    record["launches"] = sum(launched.values())
    torch.cuda.empty_cache()
    return record


def _same_matches(got, want) -> bool:
    key = lambda m: (m.pattern_idx, m.text_idx) + fields(m)  # noqa: E731
    return sorted(map(key, got)) == sorted(map(key, want))


def ascii_end_to_end(gen):
    """Phase 14: the ascii Searcher on both engines."""
    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher, profiles

    prof = profiles.Ascii(case_sensitive=False)
    n = N_TEXT
    text = (torch.randint(32, 127, (n,), generator=gen, device=DEVICE,
                          dtype=torch.int16).to(torch.uint8).cpu().numpy())
    # bytes outside the printable range, none of them in the pattern
    odd = torch.randint(0, n, (4096,), generator=gen, device=DEVICE).cpu()
    text[odd.numpy()] = np.resize(np.array([0, 255, 128, 10], np.uint8), 4096)
    pat = np.frombuffer(ASCII_PATTERN, np.uint8).copy()
    m = len(pat)
    swap = np.frombuffer(ASCII_PATTERN.swapcase(), np.uint8)
    sub = swap.copy()
    sub[MUT_AT] = ord("#")
    high = pat.copy()
    high[MUT_AT] = 0xE9
    # (offset, bytes, cost, cigar or None where only the CPU path says)
    sites = [
        (0, swap, 0, f"{m}="),
        (n // 7, sub, 1, f"{MUT_AT}=1X{m - MUT_AT - 1}="),
        (n // 3, high, 1, f"{MUT_AT}=1X{m - MUT_AT - 1}="),
        (n // 2, np.delete(pat, 9), 1, None),
        (3 * (n // 4), np.insert(swap, 20, ord("~")), 1, None),
        (n - m, pat, 0, f"{m}="),
    ]
    for off, seq, _, _ in sites:
        text[off : off + len(seq)] = seq
    searcher = Searcher(prof, rc=False, device=DEVICE)
    if searcher.engine.build_inputs(prof, prof.encode(pat), text[:SLICE],
                                    K).eq_mode != "ascii":
        fail("phase 14: the ascii search does not run the ascii eq")
    single_strand_phases("phase 14", searcher, prof, pat, text, K)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cpu = Searcher(prof, rc=False, device="cpu")
    for fn in ("search", "search_all"):
        counts_zero()
        t0 = time.perf_counter()
        matches = getattr(searcher, fn)(pat, text, K)
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        launched = counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"phase 14: Searcher(Ascii(case_sensitive=False)).{fn}, "
            f"{n >> 20} MiB: {e2e:.3f} s, {len(matches)} matches, launches "
            f"{launched}, device memory peak {peak:.2f} GiB")
        require(launched, ("q1meta",), ("q1", "q2", "q2meta", "qn",
                                        "variants"), "phase 14", least=1)
        for off, seq, cost, cigar in sites:
            lo = min(max(off - SLICE // 2, 0), n - SLICE)
            near = lambda x, base: (  # noqa: E731
                off - K <= x.text_start + base <= off + K)
            got = sorted(fields(x) for x in matches if near(x, 0))
            ref = sorted(fields(x, lo) for x in getattr(cpu, fn)(
                pat, text[lo : lo + SLICE], K) if near(x, lo))
            best = min(got, key=lambda f: f[4], default=None)
            if not got or got != ref or best[4] != cost or (
                    cigar is not None and best[6] != cigar):
                fail(f"phase 14: {fn}: planted copy at {off}: card {got}, "
                     f"CPU path on the slice {ref}, want cost {cost} cigar "
                     f"{cigar}")
            if fn == "search":
                log(f"phase 14: planted copy at {off}: found as on the CPU "
                    f"path: span {best[:2]}, cost {best[4]}, cigar {best[6]}")

    # batched: four patterns over 10 kB texts cut from the big text
    texts = list(text[: ASCII_TEXTS * READ_LEN].reshape(ASCII_TEXTS, READ_LEN)
                 .copy())
    pats = [pat, np.frombuffer(b"jumps over the lazy dog.", np.uint8),
            np.frombuffer(b"SASSY approximate search", np.uint8),
            np.frombuffer(b"0123456789 abcdefghijklm", np.uint8)]
    planted = list(range(0, ASCII_TEXTS, 97))
    for j, t in enumerate(planted):
        p = pats[j % len(pats)].copy()
        if j % 2:
            p[5] = ord("_")
        at = (j * 997) % (READ_LEN - len(p))
        texts[t][at : at + len(p)] = np.frombuffer(
            bytes(p).upper() if j % 3 == 0 else bytes(p), np.uint8)
    counts_zero()
    t0 = time.perf_counter()
    with captured_traces() as traces:
        matches = searcher.search_many(pats, texts, K)
        torch.cuda.synchronize()
    e2e = time.perf_counter() - t0
    launched = counts()
    hold_trace("phase 14: ascii search_many, the forward strand", traces[0])
    del traces
    log(f"phase 14: search_many of {len(pats)} ascii patterns over "
        f"{ASCII_TEXTS} x {READ_LEN} bytes: {e2e:.3f} s, {len(matches)} "
        f"matches, launches {launched}")
    require(launched, ("q2meta",), ("q1", "q2", "q1meta", "qn", "variants"),
            "phase 14", least=1)
    hit = {x.text_idx for x in matches}
    if not set(planted) <= hit:
        fail(f"phase 14: planted texts without a match: "
             f"{sorted(set(planted) - hit)[:5]}")
    check = sorted(hit | set(range(1, ASCII_TEXTS, ASCII_TEXTS // ASCII_SAMPLE)))
    ref = cpu.search_many(pats, [texts[t] for t in check], K)
    for x in ref:
        x.text_idx = check[x.text_idx]
    checked = set(check)
    same = _same_matches([x for x in matches if x.text_idx in checked], ref)
    log(f"phase 14: {len(check)} texts against the CPU path: {len(ref)} "
        f"matches, equal={same}")
    if not same:
        fail("phase 14: ascii search_many differs from the CPU path")


def suffix_inputs(inp):
    """``inp`` with the pattern cut to its last ``hier_s`` rows, as the
    prefilter scans it (to time that launch alone)."""
    import dataclasses

    import torch

    S = inp.hier_s
    zeros = torch.zeros(S, dtype=torch.int32, device=inp.windows.device)
    return dataclasses.replace(
        inp, pmasks=inp.pmasks[-S:].contiguous(), is_pad=zeros,
        h_init=torch.ones_like(zeros), m_real=S, boundary_m=S,
        tile0=torch.zeros_like(inp.tile0), hier_s=0)


def hier_single(gen, text):
    """Phase 15a: the single engine's suffix prefilter at 1 GiB."""
    import numpy as np
    import torch

    from sassy_tpu_torch import Searcher, profiles
    from sassy_tpu_torch.ops import plan

    m, k = HIER_SINGLE
    iupac = profiles.Iupac()
    pattern = random_acgt(gen, m).cpu().numpy()
    n = len(text)
    mutated = pattern.copy()
    mutated[MUT_AT] = ord("A") if mutated[MUT_AT] != ord("A") else ord("C")
    rc = _rc_table()
    sites = [(1000, pattern), (n // 6, mutated), (n // 2 + 77, rc(mutated)),
             (n - 3 * m, rc(pattern)), (n - m, mutated)]
    for off, seq in sites:
        text[off : off + m] = seq
    # a pattern of twice the length with the same 32 suffix rows
    longer = np.concatenate([random_acgt(gen, m).cpu().numpy(), pattern])
    text[n // 4 : n // 4 + 2 * m] = longer
    searcher = Searcher("iupac", rc=True, device=DEVICE)
    eng = searcher.engine
    default = plan.HIER_MIN_SAVED_PAIRS

    # the device path of the forward strand (scan, chain, selection) with
    # the prefilter and without, in turns, and the prefilter's steps
    prep = eng.prepare(iupac, text)
    plan.HIER_MIN_SAVED_PAIRS = 0
    for pat in (pattern, longer):
        inp = eng.build_inputs(iupac, iupac.encode(pat), prep, k)
        if inp.hier_s != plan.suffix_rows(m, k) or not inp.hier_s:
            fail(f"phase 15: expected a {plan.suffix_rows(m, k)}-row suffix, "
                 f"got {inp.hier_s}")
        ids = eng.flagged_tiles(inp)
        sub = eng.gather_tiles(inp, ids)
        suffix = suffix_inputs(inp)
        NW, _, T = inp.windows.shape
        M, S = inp.pmasks.shape[0], inp.hier_s

        def with_prefilter():
            flagged = eng.gather_tiles(inp, eng.flagged_tiles(inp))
            return eng.select(flagged, eng.scan(flagged))

        steps = {
            "prefilter on": with_prefilter,
            "prefilter off": lambda: eng.select(inp, eng.scan(inp)),
            "suffix scan + flags": lambda: eng.flagged_tiles(inp),
            "suffix kernel": lambda: eng.scan(suffix),
            "gather": lambda: eng.gather_tiles(inp, ids),
            "kernel, flagged tiles": lambda: eng.scan(sub),
            "kernel, all tiles": lambda: eng.scan(inp),
        }
        for turn in range(HIER_TURNS):
            log(f"phase 15: single, forward strand, {len(pat)} bp, turn "
                f"{turn}: M={M} S={S} eq={inp.eq_mode} T={T} NW={NW}, "
                f"{ids.numel()} flagged tiles, {(M - S) * NW * T} (row, "
                "word) pairs saved: " + ", ".join(
                    f"{name} {cuda_ms(fn, HIER_REPS):.3f} ms"
                    for name, fn in steps.items()))
        del inp, sub, suffix, steps
    del prep
    torch.cuda.empty_cache()

    results = {}
    pending = []
    for label, gate in (("on", 0), ("off", NEVER), ("on", 0), ("off", NEVER)):
        plan.HIER_MIN_SAVED_PAIRS = gate
        counts_zero()
        t0 = time.perf_counter()
        with captured_scans() as scans:
            ms = searcher.search(pattern, text, k)
            torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        launched = counts()
        if label not in results:
            # the forward strand's suffix scan over every tile, then the
            # scan of the flagged tiles (their descriptors taken): held
            # after the timed runs
            whats = (("the suffix scan", "the flagged tiles") if label == "on"
                     else ("the scan",))
            pending += [(f"phase 15: single, prefilter {label}, {what}",
                         *call) for what, call in zip(whats, scans)]
        log(f"phase 15: Searcher.search, {m} bp, k={k}, both strands, "
            f"{n >> 20} MiB, prefilter {label}: {e2e:.3f} s, {len(ms)} "
            f"matches, launches {launched}")
        if launched["q1meta"] != (4 if label == "on" else 2):
            fail(f"phase 15: prefilter {label} launched q1meta "
                 f"{launched['q1meta']} times")
        require(launched, ("q1meta",), ("q1", "q2", "q2meta", "qn",
                                        "variants"), "phase 15")
        results.setdefault(label, ms)
    plan.HIER_MIN_SAVED_PAIRS = default
    for held in pending:
        hold_scan(*held)
    del pending
    if not _same_matches(results["on"], results["off"]):
        fail("phase 15: the single prefilter changes the matches")
    starts = {x.text_start for x in results["on"]}
    if not {off for off, _ in sites} <= starts:
        fail(f"phase 15: planted copies missing: "
             f"{sorted({off for off, _ in sites} - starts)}")
    log(f"phase 15: single: prefilter on and off return the same "
        f"{len(results['on'])} matches, all {len(sites)} planted copies "
        f"among them; the gate is {default} saved pairs")


def hier_batched(gen, reads):
    """Phase 15b: the batched engine's suffix prefilter at the nanopore
    shape, and at smaller read sets."""
    import torch

    from sassy_tpu_torch import Searcher, profiles
    from sassy_tpu_torch.ops import batch, plan

    m, k = HIER_BATCH
    iupac = profiles.Iupac()
    pats = list(random_acgt(gen, HIER_Q * m).cpu().numpy().reshape(HIER_Q, m))
    rc = _rc_table()
    planted = range(5, len(reads), 501)
    for j, i in enumerate(planted):
        p = pats[j % HIER_Q].copy()
        if j % 3:
            p[MUT_AT] = ord("A") if p[MUT_AT] != ord("A") else ord("C")
        at = (j * 1009) % (READ_LEN - m)
        reads[i, at : at + m] = p if j % 2 == 0 else rc(p)
    texts = list(reads)
    searcher = Searcher("iupac", rc=True, device=DEVICE)
    default = plan.HIER_MIN_SAVED_PAIRS
    results = {}
    pending = []  # scan launches held after the timed runs
    for label, gate in (("on", 0), ("off", NEVER)):
        plan.HIER_MIN_SAVED_PAIRS = gate
        batched_strand_phases(f"phase 15: batched, prefilter {label}",
                              searcher, iupac, pats, texts, k, None)
        counts_zero()
        t0 = time.perf_counter()
        with captured_scans() as scans:
            results[label] = searcher.search_many(pats, texts, k)
            torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        launched = counts()
        whats = (("the suffix scan", "the flagged pieces") if label == "on"
                 else ("the scan",))
        pending += [(f"phase 15: batched, prefilter {label}, {what}", *call)
                    for what, call in zip(whats, scans)]
        log(f"phase 15: Searcher.search_many, {HIER_Q} x {m} bp, k={k}, both "
            f"strands, prefilter {label}: {e2e:.3f} s, "
            f"{len(results[label])} matches, launches {launched}")
        require(launched, ("q2meta",), ("q1", "q2", "q1meta", "qn",
                                        "variants"), "phase 15")
    plan.HIER_MIN_SAVED_PAIRS = default
    for held in pending:
        hold_scan(*held)
    del pending
    if not _same_matches(results["on"], results["off"]):
        fail("phase 15: the batched prefilter changes the matches")
    hit = {x.text_idx for x in results["on"]}
    if not set(planted) <= hit:
        fail(f"phase 15: planted reads without a match: "
             f"{sorted(set(planted) - hit)[:5]}")
    log(f"phase 15: batched: prefilter on and off return the same "
        f"{len(results['on'])} matches, every one of the {len(planted)} "
        f"planted reads among them; the gate is {default} saved pairs")

    # where the gate belongs: the forward strand's dispatch (windows, scans,
    # chain, selection) with the prefilter and without, in turns, for the
    # whole read set and for smaller ones
    eng = batch.BatchEngine(DEVICE)
    pcodes = [iupac.encode(p) for p in pats]
    for n_reads in (len(texts),) + HIER_FEWER_READS:
        ts = batch.TextSet(texts[:n_reads], DEVICE)
        (g,) = eng.groups(iupac, pcodes, ts, k)
        ts.planes(iupac, False)
        pp = ts.piece_plan(g.halo, g.w_chars)
        saved = sum((q1 - q0) * (g.pmasks.shape[1] - g.hier_s) * pp.NW
                    * (t1 - t0) for q0, q1, t0, t1 in eng.chunks(g, pp))

        def dispatch(gate):
            plan.HIER_MIN_SAVED_PAIRS = gate
            return eng.dispatch(iupac, ts, g, k, False, False)

        for turn in range(HIER_TURNS):
            on = cuda_ms(lambda: dispatch(0), HIER_REPS)
            off = cuda_ms(lambda: dispatch(NEVER), HIER_REPS)
            log(f"phase 15: batched dispatch, forward strand, {n_reads} "
                f"reads, turn {turn}: M={g.pmasks.shape[1]} S={g.hier_s} "
                f"pieces={pp.T} NW={pp.NW}, {saved} (row, word) pairs "
                f"saved: prefilter on {on:.3f} ms, off {off:.3f} ms")
        del ts
    plan.HIER_MIN_SAVED_PAIRS = default


def bench_loop():
    """Phase 16: bench.py's loop (bench.py:104-159) on the port, as
    ``python -m sassy_tpu_torch.tools.bench`` runs it."""
    from sassy_tpu_torch.tools import bench

    counts_zero()
    t0 = time.perf_counter()
    try:
        rec, _ = bench.run(N_TEXT, BENCH_SEED, DEVICE,
                           log=lambda msg: log(f"phase 16: {msg}"))
    except AssertionError as e:
        fail(f"phase 16: {e}")
    launched = counts()
    log(f"phase 16: tools.bench.run over {N_TEXT >> 20} MiB in "
        f"{time.perf_counter() - t0:.1f} s: {rec['value']:.2f} GB/s "
        f"(sequential median {rec['sequential_gbps']:.2f}, pipelined "
        f"{rec['pipelined_gbps']:.2f}), q1meta "
        f"{rec['q1meta_ms']['median_ms']:.3f} ms; launches {launched}")
    if not rec["async_pending"]:
        fail("phase 16: candidates_async returned after its dispatch ended")
    if launched["q1meta"] != rec["calls"] + rec["kernel_launches"]:
        fail(f"phase 16: q1meta launched {launched['q1meta']} times")
    require(launched, ("q1meta",), ("q1", "q2", "q2meta", "qn", "variants"),
            "phase 16")
    return launched["q1meta"]


def write_fasta(path: Path, names, seqs, width: int = 0) -> None:
    """FASTA of uint8 rows (or bytes), lines of ``width`` chars (0: one)."""
    import numpy as np

    with open(path, "wb") as fh:
        for name, seq in zip(names, seqs):
            fh.write(b">" + name.encode() + b"\n")
            seq = np.frombuffer(bytes(seq), np.uint8)
            if width and len(seq) % width == 0:
                lines = np.concatenate(
                    [seq.reshape(-1, width),
                     np.full((len(seq) // width, 1), 10, np.uint8)], axis=1)
                fh.write(lines.tobytes())
            else:
                fh.write(seq.tobytes() + b"\n")


@contextlib.contextmanager
def split_times(acc: dict):
    """Time one CLI run's parts into ``acc``: the batched calls
    (``Searcher._search_many_batched_async``) and the groups of units
    search / grep / filter made (``cli._groups``), the TextSet and dispatch
    calls, the host's waits for the dispatch thread (the engines'
    finish()), the Searchers' host finish (each finish's
    ``last_finish_split``, summed: the filters, the trace (on the CPU path
    its window gather, fill and walk) and the Match build, with their
    sizes), the wall, and the device's busy
    time (the CUDA kernels torch.profiler sees)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sassy_tpu_torch import cli, search
    from sassy_tpu_torch.ops import batch

    acc.update(dict.fromkeys(("dispatch", "wait"), 0.0), finish={},
               calls=0, groups=0)
    restore = []

    def timed(owner, name, key, on_result=None):
        fn = getattr(owner, name)
        restore.append((owner, name, fn))

        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            acc[key] += time.perf_counter() - t0
            return on_result(out) if on_result else out
        setattr(owner, name, wrapper)

    def timed_finish(finish):
        def waited():
            t0 = time.perf_counter()
            out = finish()
            acc["wait"] += time.perf_counter() - t0
            return out
        return waited

    timed(batch.TextSet, "__init__", "dispatch")
    timed(batch.BatchEngine, "candidates_many_async", "dispatch",
          timed_finish)

    def add_split(name):  # a Searcher method that runs a host finish
        fn = getattr(search.Searcher, name)
        restore.append((search.Searcher, name, fn))

        def wrapper(self, *a, **kw):
            try:
                return fn(self, *a, **kw)
            finally:
                for key, v in self.last_finish_split.items():
                    # seconds and sizes; a traced call's "call_id" and
                    # "spans" are no sums
                    if key != "call_id" and isinstance(v, (int, float)):
                        acc["finish"][key] = acc["finish"].get(key, 0) + v
        setattr(search.Searcher, name, wrapper)

    add_split("_finish_many_batched")
    add_split("_search_handle_rc")

    def counted(owner, name, key, gen=False):
        fn = getattr(owner, name)
        restore.append((owner, name, fn))

        def call(*a, **kw):
            acc[key] += 1
            return fn(*a, **kw)

        def groups(*a, **kw):  # the reader thread's grouping
            for g in fn(*a, **kw):
                acc[key] += 1
                yield g
        setattr(owner, name, groups if gen else call)

    counted(search.Searcher, "_search_many_batched_async", "calls")
    counted(cli, "_groups", "groups", gen=True)
    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        with prof:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                torch.cuda.synchronize()
                acc["wall"] = time.perf_counter() - t0
    finally:  # the run ends in SystemExit, as python -m does
        for owner, name, fn in restore:
            setattr(owner, name, fn)
        acc["busy"] = sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation) / 1e6


def run_main(commands, split: bool = False) -> list[dict]:
    """Each command through ``sassy_tpu_torch.cli.main`` in this process,
    its stdout and stderr captured: exit code, launch counts, output and,
    with ``split``, its ``split_times``."""
    import io

    from sassy_tpu_torch import cli

    runs = []
    for argv in commands:
        out, err, times = io.StringIO(), io.StringIO(), {}
        counts_zero()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                with (split_times(times) if split
                      else contextlib.nullcontext()):
                    code = cli.main([str(a) for a in argv])
            except SystemExit as e:
                code = e.code
        runs.append({"rc": code, "launched": counts(),
                     "stdout": out.getvalue(), "stderr": err.getvalue(),
                     "split": times})
    return runs


def cli_child(spec_path: str):
    """The subprocess side of ``run_cli``. Mode "module": the one command
    as ``python -m sassy_tpu_torch`` runs it (runpy.run_module), on this
    process's stdout and stderr; mode "main": ``run_main``. Either with
    ``split_times`` if the spec asks. Writes each run's record, and any
    module of JAX or the reference package, to the spec's result file;
    returns the last exit code."""
    import faulthandler
    import runpy

    faulthandler.dump_traceback_later(CLI_TIMEOUT - 30)
    spec = json.loads(Path(spec_path).read_text())
    result = {"runs": []}
    code = 0
    try:
        if spec["mode"] == "module":
            (argv,) = spec["commands"]
            sys.argv = ["sassy_tpu_torch", *argv]
            counts_zero()
            times = {}
            try:
                with (split_times(times) if spec["split"]
                      else contextlib.nullcontext()):
                    runpy.run_module("sassy_tpu_torch", run_name="__main__",
                                     alter_sys=True)
            except SystemExit as e:
                code = e.code
            result["runs"].append({"rc": code, "launched": counts(),
                                   "split": times})
        else:
            result["runs"] = run_main(spec["commands"], spec["split"])
    finally:
        result["imported"] = sorted(
            m for m in sys.modules if m in ("jax", "sassy_tpu")
            or m.startswith(("jax.", "sassy_tpu.")))
        Path(spec["result"]).write_text(json.dumps(result))
    return code


def run_cli(what: str, commands, mode: str = "module", expect: int = 0,
            env=None, split: bool = False):
    """Run ``commands`` (argument lists of ``python -m sassy_tpu_torch``)
    in one subprocess through ``cli_child``. Returns the process, its
    result record and its wall seconds; fails on another exit code, a
    command of mode "main" that did not exit 0, an import of JAX or the
    reference package, or no exit within ``CLI_TIMEOUT``."""
    spec, result = CLI_DIR / "spec.json", CLI_DIR / "result.json"
    result.unlink(missing_ok=True)
    spec.write_text(json.dumps({
        "mode": mode, "split": split, "result": str(result),
        "commands": [[str(a) for a in c] for c in commands]}))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _CLI_CHILD, str(spec)], cwd=ROOT,
            env=dict(os.environ, **(env or {})), capture_output=True,
            timeout=CLI_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        fail(f"{what}: no exit within {CLI_TIMEOUT} s; its stderr and "
             "threads: "
             f"{(e.stderr or b'').decode(errors='replace')[-8000:]}")
    seconds = time.perf_counter() - t0
    if proc.returncode != expect:
        fail(f"{what}: exit {proc.returncode} (want {expect}): "
             f"{proc.stderr.decode(errors='replace')[-3000:]}")
    got = json.loads(result.read_text())
    if got["imported"]:
        fail(f"{what}: JAX or the reference package was imported: "
             f"{got['imported']}")
    bad = [r["rc"] for r in got["runs"] if mode == "main" and r["rc"]]
    if bad:
        fail(f"{what}: a command exited {bad}")
    return proc, got, seconds


def require_cli(what: str, launched: dict, used: tuple,
                cpu: bool = False) -> None:
    if cpu:  # the CPU path's plain scans gather their windows
        launched = {k: v for k, v in launched.items() if k != "windows"}
    require(launched, used, tuple(k for k in launched if k not in used),
            what, least=1)


def parse_time(fasta: Path) -> tuple[int, float]:
    """Records in ``fasta`` and the seconds to parse them alone."""
    from sassy_tpu_torch.io import fastx

    t0 = time.perf_counter()
    n_recs = sum(1 for _ in fastx.read_fastx(str(fasta)))
    return n_recs, time.perf_counter() - t0


def log_split(what: str, s: dict, parsed: tuple[int, float]) -> None:
    """Log a run's ``split_times``, beside the parse of its input alone."""
    wall, busy = s["wall"], s["busy"]
    fin = s["finish"]
    finish = sum(fin.get(key, 0.0) for key in (
        "filters", "trace", "gather", "fill", "walk", "build"))
    share = (f"device busy {busy:.3f} s = {busy / wall:.2%} of the wall, "
             f"idle {1 - busy / wall:.2%}" if busy else
             "device busy time not measured (the profiler saw no kernel)")
    groups = f" over {s['groups']} groups" if s["groups"] else ""
    log(f"{what}: split (profiled): wall {wall:.3f} s from the CLI's start; "
        f"{s['calls']} batched calls{groups}; the parse of the {parsed[0]} "
        f"records alone {parsed[1]:.3f} s (on the reader thread in the "
        f"run); TextSet and dispatch calls "
        f"{s['dispatch']:.3f} s, host waits for the dispatch thread "
        f"{s['wait']:.3f} s, host finish {finish:.3f} s "
        f"({finish_split_text(fin)}), the rest (waits for the reader, "
        f"formatting, writing) "
        f"{wall - s['dispatch'] - s['wait'] - finish:.3f} s; {share}")


def crispr_genome(gen):
    """Phase 17a's guides and genome; returns (guides, genome path,
    plants): a plant is (guide index, contig name, start, strand, intact)."""
    import numpy as np

    spacers = random_acgt(gen, CRISPR_GUIDES * 20).cpu().numpy().reshape(
        CRISPR_GUIDES, 20)
    guides = [bytes(s) + b"NGG" for s in spacers]
    genome = random_acgt(gen, CRISPR_CONTIGS * CRISPR_CONTIG_BP).cpu()
    genome = genome.numpy().reshape(CRISPR_CONTIGS, CRISPR_CONTIG_BP)
    names = [f"chr{c + 1}" for c in range(CRISPR_CONTIGS)]
    plants = []
    rc = _rc_table()
    sites = [(j, off // CRISPR_CONTIG_BP, off % CRISPR_CONTIG_BP)
             for j, off in enumerate(range(CRISPR_EVERY // 2,
                                           genome.size, CRISPR_EVERY))]
    # and one copy across GenomeScan's first segment boundary
    sites.append((len(sites) * 2, 0, SEGMENT - 11))
    for j, c, at in sites:
        g = j % CRISPR_GUIDES
        spacer = bytearray(spacers[g].tobytes())
        spacer[MUT_AT] = ord("A") if spacer[MUT_AT] != ord("A") else ord("C")
        intact = j % 4 != 3
        seq = np.frombuffer(bytes(spacer) + (b"TGG" if intact else b"TCA"),
                            np.uint8)
        strand = "+" if j % 2 == 0 else "-"
        genome[c, at : at + 23] = seq if strand == "+" else rc(seq)
        plants.append((g, names[c], at, strand, intact))
    for c in range(CRISPR_CONTIGS):  # between two copies
        at = (c + 1) * CRISPR_CONTIG_BP // 6 + CRISPR_EVERY // 4
        genome[c, at : at + CRISPR_N_RUN] = ord("N")
    CLI_DIR.mkdir(parents=True, exist_ok=True)
    path = CLI_DIR / "genome.fa"
    write_fasta(path, names, genome, width=80)
    (CLI_DIR / "guides.txt").write_bytes(b"\n".join(guides) + b"\n")
    return guides, path, plants


def tsv_rows(text: bytes) -> list[list[str]]:
    return [r.split("\t") for r in text.decode().splitlines()
            if "\t" in r][1:]


def cli_crispr(gen):
    """Phase 17a. Returns (guides, genome path, plants) for phase 18."""
    guides, genome, plants = crispr_genome(gen)
    want_cigar = f"{MUT_AT}=1X{22 - MUT_AT}="
    args = ["crispr", "-g", CLI_DIR / "guides.txt", "-k", CRISPR_K,
            "--max-n-frac", "0.2"]
    out = {e: CLI_DIR / f"crispr_{e}.tsv" for e in (False, True)}
    _, got, wall = run_cli("phase 17a", [
        args + ["-o", out[False], genome],
        args + ["--allow-pam-edits", "-o", out[True], genome]],
        mode="main", split=True)
    parsed = parse_time(genome)
    log(f"phase 17a: both crispr runs in one process: {wall:.3f} s")
    for edits, run in zip((False, True), got["runs"]):
        launched = run["launched"]
        took = [ln for ln in run["stdout"].splitlines() if "Time taken" in ln]
        rows = tsv_rows(out[edits].read_bytes())
        log(f"phase 17a: crispr, {CRISPR_GUIDES} guides, "
            f"{CRISPR_CONTIGS} x {CRISPR_CONTIG_BP} bp, k={CRISPR_K}, "
            f"allow-pam-edits={edits}: {len(rows)} rows, "
            f"{took[0].strip() if took else 'no Time taken line'}, "
            f"launches {launched}")
        log_split(f"phase 17a: crispr, allow-pam-edits={edits}",
                  run["split"], parsed)
        require_cli("phase 17a", launched, ("q2meta",))
        by_site, shifted = {}, 0
        for r in rows:
            by_site.setdefault((r[0], r[1]), []).append(r)
        for g, contig, at, strand, intact in plants:
            gs = guides[g].decode()
            near = [r for r in by_site.get((gs, contig), [])
                    if int(r[4]) < at + 23 and int(r[5]) > at
                    and r[3] == strand]
            if intact:
                exact = [r for r in near if r[2:6] == [
                    "1", strand, str(at), str(at + 23)]
                    and r[7] == want_cigar]
                if len(exact) != 1:
                    fail(f"phase 17a: intact copy of guide {g} at {contig}:"
                         f"{at} ({strand}): rows {near}")
                continue
            if edits:
                if not near:
                    fail(f"phase 17a: broken-PAM copy of guide {g} at "
                         f"{contig}:{at} missing with --allow-pam-edits")
                continue
            # the copy's own end is its broken PAM; an alignment that
            # reaches past it to a 'GG' in the flank is a genuine site
            at_pam = [r for r in near
                      if int(r[5] if strand == "+" else r[4])
                      == (at + 23 if strand == "+" else at)]
            shifted += len(near) - len(at_pam)
            if at_pam:
                fail(f"phase 17a: broken-PAM copy of guide {g} at {contig}:"
                     f"{at} reported: {at_pam}")
        n_intact = sum(p[4] for p in plants)
        log(f"phase 17a: all {n_intact} intact copies found with cost 1 and "
            f"cigar {want_cigar}; the {len(plants) - n_intact} broken-PAM "
            + ("copies found too" if edits else "copies absent")
            + ("" if edits else f" ({shifted} rows over a broken copy end "
               "past its PAM)"))
    return guides, genome, plants


def agrep_text(path: Path) -> bytes:
    """Phase 17c's 1 MB of printable text in lines of 100, with copies of a
    phrase (one substitution; every third also one deletion); returns the
    phrase."""
    import numpy as np

    text = np.random.default_rng(SEED).integers(32, 127, AGREP_BYTES,
                                                 dtype=np.uint8)
    text[99::100] = ord("\n")
    phrase = b"approximate string matching"
    for j, at in enumerate(range(5_000, AGREP_BYTES - 100, 97_003)):
        seq = bytearray(phrase)
        seq[j % len(seq)] = ord("#")
        if j % 3 == 1:
            del seq[3]
        text[at : at + len(seq)] = np.frombuffer(bytes(seq), np.uint8)
    path.write_bytes(text.tobytes())
    return phrase


def cli_search(gen):
    """Phase 17b-e."""
    from sassy_tpu_torch.io import fastx

    reads, barcodes = nanopore_reads(gen, CLI_READS)
    names = [f"read{i}" for i in range(CLI_READS)]
    fa = CLI_DIR / "reads.fa"
    write_fasta(fa, names, reads)
    write_fasta(CLI_DIR / "barcodes.fa",
                [f"bc{q}" for q in range(N_BARCODES)], barcodes)
    search = ["search", "-f", CLI_DIR / "barcodes.fa", "-k", K]

    # (b) every planted copy, at the default batch bytes
    out_b = CLI_DIR / "b.tsv"
    _, got, wall = run_cli("phase 17b", [search + ["-o", out_b, fa]],
                           split=True)
    launched = got["runs"][0]["launched"]
    rows = {tuple(r) for r in tsv_rows(out_b.read_bytes())}
    log(f"phase 17b: search, {N_BARCODES} x {BARCODE_LEN} bp over "
        f"{CLI_READS} x {READ_LEN} bp, k={K}: {len(rows)} rows, process "
        f"wall {wall:.3f} s, launches {launched}")
    split = got["runs"][0]["split"]
    log_split("phase 17b: search", split, parse_time(fa))
    require_cli("phase 17b", launched, ("q2meta",))
    # one batched call a group and pattern batch
    n_batches = -(-N_BARCODES // fastx.DEFAULT_BATCH_PATTERNS)
    if not split["groups"] or split["calls"] > split["groups"] * n_batches:
        fail(f"phase 17b: {split['calls']} batched calls over "
             f"{split['groups']} groups of {n_batches} pattern batches")
    want_cigar = f"{MUT_AT}=1X{BARCODE_LEN - MUT_AT - 1}="
    for i in range(CLI_READS):
        mutated = bytearray(barcodes[i % N_BARCODES].tobytes())
        mutated[MUT_AT] = ord("A") if mutated[MUT_AT] != ord("A") else ord("C")
        row = (f"bc{i % N_BARCODES}", names[i], "1", "+-"[i % 2],
               str(PLANT_AT), str(PLANT_AT + BARCODE_LEN), mutated.decode(),
               want_cigar)
        if row not in rows:
            fail(f"phase 17b: planted copy missing: {row}")
    log(f"phase 17b: all {CLI_READS} planted copies in the TSV with cost 1 "
        f"and cigar {want_cigar}")

    # (c) the card against the CPU, byte for byte: the six commands, then
    # (e) test and (d)'s run without interruption, in one process on the
    # card, through sassy_tpu_torch.cli.main; the six on the CPU in this
    # process
    sub = CLI_DIR / "subset.fa"
    write_fasta(sub, names[:CLI_SUBSET], reads[:CLI_SUBSET])
    phrase = agrep_text(CLI_DIR / "text.txt")
    cases = {
        "search": search + [sub],
        "search --sam": search + ["--sam", sub],
        "search --overhang 0.5": search + ["--overhang", "0.5", sub],
        "grep": ["grep", "-f", CLI_DIR / "barcodes.fa", "-k", K, sub],
        "filter -v": ["filter", "-v", "-p", barcodes[0].tobytes().decode(),
                      "-k", K, sub],
        "agrep": ["agrep", phrase.decode(), "3", CLI_DIR / "text.txt"],
    }
    flags = search + ["--batch-bytes", RESUME_BATCH]
    full = CLI_DIR / "d_full.tsv"
    _, card, t_card = run_cli(
        "phase 17c (card)", [["--device", "cuda"] + a for a in cases.values()]
        + [["test"], flags + ["-o", full, fa]], mode="main")
    t0 = time.perf_counter()
    cpu = run_main([["--device", "cpu"] + a for a in cases.values()])
    t_cpu = time.perf_counter() - t0
    log(f"phase 17c: the six commands, test and (d)'s run in one process on "
        f"the card {t_card:.3f} s; the six on the CPU {t_cpu:.3f} s")
    for name, a, b in zip(cases, card["runs"], cpu):
        require_cli(f"phase 17c {name} (card)", a["launched"], ("q2meta",))
        require_cli(f"phase 17c {name} (cpu)", b["launched"], (), cpu=True)
        same = (a["stdout"], a["stderr"], a["rc"]) == (
            b["stdout"], b["stderr"], b["rc"])
        log(f"phase 17c: {name}: stdout {len(a['stdout'])} chars, stderr "
            f"{len(a['stderr'])} chars, card and cpu equal={same}")
        if not same or len(a["stdout"]) + len(a["stderr"]) < 200:
            fail(f"phase 17c: {name}: the card and the CPU differ "
                 f"(stdout equal {a['stdout'] == b['stdout']}, stderr equal "
                 f"{a['stderr'] == b['stderr']}) or print nothing")

    # (e) test
    test = card["runs"][len(cases)]
    lines = test["stdout"].splitlines()
    log("phase 17e: test: " + " | ".join(lines)
        + f" (launches {test['launched']})")
    if not any(ln.startswith("engine:") and "cuda kernels" in ln
               for ln in lines):
        fail("phase 17e: test did not run the cuda kernels")
    require_cli("phase 17e", test["launched"], ("q1meta",))

    # (d) --resume: killed after unit RESUME_CRASH, rerun as a new process,
    # equal to the run without interruption (and to (b)'s, whose batches
    # were smaller)
    out, ck = CLI_DIR / "d.tsv", CLI_DIR / "d.json"
    resume = flags + ["-o", out, "--resume", ck, fa]
    _, _, t_crash = run_cli(
        "phase 17d", [resume], expect=130,
        env={"SASSY_CRASH_AFTER_UNIT": str(RESUME_CRASH)})
    done = json.loads(ck.read_text())["unit"]
    _, got, t_resume = run_cli("phase 17d", [resume])
    launched = got["runs"][0]["launched"]
    same = out.read_bytes() == full.read_bytes()
    log(f"phase 17d: --batch-bytes {RESUME_BATCH}: killed after unit "
        f"{RESUME_CRASH} (exit 130, checkpoint at unit {done}) in "
        f"{t_crash:.3f} s; resumed in {t_resume:.3f} s (launches "
        f"{launched}); TSV equal to the uninterrupted run's: {same}")
    require_cli("phase 17d", launched, ("q2meta",))
    if not same or done != RESUME_CRASH:
        fail("phase 17d: the resumed TSV differs from the uninterrupted one")
    if full.read_bytes() != out_b.read_bytes():
        fail("phase 17d: the TSV at 4 MiB batches differs from (b)'s")


def genome_scan(guides, genome: Path, plants):
    """Phase 18: GenomeScan on the card over phase 17a's genome."""
    import torch

    from sassy_tpu_torch import Searcher
    from sassy_tpu_torch.io import fastx
    from sassy_tpu_torch.scan import GenomeScan

    guide = guides[0]
    searcher = Searcher("iupac", rc=True, device=DEVICE).with_max_n_frac(0.2)
    searcher.search(guide, guide * 4, CRISPR_K)
    out, ck = CLI_DIR / "scan.tsv", CLI_DIR / "scan.json"
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counts_zero()
    t0 = time.perf_counter()
    total = GenomeScan(searcher, SEGMENT, str(ck)).scan(
        str(genome), [guide], CRISPR_K, str(out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    after = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    units = json.loads(ck.read_text())["unit"]
    log(f"phase 18: GenomeScan, one guide, k={CRISPR_K}, segments of "
        f"{SEGMENT} chars: {units} units, {total} rows in {wall:.3f} s; "
        f"device memory allocated {before} before, {after} after "
        f"({(after - before) / 2**20:+.1f} MiB; peak during the scan "
        f"{(peak - before) / 2**20:.1f} MiB above), prepared texts cached "
        f"{len(searcher.engine._prep_cache)}; launches {launched}")
    require(launched, ("q1meta",), ("q1", "q2", "q2meta", "qn", "variants"),
            "phase 18")
    if abs(after - before) > SCAN_MEM_SLACK:
        fail("phase 18: the scan left the dead segments' prepared texts on "
             "the card")
    rows = set(out.read_text().splitlines()[1:])
    want = set()
    t0 = time.perf_counter()
    for rec in fastx.read_fastx(str(genome)):
        for m in searcher.search(guide, rec.seq, CRISPR_K):
            want.add(f"0\t{rec.rid}\t{m.cost}\t{m.strand}\t{m.text_start}"
                     f"\t{m.text_end}")
    t_whole = time.perf_counter() - t0
    planted = {f"0\t{c}\t1\t{s}\t{at}\t{at + 23}"
               for g, c, at, s, intact in plants if g == 0 and intact}
    log(f"phase 18: Searcher.search over each whole contig: {len(want)} "
        f"rows in {t_whole:.3f} s; equal={rows == want}; the "
        f"{len(planted)} intact copies of the guide (one across a segment "
        f"boundary) among them: {planted <= rows}")
    if rows != want or len(rows) != total:
        fail(f"phase 18: GenomeScan rows differ from whole-contig search: "
             f"{sorted(rows ^ want)[:6]}")
    if not planted <= rows:
        fail(f"phase 18: planted copies missing: {sorted(planted - rows)}")


#: phase 19's sitecustomize: in a process that imports it (through
#: PYTHONPATH: the examples, the C ABI's embedded interpreter), every
#: counted kernel wrapper writes the launch counts, and the modules of JAX
#: or the reference package imported so far, to $SASSY_SMOKE_COUNTS
_COUNTING_SITE = '''
import atexit, functools, json, os, sys, time

_OUT = os.environ.get("SASSY_SMOKE_COUNTS")
if _OUT:
    from sassy_tpu_torch.ops import myers_cuda as _mc
    from sassy_tpu_torch.ops import myers_torch as _mt

    _T0 = time.perf_counter()
    _NAMES = {"q1meta": "scan_meta", "q2meta": "scan_q_meta", "q1": "scan",
              "q2": "scan_q", "qn": "scan_qn", "variants": "scan_variant"}

    def _dump():
        with open(_OUT, "w") as fh:
            json.dump({"launched": {**{k: getattr(_mc, v).launches
                                       for k, v in _NAMES.items()},
                                    "windows": _mt.windows_plain.calls},
                       "imported": sorted(
                           m for m in sys.modules if m in ("jax", "sassy_tpu")
                           or m.startswith(("jax.", "sassy_tpu."))),
                       "seconds": time.perf_counter() - _T0}, fh)

    def _counted(fn):
        @functools.wraps(fn)  # copies .launches, which fn now increments
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            _dump()
            return out
        return wrapper

    for _v in _NAMES.values():
        setattr(_mc, _v, _counted(getattr(_mc, _v)))
    _dump()
    atexit.register(_dump)  # the interpreter's wall, where it exits
'''


def counted_env(tag: str, **extra) -> tuple[dict, Path]:
    """The environment of a phase-19 subprocess whose launch counts go to
    the returned file (``_COUNTING_SITE``), and that finds the port and
    this interpreter's packages (the C ABI's embedded interpreter too)."""
    site = P19_DIR / "site"
    site.mkdir(parents=True, exist_ok=True)
    (site / "sitecustomize.py").write_text(_COUNTING_SITE)
    out = P19_DIR / f"counts_{tag}.json"
    out.unlink(missing_ok=True)
    path = os.pathsep.join([str(site), str(ROOT), *filter(None, sys.path)])
    env = dict(os.environ, PYTHONPATH=path, SASSY_SMOKE_COUNTS=str(out))
    env.pop("SASSY_DEVICE", None)
    env.update(extra)
    return env, out


def read_counts(what: str, path: Path) -> tuple[dict, float]:
    """A ``_COUNTING_SITE`` record: the launches and the interpreter's
    seconds; fails if it imported JAX or the reference package."""
    if not path.exists():
        fail(f"{what}: wrote no launch counts")
    got = json.loads(path.read_text())
    if got["imported"]:
        fail(f"{what}: JAX or the reference package was imported: "
             f"{got['imported']}")
    return got["launched"], got["seconds"]


def masked_lines(text: str) -> list[str]:
    """An example's printed lines with timings and temporary paths
    masked."""
    import re

    text = re.sub(r" +\d+\.\d+ ?m?s", " <time>", text)
    return re.sub(r"\(checkpoint: [^)]*\)", "(checkpoint)",
                  text).splitlines()


def example_runs(name: str) -> list[tuple[str, str, bool]]:
    """(tag, device, small) of phase 19's processes of one example: on the
    card and with --device cpu; modes' CPU run (512 single searches on the
    plain versions' Python loops at full size) and a second card run to
    compare it with take ``MODES_SMALL``."""
    if name == "modes":
        return [("modes_cuda", "cuda", False), ("modes_cuda_small", "cuda",
                                                True),
                ("modes_cpu", "cpu", True)]
    return [(f"{name}_cuda", "cuda", False), (f"{name}_cpu", "cpu", False)]


def start_examples() -> dict:
    """Phase 19's example processes, all started at once: each of
    ``EXAMPLES`` on the card and with --device cpu (one thread: the CPU
    runs are the plain versions' Python loops)."""
    procs = {}
    for name in EXAMPLES:
        for tag, dev, small in example_runs(name):
            extra = {"OMP_NUM_THREADS": "1"} if dev == "cpu" else {}
            env, out = counted_env(tag, **extra)
            cmd = (["-c", _MODES_SMALL, dev] if small else
                   ["-m", f"sassy_tpu_torch.examples.{name}", "--device",
                    dev])
            with open(P19_DIR / f"{tag}.out", "w") as so, \
                    open(P19_DIR / f"{tag}.err", "w") as se:
                procs[tag] = (subprocess.Popen(
                    [sys.executable, *cmd], cwd=ROOT, env=env, stdout=so,
                    stderr=se), out)
    return procs


def finish_examples(procs: dict) -> dict:
    """Wait for ``start_examples``' processes: each exits 0 without JAX,
    the card's match lines equal the CPU's (modes: at ``MODES_SMALL``),
    the card's runs launch their kernels (``EXAMPLES``), the CPU's none.
    Returns the card runs' launches summed."""
    done = {}
    for tag, (proc, out) in procs.items():
        proc.wait(timeout=900)
        stdout = (P19_DIR / f"{tag}.out").read_text()
        stderr = (P19_DIR / f"{tag}.err").read_text()
        if proc.returncode != 0:
            fail(f"phase 19: example {tag} exited {proc.returncode}: "
                 f"{stderr[-3000:]}")
        done[tag] = (stdout, *read_counts(f"phase 19: example {tag}", out))
    total = dict.fromkeys(counts(), 0)
    for name in EXAMPLES:
        runs = example_runs(name)
        cards = [t for t, dev, _ in runs if dev == "cuda"]
        for tag in cards:
            gpu, gl, gs = done[tag]
            log(f"phase 19: example {tag}: {gs:.1f} s (after the import); "
                f"launches {gl}")
            log("\n".join(f"  | {line}" for line in gpu.splitlines()))
            require(gl, EXAMPLES[name], ("q1", "q2", "qn", "variants"),
                    f"phase 19 example {tag}", least=1)
            for k, v in gl.items():
                total[k] += v
        cpu_tag, small = next((t, sm) for t, dev, sm in runs if dev == "cpu")
        gpu_tag = next(t for t, dev, sm in runs
                       if dev == "cuda" and sm == small)
        gpu, cpu = done[gpu_tag][0], done[cpu_tag][0]
        cl, cs = done[cpu_tag][1:]
        log(f"phase 19: example {cpu_tag}: {cs:.1f} s (after the import)")
        if masked_lines(gpu) != masked_lines(cpu):
            fail(f"phase 19: example {name} prints other matches on the "
                 f"card than on the CPU:\n{gpu}\n---\n{cpu}")
        # the CPU path's plain scans gather their windows
        cl = {k: v for k, v in cl.items() if k != "windows"}
        require(cl, (), tuple(cl), f"phase 19 example {cpu_tag}")
    return total


def c_abi() -> dict:
    """The port's C ABI built with g++ into build/, its example run on the
    card (SASSY_DEVICE unset: the default, cuda) as tests/test_c_abi.py
    expects of the JAX package's."""
    from sassy_tpu_torch import capi

    t0 = time.perf_counter()
    lib, example = capi.build()
    t_build = time.perf_counter() - t0
    env, out = counted_env("c_abi")
    t0 = time.perf_counter()
    proc = subprocess.run([str(example)], cwd=P19_DIR, env=env,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"phase 19: the C ABI example exited {proc.returncode}: "
             f"{proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    launched, _ = read_counts("phase 19: the C ABI example", out)
    log(f"phase 19: C ABI {lib.name} and {example.name} built in "
        f"{t_build:.1f} s; the example on the card in {wall:.1f} s, "
        f"launches {launched}:")
    log("\n".join(f"  | {line}" for line in proc.stdout.splitlines()))
    for want in ("matches: 3", "[3, 7) cost=0 strand=+", "strand=-"):
        if want not in proc.stdout:
            fail(f"phase 19: the C ABI example did not print {want!r}")
    require(launched, ("q1meta",), ("q1", "q2", "q2meta", "qn", "variants"),
            "phase 19 C ABI", least=1)
    return launched


def refcost_build() -> None:
    """The port's refcost oracle builds into build/, and native/ (the JAX
    package's) stays byte for byte as it was."""
    from sassy_tpu_torch import profiles, refcost

    native = ROOT / "native"
    before = {p.name: p.read_bytes() for p in native.iterdir()}
    t0 = time.perf_counter()
    lib = refcost.build()
    ok = refcost.load() is not None
    t_build = time.perf_counter() - t0
    after = {p.name: p.read_bytes() for p in native.iterdir()}
    log(f"phase 19: refcost {lib.relative_to(ROOT)} built in "
        f"{t_build:.1f} s; native/ unchanged: {after == before}")
    if not ok or lib.parent != ROOT / "build" / "sassy_tpu_torch":
        fail(f"phase 19: refcost did not build into build/: {lib}")
    if after != before:
        fail("phase 19: the refcost build changed native/")
    if refcost.edit_distance(profiles.Dna(), b"ACGT", b"AGT") != 1:
        fail("phase 19: refcost edit distance is wrong")


def eval_rows(path: Path) -> tuple[list[str], list[dict]]:
    import csv

    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    return rows[0], [dict(zip(rows[0], r)) for r in rows[1:]]


def evals() -> dict:
    """The port's evals harness in this process on the card: nanopore at
    full scale (64 Mbp), the others at ``EVAL_SCALE``, one rep. Each CSV
    has the reference's header, search and tiling count the same matches,
    the batched rows have edlib columns, nanopore counts what the v5e
    CSV counts, and each bench launched its kernel."""
    from sassy_tpu_torch.evals import bench_suite

    want_header = (ROOT / "evals" / "output-v5e" / "nanopore_results.csv"
                   ).read_text().splitlines()[0].split(",")
    out = P19_DIR / "evals"
    total = dict.fromkeys(counts(), 0)
    for name, scale in [("nanopore", 1.0)] + [(b, EVAL_SCALE)
                                             for b in EVAL_SMALL]:
        counts_zero()
        t0 = time.perf_counter()
        bench_suite.main([name, "--out", str(out), "--scale", str(scale),
                          "--reps", "1", "--device", DEVICE])
        wall = time.perf_counter() - t0
        launched = counts()
        header, rows = eval_rows(out / f"{name}_results.csv")
        log(f"phase 19: evals {name} at scale {scale}: {len(rows)} rows in "
            f"{wall:.1f} s, launches {launched}")
        for r in rows:
            log(f"  | q={r['num_queries']} n={r['target_len']} "
                f"m={r['query_len']} k={r['k']}: search "
                f"{r['search_median_ms']} ms {r['search_throughput_gbps']} "
                f"GB/s {r['search_n_matches']}, tiling "
                f"{r['tiling_median_ms']} ms {r['tiling_throughput_gbps']} "
                f"GB/s {r['tiling_n_matches']}, edlib "
                f"{r['edlib_throughput_gbps']} GB/s")
        if header != want_header:
            fail(f"phase 19: {name}'s CSV header differs from the "
                 f"reference's: {header}")
        if not rows:
            fail(f"phase 19: {name} wrote no rows")
        single = name.startswith("throughput")
        for r in rows:
            if r["search_n_matches"] != r["tiling_n_matches"] and not single:
                fail(f"phase 19: {name}: search and tiling counts differ: "
                     f"{r}")
            if not single and not float(r["edlib_median_ms"]) > 0:
                fail(f"phase 19: {name}: no edlib column: {r}")
        if name == "nanopore":
            got = {int(r["k"]): (int(r["search_n_matches"]),
                                 int(r["tiling_n_matches"])) for r in rows}
            if got != {k: (v, v) for k, v in NANOPORE_WANT.items()}:
                fail(f"phase 19: nanopore counts {got}, want "
                     f"{NANOPORE_WANT} in both columns")
        used = ("q1meta",) if single else ("q2meta",)
        require(launched, used, ("q1", "q2", "qn", "variants"),
                f"phase 19 evals {name}", least=1)
        for k, v in launched.items():
            total[k] += v
    return total


def evals_and_surfaces() -> dict:
    """Phase 19: refcost, the evals harness, the C ABI and the examples on
    the card. Returns the launches of the whole phase."""
    shutil.rmtree(P19_DIR, ignore_errors=True)
    P19_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    procs = start_examples()
    try:
        refcost_build()
        launched = evals()
        for part in (c_abi(), finish_examples(procs)):
            for k, v in part.items():
                launched[k] += v
    finally:
        for proc, _ in procs.values():
            proc.kill()  # none is left running, whatever failed
    log(f"phase 19: {time.perf_counter() - t0:.1f} s, launches {launched}")
    shutil.rmtree(P19_DIR, ignore_errors=True)
    return launched


def shard_span(n: int, m: int, k: int, alpha, Dt: int) -> tuple[int, int]:
    """(positions a shard owns, positions of its left halo H) as
    ``ShardedSearch`` sizes them for one search."""
    from sassy_tpu_torch import semantics
    from sassy_tpu_torch.ops import plan

    steps = semantics.overhang_steps(m, k, alpha, None)
    H = plan.next_pow2(plan.cdiv(plan._bucket_rows(m) + k, 32))
    S = max(plan.cdiv(max(1, plan.cdiv(n + steps, 32)), Dt), H + 1)
    return S * 32, H * 32


def put(text, end: int, seq) -> None:
    """``seq`` into the (device) text so that it ends at position ``end``."""
    import torch

    text[end - len(seq) : end] = torch.from_numpy(seq).to(text.device)


def plant_edges(text, pats, span: int, halo: int, Dt: int,
                last: tuple = ()) -> list[tuple]:
    """A mutated copy of pattern ``d % Q`` ending inside the first ``halo``
    positions of each shard d >= 1 (its left context lies in shard d - 1),
    at the last of them for the shards in ``last``. Returns [(pattern,
    end)]."""
    sites = []
    for d in range(1, Dt):
        end = d * span + (halo if d in last else 1 + (7 * d) % halo)
        put(text, end, mutated(pats[d % len(pats)]))
        sites.append((d % len(pats), end))
    return sites


@contextlib.contextmanager
def no_plain(what: str = "phase 20"):
    """The plain scans, selections, packs and traceback refuse to run:
    phase 20's sharded runs and phase 21's tools go through the kernels
    only."""
    from sassy_tpu_torch import traceback
    from sassy_tpu_torch.ops import batch, minima, myers_cuda, myers_torch

    names = [(myers_cuda, name) for name in (
        "scan_meta_plain", "scan_q_meta_plain", "scan_plain",
        "scan_q_plain")]
    names += [(minima, name + "_plain") for name in SELECT_ENTRIES]
    names += [(myers_torch, "pack_plain"), (batch, "pack_set_plain"),
              (traceback, "trace_plain")]
    saved = {(mod, name): getattr(mod, name) for mod, name in names}

    def refuse(name):
        def plain(*a, **kw):
            fail(f"{what} called the plain version {name}")
        plain.calls = 0
        return plain

    for mod, name in names:
        setattr(mod, name, refuse(name))
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


#: phase 20's scan launches to hold after its timed runs (sharded_run)
SHARD_HOLDS = []


def sharded_run(label: str, ss, text, pats, k: int, alpha, used: tuple,
                want: list, n: int, hold=None) -> tuple[list, dict]:
    """One sharded search with its steps timed: only the scan kernels
    ``used`` launched, once per slot at least, and the selection kernel of
    its level, no plain version; the lists equal ``want`` and pass the
    owner-computes checks. With ``hold`` (what, a ``captured_selection``
    keep, a check of the call it kept), a second run, untimed and with
    its launches not counted, captures the selection call the keep picks,
    the check holds for it, and the call is held against its plain
    version. Returns the lists and the launches."""
    import torch

    from sassy_tpu_torch import graft_entry, profiles, semantics

    prof = profiles.Iupac()
    counts_zero()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with no_plain(), captured_scans() as scans:
        got = ss.candidates_batch(prof, pats, text, k, alpha=alpha)
    wall = time.perf_counter() - t0
    launched = counts()
    slots = ss.mesh.size
    require(launched, used, tuple(x for x in launched if x not in used),
            label, least=slots)
    selected(label, ("select_words_chained" if alpha is None
                     else "select_positions",))
    # the last slot's scan on its descriptors (its planes past the
    # others), held after phase 20's timed runs
    SHARD_HOLDS.append((f"{label}: the last of {len(scans)} scan launches",
                        *scans[-1]))
    steps = semantics.overhang_steps(len(pats[0]), k, alpha, None)
    n_cands = graft_entry.check_sharded_case(ss, got, want, n, steps)
    split = ", ".join(f"{step} {sec * 1e3:.1f} ms"
                      for step, sec in ss.last_times.items())
    log(f"{label}: {len(pats)} x {len(pats[0])} bp, k={k}, alpha {alpha}, "
        f"{ss.mesh.n_pat} x {ss.mesh.n_text} slots: {wall * 1e3:.1f} ms "
        f"({split}); {n_cands} candidates, equal to the single-device "
        f"engine's; launches {launched}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if hold is not None:
        state = select_state()
        with captured_selection(hold[1]) as calls, no_plain():
            again = ss.candidates_batch(prof, pats, text, k, alpha=alpha)
        select_restore(state)
        if again != got or len(calls) != 1:
            fail(f"{label}: the second run differed, or no selection call "
                 f"to hold: {list(calls)}")
        ((name, call),) = calls.items()
        if not hold[2](*call):
            fail(f"{label}: the selection call kept is not {hold[0]}")
        log(f"{label}: the second run's steps (the capture on): "
            + ", ".join(f"{step} {sec * 1e3:.1f} ms"
                        for step, sec in ss.last_times.items()))
        hold_selection(f"{label}, {hold[0]} {call[1]}", name, call)
    return got, launched


def single_lists(eng, prep, pats, k: int, alpha) -> list:
    """The card's single engine over the prepared text, per pattern."""
    from sassy_tpu_torch import profiles

    prof = profiles.Iupac()
    return [eng.candidates(prof, prof.encode(p), prep, k, alpha, None, False)
            for p in pats]


def step_plateau(text, edge: int) -> tuple[int, int]:
    """For an all-'A' pattern: a run of 'A' with a 'C' at index edge - 6
    and another 11 later, so that the cost steps 0 -> 1 at position
    edge - 5, stays 1 across the shard edge and steps to 2 at edge + 6. The
    flat stretch (edge - 5, edge + 5] is no local minimum: the shard after
    the edge must take the rising state from the one before it. Returns
    (first, last) end position of the stretch."""
    text[edge - 400 : edge + 8] = ord("A")
    text[edge - 6] = ord("C")
    text[edge + 5] = ord("C")
    return edge - 5, edge + 5


def sharded_one_process(gen) -> dict:
    """Phase 20a. Returns the launches of its runs."""
    import torch

    from sassy_tpu_torch import profiles, semantics
    from sassy_tpu_torch.ops.myers_torch import TorchEngine
    from sassy_tpu_torch.parallel import ShardedSearch, ShardedText, make_mesh

    Dp, Dt = SHARD_GRID
    n = SHARD_TEXT
    Q8, Q1, Qa = SHARD_Q
    m_long, k_long = SHARD_LONG
    prof = profiles.Iupac()
    eng = TorchEngine(DEVICE)
    mesh = make_mesh(Dt, Dp, device=DEVICE)
    total = dict.fromkeys(counts(), 0)
    hang = 4

    def patterns(q, m):
        return list(random_acgt(gen, q * m).cpu().numpy().reshape(q, m))


    runs = [("phase 20a q2meta", patterns(Q8, PATTERN_LEN), K, None,
             ("q2meta",), None),
            ("phase 20a q1meta", patterns(Q1, PATTERN_LEN), K, None,
             ("q1meta",), None),
            ("phase 20a overhang q2", patterns(Qa, PATTERN_LEN), K,
             SHARD_ALPHA, ("q2",), None),
            ("phase 20a overhang q1", patterns(Q1, PATTERN_LEN), K,
             SHARD_ALPHA, ("q1",), None),
            ("phase 20a prefilter", patterns(1, m_long), k_long, None,
             ("q1meta",), (True, False))]
    for label, pats, k, alpha, used, hiers in runs:
        t0 = time.perf_counter()
        text = random_acgt(gen, n)
        span, halo = shard_span(n, len(pats[0]), k, alpha, Dt)
        extra = ""
        if label.endswith("q1meta"):
            # pattern 1 is all 'A': a step of equal costs across edge 2, and
            # a plateau of cost 0 across edge 1 whose right end shard 1 owns
            # (its decreasing state comes from shard 0); pattern 0's copies
            # end after them
            pats[1][:] = ord("A")
            flat = step_plateau(text, 2 * span)
            text[span - 200 : span + 9] = ord("A")
            extra = f"; a step plateau at {flat}"
            sites = plant_edges(text, pats[:1], span, halo, Dt, last=(1, 2))
        else:
            sites = plant_edges(text, pats, span, halo, Dt)
        torch.cuda.synchronize()
        t_make = time.perf_counter() - t0
        if alpha is not None:
            # exact copies hanging off the text's start and end
            put(text, len(pats[0]) - hang, pats[0][hang:])
            put(text, n, pats[1][: len(pats[0]) - hang])
        t0 = time.perf_counter()
        prep = eng.prepare(prof, text)
        want = single_lists(eng, prep, pats, k, alpha)
        t_single = time.perf_counter() - t0
        log(f"{label}: {n} bases made and planted in {t_make:.2f} s, shards "
            f"of {span} positions{extra}; the single engine's "
            f"{len(pats)} searches {t_single:.1f} s")
        st = ShardedText(prof, text)
        lists = []
        # a slot past the first shard, with its owned range and the state
        # the shards before it pass on
        later = (lambda name, a, kw: kw.get("min_pos", 0) > 0
                 and kw.get("state0") is not None)
        hold = (("a slot of a later shard", later,
                 lambda a, kw: later(None, a, kw))
                if label.endswith("overhang q2") else None)
        for hier in hiers or (None,):
            ss = ShardedSearch(mesh=mesh, hier=hier, timed=True)
            tag = (label if hier is None
                   else f"{label} {'on' if hier else 'off'}")
            got, launched = sharded_run(tag, ss, st, pats, k, alpha, used,
                                        want, n, hold)
            lists.append(got)
            for key, v in launched.items():
                total[key] += v
            if hier and launched["q1meta"] <= mesh.size:
                fail(f"{tag}: the forced prefilter launched no suffix scan")
        if any(other != lists[0] for other in lists[1:]):
            fail(f"{label}: the prefilter changed the lists")
        got = lists[0]
        for q, end in sites:
            if (end, 1) not in got[q]:
                fail(f"{label}: the copy of pattern {q} ending at {end}, "
                     "across a shard edge, did not come back with cost 1")
        if label.endswith("q1meta"):
            if any(flat[0] <= e <= flat[1] for e, _ in got[1]):
                fail(f"{label}: an end of the step plateau {flat} was "
                     f"reported: {got[1]}")
            if not any(span < e <= span + halo and c == 0
                       for e, c in got[1]):
                fail(f"{label}: the plateau across edge 1 did not end in "
                     f"shard 1: {got[1]}")
        if alpha is not None:
            # the overshoot cost of the 4 chars that hang off
            cost = semantics.overshoot_cost(alpha, hang)
            if ((len(pats[0]) - hang, cost) not in got[0]
                    or (n + hang, cost) not in got[1]):
                fail(f"{label}: the copies hanging off the text's ends did "
                     f"not come back with cost {cost}: {got[0][:3]} "
                     f"{got[1][-3:]}")
        del text, prep, st
        torch.cuda.empty_cache()
    return total


def random_acgt_chunked(gen, n: int):
    """``n`` random bases on the card, drawn 2^28 at a time."""
    import torch

    out = torch.empty(n, dtype=torch.uint8, device=DEVICE)
    bases = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=DEVICE)
    for c0 in range(0, n, 1 << 28):
        c1 = min(n, c0 + (1 << 28))
        out[c0:c1] = bases[torch.randint(0, 4, (c1 - c0,), generator=gen,
                                         device=DEVICE)]
    return out


def sharded_past_2g(gen) -> dict:
    """Phase 20b. Returns the launches."""
    import torch

    from sassy_tpu_torch import profiles
    from sassy_tpu_torch.ops.batch import BatchEngine
    from sassy_tpu_torch.parallel import ShardedSearch, make_mesh

    n = SHARD_BIG
    t0 = time.perf_counter()
    text = random_acgt_chunked(gen, n)
    raw = random_acgt(gen, 4 * PATTERN_LEN).cpu().numpy()
    pats = list(raw.reshape(4, PATTERN_LEN))
    past = SHARD_PAST
    ends = [past + 10, past + (n - past) // 4 + 345,
            past + (n - past) // 2 + 777, n - 1000]
    for q, end in enumerate(ends):
        put(text, end, mutated(pats[q]))
    torch.cuda.synchronize()
    log(f"phase 20b: {n} bases made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    prof = profiles.Iupac()
    t0 = time.perf_counter()
    host = text.cpu().numpy()
    dense = BatchEngine(DEVICE).candidates_many(
        prof, [prof.encode(p) for p in pats], [host], K)
    want = [list(row[0]) for row in dense]
    log(f"phase 20b: BatchEngine over the one text in "
        f"{time.perf_counter() - t0:.1f} s (host copy included)")
    del host
    ss = ShardedSearch(mesh=make_mesh(SHARD_BIG_DT, 1, device=DEVICE),
                       timed=True)
    # the slots select in order, one call each: the last is the last text
    # shard's, which holds the positions past 2^31 (chosen on the host:
    # the keep runs inside the search); checked on its pos_base after
    seen = []

    def last_slot(name, a, kw):
        seen.append(name)
        return len(seen) == SHARD_BIG_DT

    got, launched = sharded_run(
        "phase 20b past 2^31", ss, text, pats, K, None, ("q2meta",), want, n,
        ("the slot past 2^31", last_slot,
         lambda a, kw: int(a[10].max()) > past))
    for q, end in enumerate(ends):
        if (end, 1) not in got[q]:
            fail(f"phase 20b: the copy ending at {end} (past {past}) did "
                 "not come back with cost 1")
    log(f"phase 20b: every copy ending past {past} found: {ends}")
    del text
    torch.cuda.empty_cache()
    return launched


def shard_child(addr: str, rank: str, nproc: str, device: str) -> int:
    """A rank of phase 20c: joins the job over gloo, searches the text and
    patterns of P20_DIR on its slots of ``device``, writes its lists, its
    launches and the reference modules it imported to P20_DIR."""
    import numpy as np

    from sassy_tpu_torch import profiles
    from sassy_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    multihost.initialize(coordinator_address=addr, num_processes=int(nproc),
                         process_id=int(rank), share_cards=True)
    import torch.distributed as dist

    text = np.load(P20_DIR / "text.npy", mmap_mode="r")
    pats = list(np.load(P20_DIR / "pats.npy"))
    counts_zero()
    t1 = time.perf_counter()
    got = multihost.global_search(profiles.Iupac(), pats, text, K,
                                  slots_per_rank=8 // int(nproc),
                                  device=device)
    search = time.perf_counter() - t1
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "got": got, "launched": counts(), "search_s": search,
           "seconds": time.perf_counter() - t0,
           "imported": sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "sassy_tpu"))}
    dist.destroy_process_group()
    (P20_DIR / f"rank{rank}.json").write_text(json.dumps(out))
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sharded_processes(gen) -> dict:
    """Phases 20c and 20d. Returns the launches of this process."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from sassy_tpu_torch import profiles
    from sassy_tpu_torch.ops.myers_torch import TorchEngine
    from sassy_tpu_torch.parallel import ShardedSearch, make_mesh, multihost

    shutil.rmtree(P20_DIR, ignore_errors=True)
    P20_DIR.mkdir(parents=True)
    text = random_acgt(gen, SHARD_MID)
    pats = list(random_acgt(gen, SHARD_Q[0] * PATTERN_LEN).cpu().numpy()
                .reshape(-1, PATTERN_LEN))
    span, halo = shard_span(SHARD_MID, PATTERN_LEN, K, None, 8)
    sites = plant_edges(text, pats, span, halo, 8)
    host = text.cpu().numpy()
    np.save(P20_DIR / "text.npy", host)
    np.save(P20_DIR / "pats.npy", np.stack(pats))
    addr = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SHARD_CHILD, addr, str(r), str(SHARD_PROCS),
         DEVICE],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(SHARD_PROCS)]
    total = dict.fromkeys(counts(), 0)
    try:
        # meanwhile: the same search in this process over the same 8 slots
        one = ShardedSearch(mesh=make_mesh(8, 1, device=DEVICE))
        counts_zero()
        t1 = time.perf_counter()
        got_one = one.candidates_batch(profiles.Iupac(), pats, text, K)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t1
        for key, v in counts().items():
            total[key] += v
        ranks = []
        for r, proc in enumerate(procs):
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                fail(f"phase 20c: rank {r} exited {proc.returncode}: "
                     f"{out[-2000:]} {err[-3000:]}")
            ranks.append(json.loads((P20_DIR / f"rank{r}.json").read_text()))
    finally:
        for proc in procs:
            proc.kill()
    wall = time.perf_counter() - t0
    for r, got in enumerate(ranks):
        lists = [[tuple(c) for c in row] for row in got["got"]]
        log(f"phase 20c: rank {r}: {got['backend']}, world {got['world']}, "
            f"search {got['search_s']:.2f} s, process {got['seconds']:.1f} s "
            f"after the import, launches {got['launched']}")
        if got["backend"] != "gloo" or got["world"] != SHARD_PROCS:
            fail(f"phase 20c: rank {r} ran on {got['backend']}")
        if got["imported"]:
            fail(f"phase 20c: rank {r} imported {got['imported']}")
        if lists != got_one:
            fail(f"phase 20c: rank {r}'s lists differ from one process's")
        require(got["launched"], ("q2meta",), ("q1meta", "q1", "q2"),
                f"phase 20c rank {r}", least=8 // SHARD_PROCS)
    for q, end in sites:
        if (end, 1) not in got_one[q]:
            fail(f"phase 20c: the copy ending at {end} is missing")
    log(f"phase 20c: {SHARD_PROCS} processes x {8 // SHARD_PROCS} slots on "
        f"the one card over gloo, {SHARD_MID} bases: {wall:.1f} s of wall; "
        f"equal to one process's 8 slots ({one_s * 1e3:.1f} ms)")

    # 20d: one NCCL rank
    eng = TorchEngine(DEVICE)
    prep = eng.prepare(profiles.Iupac(), text)
    want = single_lists(eng, prep, pats, K, None)
    t0 = time.perf_counter()
    multihost.initialize(coordinator_address=f"127.0.0.1:{free_port()}",
                         num_processes=1, process_id=0)
    try:
        backend = dist.get_backend()
        counts_zero()
        got = multihost.global_search(profiles.Iupac(), pats, text, K,
                                      slots_per_rank=4, device=DEVICE)
        torch.cuda.synchronize()
        launched = counts()
    finally:
        dist.destroy_process_group()
    if backend != "nccl":
        fail(f"phase 20d: the one rank ran on {backend}, not nccl")
    if got != want:
        fail("phase 20d: global_search differs from the single engine")
    require(launched, ("q2meta",), ("q1meta", "q1", "q2"), "phase 20d",
            least=4)
    for key, v in launched.items():
        total[key] += v
    log(f"phase 20d: one NCCL rank, 4 slots: {time.perf_counter() - t0:.1f} "
        f"s with the group's set-up, equal to the single engine's lists")
    shutil.rmtree(P20_DIR, ignore_errors=True)
    del text, prep
    torch.cuda.empty_cache()
    return total


@contextlib.contextmanager
def sharded_launches(total: dict):
    """Every ``ShardedSearch.candidates_batch`` call sets the counts to 0
    before it and adds them to ``total`` after it, with no plain version
    allowed: launches of anything else in the block (the single engine a
    caller compares against) are not counted."""
    import torch

    from sassy_tpu_torch.parallel import sharded as sharded_mod

    cls = sharded_mod.ShardedSearch
    orig = cls.candidates_batch

    def counted(self, *a, **kw):
        counts_zero()
        try:
            with no_plain():
                got = orig(self, *a, **kw)
            torch.cuda.synchronize()
        finally:
            for key, v in counts().items():
                total[key] += v
        total["searches"] += 1
        return got

    cls.candidates_batch = counted
    try:
        yield
    finally:
        cls.candidates_batch = orig


def sharded_entry_points() -> dict:
    """Phase 20e. Returns the launches of the dryrun's sharded searches
    (its single-engine references and ``entry()`` are not counted)."""
    import torch

    from sassy_tpu_torch import graft_entry

    launched = dict.fromkeys(counts(), 0)
    launched["searches"] = 0
    t0 = time.perf_counter()
    with sharded_launches(launched):
        done = graft_entry.dryrun_multichip(8, device=DEVICE)
    searches = launched.pop("searches")
    t_dry = time.perf_counter() - t0
    if searches != len(done):
        fail(f"phase 20e: {searches} sharded searches for {len(done)} "
             "scenarios")
    # the dryrun's mesh is 2 x 4: every search launches on each slot; its
    # two overhang scenarios run q2, its two fast ones q2meta
    require(launched, ("q2", "q2meta"), ("q1meta", "q1", "qn", "variants"),
            "phase 20e's sharded searches", least=2 * 8)
    t0 = time.perf_counter()
    fn, args = graft_entry.entry(DEVICE)
    out = fn(*args)
    torch.cuda.synchronize()
    if out.device.type != "cuda" or out.shape[0] != 2:
        fail(f"phase 20e: entry() returned {out.shape} on {out.device}")
    log(f"phase 20e: dryrun_multichip(8) {done} in {t_dry:.1f} s, its "
        f"sharded searches' launches {launched}; entry() ({out.shape[1]} "
        f"candidates) in {time.perf_counter() - t0:.1f} s")
    return launched


def sharded() -> dict:
    """Phase 20: the sharded search on the card. Returns its launches."""
    import torch

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    total = dict.fromkeys(counts(), 0)
    packed_before = PACKED["launches"]
    for part in (sharded_one_process(gen), sharded_past_2g(gen),
                 sharded_processes(gen), sharded_entry_points()):
        for key, v in part.items():
            total[key] += v
    for held in SHARD_HOLDS:
        hold_scan(*held)
    SHARD_HOLDS.clear()
    n_pack = PACKED["launches"] - packed_before
    log(f"phase 20: {time.perf_counter() - t0:.1f} s, launches {total}, "
        f"pack kernel launches {n_pack} (the runs of 20a and 20b)")
    if not n_pack:
        fail("phase 20: the sharded runs launched no pack kernel")
    return total


def tools_on_card() -> dict:
    """Phase 21: the port's tools (sassy_tpu_torch.tools) through their
    run(), on the card, with the plain scans and selections made to
    refuse; 21d and 21e each hold two of their results equal, 21c's ratio
    is logged only.
    Returns the launches of the soak round."""
    from sassy_tpu_torch.tools import (bench_io_overlap, bench_oneshot,
                                       bench_traceback, profile_readset, soak)

    t0 = time.perf_counter()
    one_round = sum(sig[0] * sig[1] for sig in soak.SIGNATURES)
    workers = max(1, (os.cpu_count() or 2) - 1)
    counts_zero()
    with no_plain("phase 21a"):
        rec = soak.run(one_round, SOAK_SEED, DEVICE, workers,
                       log=lambda msg: log(f"phase 21a: {msg}"))
    soaked = counts()
    if not rec["ok"]:
        fail(f"phase 21a: {rec['mismatch']}  {rec['repro']}")
    log(f"phase 21a: soak round of {len(soak.SIGNATURES)} signatures: "
        f"{rec['pairs']} pairs in {rec['wall_s']:.1f} s (device "
        f"{rec['card_s']:.1f} s, oracle {rec['oracle_s']:.1f} s in "
        f"{workers} processes, waited {rec['oracle_wait_s']:.1f} s); "
        f"launches {soaked}")
    require(soaked, ("q1meta", "q2meta", "q1", "q2"), ("qn", "variants"),
            "phase 21a", least=1)
    selected("phase 21a", tuple(SELECTED))

    runs = [
        ("21b bench_oneshot", lambda: bench_oneshot.run(
            reps=ONESHOT_REPS, device=DEVICE,
            log=lambda msg: log(f"phase 21b: {msg}")), ("q1meta",), None),
        ("21c bench_traceback", lambda: bench_traceback.run(
            TRACEBACK_MATCHES, TRACEBACK_MB, DEVICE,
            log=lambda msg: log(f"phase 21c: {msg}"))[0], ("q1meta",),
         None),
        ("21d bench_io_overlap", lambda: bench_io_overlap.run(
            IO_OVERLAP_MB, 32, DEVICE, workdir=CLI_DIR / "io_overlap",
            log=lambda msg: log(f"phase 21d: {msg}")), ("q2meta",),
         lambda got: (got["matches"], got["steady_matches"])),
        ("21e profile_readset", lambda: profile_readset.run(
            READSET_Q, READSET_MB, device=DEVICE,
            log=lambda msg: log(f"phase 21e: {msg}")), ("q2meta",),
         lambda got: (got["reads"]["matches"], got["flat"]["matches"])),
    ]
    for label, fn, used, agree in runs:
        counts_zero()
        t1 = time.perf_counter()
        with no_plain(f"phase {label}"):
            try:
                got = fn()
            except (AssertionError, RuntimeError) as e:
                fail(f"phase {label}: {e}")
        launched = counts()
        require(launched, used, ("q1", "q2", "qn", "variants"),
                f"phase {label}", least=1)
        if agree is not None and len(set(agree(got))) != 1:
            fail(f"phase {label}: matches differ {agree(got)}: "
                 f"{json.dumps(got)}")
        log(f"phase {label}: {time.perf_counter() - t1:.1f} s, launches "
            f"{launched}: {json.dumps(got)}")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    log(f"phase 21: {time.perf_counter() - t0:.1f} s")
    return soaked


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import sassy_tpu_torch
    from sassy_tpu_torch.ops import myers_cuda

    log(card_line())
    log(f"features: {json.dumps(sassy_tpu_torch.features())}")
    t0 = time.perf_counter()
    lib = myers_cuda.build()
    log(f"phase 1: built {lib.name} in {time.perf_counter() - t0:.1f} s")
    log(lib.with_name(lib.name + ".log").read_text().strip())

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    text_dev = random_acgt(gen, N_TEXT)
    head, head_sw = kernel_vs_plain(gen, text_dev)
    head_pack = pack_vs_plain(
        torch.Generator(device=DEVICE).manual_seed(SEED + 2), text_dev)
    del text_dev
    torch.cuda.empty_cache()
    head_set = pack_set_vs_plain(
        torch.Generator(device=DEVICE).manual_seed(SEED + 3))

    launches, text, pattern = end_to_end(gen)
    against_cpu(text, pattern)
    del text

    reads, barcodes = nanopore_reads(gen)
    head_q = q_kernel_vs_plain(reads, barcodes)
    torch.cuda.empty_cache()
    launches_q = batched_end_to_end(reads, barcodes)
    batched_vs_single(reads, barcodes)
    del reads
    torch.cuda.empty_cache()

    text = random_acgt(gen, N_TEXT).cpu().numpy()
    overhang_single(gen, text)
    head_q1 = overhang_position_level(gen, text)
    del text
    torch.cuda.empty_cache()

    reads = overhang_reads(gen)
    barcodes = random_acgt(gen, N_BARCODES * BARCODE_LEN).cpu().numpy()
    barcodes = list(barcodes.reshape(N_BARCODES, BARCODE_LEN))
    long_ = random_acgt(gen, OH_Q_B * OH_POS[2]).cpu().numpy()
    long_ = list(long_.reshape(OH_Q_B, OH_POS[2]))
    want_a = plant_reads(reads, barcodes, OH_EVERY_A, OH_WORD[3])
    want_b = plant_reads(reads, long_, OH_EVERY_B, OH_POS[3],
                         first=OH_EVERY_A // 2)
    head_q2 = q2_vs_plain(reads, long_)
    torch.cuda.empty_cache()
    batched_overhang("phase 11a", reads, barcodes, OH_WORD, want_a,
                     ("q2meta",), ("q2", "q1", "q1meta"),
                     "select_words_chained")
    launched_b = batched_overhang("phase 11b", reads, long_, OH_POS, want_b,
                                  ("q2",), ("q2meta", "q1", "q1meta"),
                                  "select_positions_tiles")
    del reads
    torch.cuda.empty_cache()

    rows_qn = qn_family()
    head_variants = row_step_ablations()
    ascii_end_to_end(gen)
    torch.cuda.empty_cache()
    text = random_acgt(gen, N_TEXT).cpu().numpy()
    hier_single(gen, text)
    del text
    torch.cuda.empty_cache()
    hier_batched(gen, overhang_reads(gen))
    torch.cuda.empty_cache()

    launches_bench = bench_loop()
    torch.cuda.empty_cache()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    guides, genome, plants = cli_crispr(gen)
    cli_search(gen)
    genome_scan(guides, genome, plants)
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    log(f"phases 16-18: q1meta launched {launches_bench} times by phase 16")
    launches_19 = evals_and_surfaces()
    log(f"phase 19: q1meta launched {launches_19['q1meta']} times, q2meta "
        f"{launches_19['q2meta']} times")
    torch.cuda.empty_cache()
    launches_20 = sharded()
    torch.cuda.empty_cache()
    launches_21 = tools_on_card()

    ref = [m for m in sys.modules if m in ("jax", "sassy_tpu")
           or m.startswith(("jax.", "sassy_tpu."))]
    if ref:
        fail(f"JAX or the reference package was imported: {ref}")

    def entry(name, source, replaces, launched, rec):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launched,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None}

    # rows 1-4: the main path's launches, phase 20's (the sharded path) and
    # phase 21a's (the soak round)
    record = {"kernels": [
        entry("scan_meta (q1meta)", "sassy_tpu_torch/csrc/scan_meta.cu",
              "sassy_tpu/ops/myers_pallas.py:201",
              launches + launches_20["q1meta"] + launches_21["q1meta"], head),
        {**entry("scan_q_meta (q2meta)",
                 "sassy_tpu_torch/csrc/scan_q_meta.cu",
                 "sassy_tpu/ops/myers_pallas.py:735",
                 launches_q + launches_20["q2meta"] + launches_21["q2meta"],
                 head_q),
         "off_targets_full": {
             key: head_q["off_targets_full"][key]
             for key in ("ms", "plain_ms", "bound_ms", "bound_by", "share",
                         "Q", "NW", "T")}},
        entry("scan (q1)", "sassy_tpu_torch/csrc/scan.cu",
              "sassy_tpu/ops/myers_pallas.py:49",
              head_q1["launches"] + launches_20["q1"] + launches_21["q1"],
              head_q1),
        entry("scan_q (q2)", "sassy_tpu_torch/csrc/scan_q.cu",
              "sassy_tpu/ops/myers_pallas.py:541",
              launched_b["q2"] + launches_20["q2"] + launches_21["q2"],
              head_q2),
        entry("scan_qn U=1 loop WU=1 (q)", "sassy_tpu_torch/csrc/scan_qn.cu",
              "sassy_tpu/ops/myers_pallas.py:400", rows_qn["q"]["launches"],
              rows_qn["q"]),
        entry("scan_qn U=2 loop WU=1 (qN)", "sassy_tpu_torch/csrc/scan_qn.cu",
              "scripts/kernel_qn.py:17", rows_qn["qn"]["launches"],
              rows_qn["qn"]),
        entry("scan_qn U=2 unroll WU=1", "sassy_tpu_torch/csrc/scan_qn.cu",
              "scripts/kernel_qn.py:183", rows_qn["unroll"]["launches"],
              rows_qn["unroll"]),
        entry("scan_qn U=2 unroll WU=2", "sassy_tpu_torch/csrc/scan_qn.cu",
              "scripts/kernel_qn.py:345", rows_qn["unroll_w"]["launches"],
              rows_qn["unroll_w"]),
        entry("scan_variant full", "sassy_tpu_torch/csrc/scan_variants.cu",
              "scripts/kernel_variants.py:29", head_variants["launches"],
              head_variants),
        # rows 10-11: the JAX pipeline's XLA selection; launches of phases
        # 3, 6, 8, 9, 11, 20 and 21a, times from phases 2, 9 and (the
        # pieces' kernel of the same source, a record of its own) 10
        {**entry("select_words", "sassy_tpu_torch/csrc/select_words.cu",
                 "sassy_tpu/ops/minima.py:662",
                 SELECTED["select_words_chained"], head_sw),
         "split": head_sw["split"]},
        {**entry("select_positions",
                 "sassy_tpu_torch/csrc/select_positions.cu",
                 "sassy_tpu/ops/minima.py:43", SELECTED["select_positions"],
                 head_q1["select"]),
         "pieces": {**entry("select_positions_tiles",
                            "sassy_tpu_torch/csrc/select_positions.cu",
                            "sassy_tpu/ops/minima.py:1019",
                            SELECTED["select_positions_tiles"],
                            head_q2["select"]),
                    "sub_range": {
                        key: head_q2["select"]["sub_range"][key]
                        for key in ("ms", "plain_ms", "bound_ms",
                                    "bound_by")}}},
        # row 12: the JAX pipeline's XLA pack; launches of phases 3, 6, 8,
        # 9, 11, 20 and 21a, times from phase 2 (1 GiB of ACGT, DNA; the
        # other profiles and texts under "profiles")
        {**entry("pack", "sassy_tpu_torch/csrc/pack.cu",
                 "sassy_tpu/ops/myers_xla.py:172", PACKED["launches"],
                 head_pack),
         "profiles": head_pack["profiles"]},
        # row 13: the text set's preparation around the JAX pipeline's
        # pack (reverse_planes, the reversed host copies at batch.py:119,
        # the overshoot's pad code at batch.py:436); launches of phases 3,
        # 6, 8, 9, 11 and 21a, times from phase 2 (nanopore_full's reads,
        # forward, DNA; the other sets, strands and steps under "cases")
        {**entry("pack_set", "sassy_tpu_torch/csrc/pack.cu",
                 "sassy_tpu/ops/myers_xla.py:228", PACKED_SET["launches"],
                 head_set),
         "cases": head_set["cases"]},
        # row 14: the JAX package's host traceback (the window gather,
        # _fill_batch and _walk_batch); launches of phases 3, 6, 8, 9 and
        # 11, times from phase 6's forward strand (16,752 candidates of 24
        # bp), the other holds under "holds"
        {**entry("trace", "sassy_tpu_torch/csrc/trace.cu",
                 "sassy_tpu/traceback.py:37, :119", TRACED["launches"],
                 TRACE_HOLDS["phase 6: the forward strand"]),
         "candidates": TRACE_HOLDS["phase 6: the forward strand"][
             "candidates"],
         "holds": {label: {key: rec[key] for key in (
             "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
             "candidates", "m")}
             for label, rec in TRACE_HOLDS.items()
             if label != "phase 6: the forward strand"}},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
