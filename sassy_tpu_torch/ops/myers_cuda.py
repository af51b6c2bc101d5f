"""The scan kernels on the H100: build, load and launch, each beside its
plain PyTorch version. Each replaces a TPU kernel of
``sassy_tpu/ops/myers_pallas.py``:

- ``scan_meta`` (q1meta, ``csrc/scan_meta.cu``) replaces
  ``get_pallas_scan_meta``: one pattern, with selection metadata;
  ``scan_meta_plain`` is its plain version.
- ``scan_q_meta`` (q2meta, ``csrc/scan_q_meta.cu``) replaces
  ``get_pallas_scan_q2_meta``: Q patterns over the same windows;
  ``scan_q_meta_plain``.
- ``scan`` (q1, ``csrc/scan.cu``) replaces ``get_pallas_scan``: q1meta
  without the metadata (vp, vm and cost only), for the overhang search's
  position-level path; ``scan_plain``.
- ``scan_q`` (q2, ``csrc/scan_q.cu``) replaces ``get_pallas_scan_q2``:
  q1 for Q patterns; ``scan_q_plain``.
- ``scan_qn`` (``csrc/scan_qn.cu``) replaces ``get_pallas_scan_q`` and the
  three kernels of ``scripts/kernel_qn.py`` (``make_call``,
  ``make_call_unroll``, ``make_call_unroll_w``): q2's function with U
  patterns per thread, the row loop kept or unrolled, and WU window words
  per iteration; ``scan_qn_plain``. Only
  ``sassy_tpu_torch.tools.kernel_qn`` launches it.
- ``scan_variant`` (``csrc/scan_variants.cu``) replaces ``make(variant)``
  of ``scripts/kernel_variants.py``: the row-step ablations full, noeq,
  nomem and nostore; ``scan_variant_plain``. Only
  ``sassy_tpu_torch.tools.kernel_variants`` launches it.

The candidate selection, the XLA code around the JAX pipeline's meta and
position scans, has two kernels of its own; ``ops/minima.py``'s entry
points run their plain versions for tensors on the CPU and these for
CUDA tensors:

- ``select_words_chained`` and ``select_words`` (``csrc/select_words.cu``,
  its grid, per-word work and chain in ``csrc/select_words.cuh``) replace
  ``sassy_tpu/ops/minima.py``'s ``select_words_tiles_q`` (and
  ``select_words_tiles``): the word-level selection, with the state chain
  across tiles inside or with each tile's state given (three launches
  around one host read); ``minima.select_words_chained_plain`` and
  ``minima.select_words_tiles_q_plain``.
- ``select_positions`` and ``select_positions_tiles``
  (``csrc/select_positions.cu``, its walk in ``csrc/select_walk.cuh``)
  replace its ``select_candidates`` and ``select_candidates_tiles``: the
  position-level selections of one text and of the batched engine's
  pieces, the state chain across tiles included (three launches around
  one host read); ``minima.select_candidates_plain``,
  ``minima.select_candidates_tiles_plain`` and
  ``minima.select_candidates_chained_plain``.

The text pack, the XLA code before the JAX pipeline's scans, has a
kernel too: ``pack`` (``csrc/pack.cu``, its per-word code in
``csrc/pack.cuh``) replaces ``sassy_tpu/ops/myers_xla.py``'s jitted
``pack`` (``:172``): bytes -> the engine's bit-planes, one launch a call;
``myers_torch.pack`` runs ``myers_torch.pack_plain`` for a text on the CPU
and this for a text on a CUDA device.

The batched engine's text set has a kernel of its own: ``pack_set``
(``csrc/pack.cu``, ``pack_set_words``) packs every text of a strand in one
launch from the texts' uploaded bytes, read backwards for the reverse
strand and each followed by its overhang 'N's: what the JAX pipeline's
reversed host copies (``sassy_tpu/ops/batch.py:119``), ``reverse_planes``
(``myers_xla.py:228``) and the overshoot's pad code
(``batch.py:436``) produce around its pack; ``batch.pack_set`` runs
``batch.pack_set_plain`` for a set on the CPU and this for one on a CUDA
device.

The host finish's traceback has a kernel of its own: ``trace_windows``
(``csrc/trace.cu``, its per-candidate work in ``csrc/trace.cuh``) reads
each candidate's window from the strand's planes, fills its windowed DP
as Myers words (the scans' step, ``csrc/myers_word.cuh``) and walks it
back on their delta words, one thread a candidate: what the JAX
package's host traceback computes (``sassy_tpu/traceback.py:37``
``_fill_batch``, ``:119`` ``_walk_batch``);
``traceback.trace_cells_batch`` runs ``traceback.trace_plain`` for planes
on the CPU and this for planes on a CUDA device.

The four scan kernels of the search paths read their text straight from
the packed planes: their first argument is a ``myers_torch.Windows``
descriptor (each tile's ``wstart`` and ``wend`` in the planes; the read in
``csrc/window_read.cuh``), and their plain versions gather the windows it
describes with ``myers_torch.windows_plain`` first. An (NW, P, T) window
tensor is described by ``Windows.of``.

The scan sources share the row step of ``csrc/myers_step.cuh`` (its
Myers step in ``csrc/myers_word.cuh``, which the traceback shares), the
selection sources ``csrc/select_common.cuh``. All are compiled with one
``nvcc`` call for ``sm_90a`` at first use into one library in
``build/sassy_tpu_torch/`` beside the package, keyed by a hash of the
sources and flags, and loaded with ctypes through plain C entry points,
once per process (``_lib``).

Each scan wrapper runs the plain version for tensors on the CPU and its
kernel for tensors on a CUDA device; there is no other fallback. Its
``launches`` attribute counts the calls that launch its kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .. import spans
from . import minima, myers_torch

__all__ = ["scan_meta", "scan_meta_plain", "scan_q_meta",
           "scan_q_meta_plain", "scan", "scan_plain", "scan_q",
           "scan_q_plain", "scan_qn", "scan_qn_plain", "scan_variant",
           "scan_variant_plain", "select_words", "select_words_chained",
           "select_positions",
           "select_positions_tiles", "pack", "pack_set", "trace_windows",
           "build", "nvcc_path"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "scan_meta.cu", CSRC / "scan_q_meta.cu", CSRC / "scan.cu",
           CSRC / "scan_q.cu", CSRC / "scan_qn.cu", CSRC / "scan_variants.cu",
           CSRC / "select_words.cu", CSRC / "select_positions.cu",
           CSRC / "pack.cu", CSRC / "trace.cu")
HEADERS = (CSRC / "myers_word.cuh", CSRC / "myers_step.cuh",
           CSRC / "window_read.cuh",
           CSRC / "select_common.cuh",
           CSRC / "select_walk.cuh", CSRC / "select_words.cuh",
           CSRC / "pack.cuh", CSRC / "trace.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sassy_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "--threads", str(len(SOURCES)),  # the sources compile side by side
)
EQ_MODES = {"iupac": 0, "pure": 1, "ascii": 2}
PLANES = {"iupac": 4, "pure": 4, "ascii": 9}
#: pattern rows whose carries the kernel keeps in registers
REG_ROWS = 64
#: shared memory a block may use on the H100 (bytes)
MAX_SMEM = 232448
#: the members of the scan_qn family that csrc/scan_qn.cu builds
#: (SASSY_QN_MEMBERS there): patterns per thread with the row loop kept,
#: (U, WU) with the rows unrolled, and the row counts unrolled for. Only
#: the member U = 1, loop, WU = 1 takes every eq; the others iupac.
QN_LOOP_U = (1, 2, 4, 8)
QN_UNROLL = ((1, 1), (2, 1), (1, 2), (2, 2), (2, 4))
QN_UNROLL_ROWS = (24, 64)
VARIANTS = {"full": 0, "noeq": 1, "nomem": 2, "nostore": 3}
#: owned_end of a position-level selection without one: past every position
NO_END = 1 << 62
#: the pack kernel's modes (csrc/pack.cuh) and most code planes
PACK_MODES = {"table5": 0, "byte": 1}
PACK_MAX_PLANES = 8
#: the traceback kernel's match tests (csrc/trace.cuh): a code AND
#: (iupac, dna), byte equality (ascii)
TRACE_EQ = {"iupac": 0, "ascii": 1}
#: bytes of one (pattern row, 32 window columns) of the traceback's
#: scratch: its four delta words (TraceCell)
TRACE_CELL_BYTES = 16
#: the most window words a row of the traceback's fill keeps in registers
#: (kTraceGroupMax); the instantiations hold 1 to this many
TRACE_GROUP_MAX = 8
#: int32 fields that start a traced candidate's output row (kTraceFields):
#: its start in the window, total cost, pattern start, pattern end,
#: failed; its ops follow as int8 (0-3: =, X, D, I) in walk order, -1 past
#: the walk's end
TRACE_FIELDS = 5

_LIBS: dict = {}


def nvcc_path() -> str | None:
    """The CUDA compiler: on PATH, else under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    return None


def library_path() -> Path:
    """The kernel library of these sources, headers and flags: its name
    holds a hash of them all."""
    key = hashlib.sha256(
        b"".join(f.read_bytes() for f in SOURCES + HEADERS)
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"scan_kernels_{key}.so"


def build() -> Path:
    """Compile the kernel library unless these sources are built already.
    Returns its path; ``<path>.log`` keeps the compiler's report
    (registers, spills). Raises with nvcc's stderr when the build
    fails."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the scan kernels need the CUDA "
                           "toolkit to build")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{proc.stderr}"
        )
    lib.with_name(lib.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders race harmlessly
    return lib


def load_library(path) -> ctypes.CDLL:
    """Load a built kernel library and declare its C entry points."""
    path = str(path)
    lib = _LIBS.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        ptr, num = ctypes.c_void_p, ctypes.c_int
        big, real = ctypes.c_longlong, ctypes.c_float
        # the window descriptor: planes, wstart, wend, plane words
        desc = [ptr] * 3 + [big]
        lib.sassy_scan_meta.argtypes = desc + [ptr] * 13 + [num] * 8 + [ptr]
        lib.sassy_scan_q_meta.argtypes = desc + [ptr] * 15 + [num] * 7 + [ptr]
        lib.sassy_scan.argtypes = desc + [ptr] * 9 + [num] * 7 + [ptr]
        lib.sassy_scan_q.argtypes = desc + [ptr] * 11 + [num] * 6 + [ptr]
        lib.sassy_scan_qn.argtypes = [ptr] * 11 + [num] * 9 + [ptr]
        lib.sassy_scan_variant.argtypes = [ptr] * 3 + [num] * 5 + [ptr]
        lib.sassy_select_words.argtypes = ([ptr] * 16 + [big] + [num] * 6
                                           + [real, num, ptr])
        lib.sassy_select_positions.argtypes = ([ptr] * 5 + [big] * 7
                                               + [num] * 7 + [real, num, ptr])
        lib.sassy_select_positions_tiles.argtypes = (
            [ptr] * 15 + [big] * 3 + [num] * 5 + [real, num, ptr])
        lib.sassy_select_scratch_words.argtypes = [big]
        lib.sassy_select_scratch_words.restype = big
        lib.sassy_select_words_scratch.argtypes = [num] * 3
        lib.sassy_select_words_scratch.restype = big
        lib.sassy_pack.argtypes = ([ptr, big, ptr] + [big] * 3 + [num] * 6
                                   + [ctypes.POINTER(ctypes.c_uint), num,
                                      ptr])
        lib.sassy_pack_set.argtypes = ([ptr, big] + [ptr] * 3
                                       + [big, ptr, big, big] + [num] * 6
                                       + [ctypes.POINTER(ctypes.c_uint), num,
                                          ptr])
        lib.sassy_trace.argtypes = ([ptr, big] + [num] * 2 + [ptr] * 2
                                    + [big, ptr] + [num] * 3
                                    + [ptr, big, ptr] + [big] * 3 + [ptr])
        for fn in (lib.sassy_scan_meta, lib.sassy_scan_q_meta, lib.sassy_scan,
                   lib.sassy_scan_q, lib.sassy_scan_qn,
                   lib.sassy_scan_variant, lib.sassy_select_words,
                   lib.sassy_select_positions,
                   lib.sassy_select_positions_tiles, lib.sassy_pack,
                   lib.sassy_pack_set, lib.sassy_trace):
            fn.restype = num
        _LIBS[path] = lib
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built (or found built) and loaded once per
    process: the wrappers call it at every launch, and hashing the sources
    each time costs host time the selections' host read of their count
    exposes. After changing the sources or ``build``, call
    ``_lib.cache_clear()``."""
    return load_library(build())


def _windows_of(win) -> "myers_torch.Windows":
    """``win`` if it is a ``myers_torch.Windows``; the four scan entry
    points and their plain versions take no other windows."""
    if not isinstance(win, myers_torch.Windows):
        raise TypeError(f"the scan entry points take a myers_torch.Windows "
                        f"descriptor (Windows.of for a window tensor), not "
                        f"{type(win).__name__}")
    return win


def scan_q_plain(win, tile0, pmasks, is_pad, h_init, m_real, boundary_m,
                 eq_mode: str):
    """Plain PyTorch version of the q2 kernel: ``myers_torch.scan_core``
    over Q patterns from the tiles' initial state (the true-start h deltas
    and boundary cost where ``tile0`` is set, the plain cost-j boundary
    elsewhere), on the windows the ``myers_torch.Windows`` ``win``
    describes (gathered by ``windows_plain``). ``m_real``/``boundary_m``
    are (Q,) int32."""
    return _scan_q_windows(_windows_of(win).gather(), tile0, pmasks, is_pad,
                           h_init, m_real, boundary_m, eq_mode)


def _scan_q_windows(windows, tile0, pmasks, is_pad, h_init, m_real,
                    boundary_m, eq_mode: str):
    """``scan_q_plain`` on an (NW, P, T) window tensor."""
    Q, M = pmasks.shape[:2]
    hp0 = torch.where(
        is_pad.view(Q, M, 1) != 0, 0,
        torch.where(tile0.view(1, 1, -1), h_init.view(Q, M, 1), 1),
    ).to(torch.int32)
    hm0 = torch.zeros_like(hp0)
    cost0 = torch.where(tile0.view(1, -1), boundary_m.view(Q, 1),
                        m_real.view(Q, 1)).to(torch.int32)
    return myers_torch.scan_core(windows, pmasks, is_pad, hp0, hm0, cost0,
                                 eq_mode)


def _check_qn(Q: int, NW: int, M: int, U: int, WU: int):
    """What every member of the scan_qn family asks of its shapes."""
    if U < 1 or Q % U:
        raise ValueError(f"{Q} patterns do not split into groups of U = {U}")
    if WU < 1 or NW % WU:
        raise ValueError(f"{NW} window words do not split into WU = {WU}")
    if M > REG_ROWS:
        raise ValueError(f"scan_qn keeps its row carries in registers: "
                         f"M = {M} > {REG_ROWS}")


def scan_qn_plain(windows, tile0, pmasks, is_pad, h_init, m_real,
                  boundary_m, eq_mode: str, U: int = 1, unroll: bool = False,
                  WU: int = 1):
    """Plain PyTorch version of the scan_qn family: every member computes
    ``scan_q_plain`` on the (NW, P, T) windows; U, unroll and WU only
    shape the kernel."""
    _check_qn(pmasks.shape[0], windows.shape[0], pmasks.shape[1], U, WU)
    return _scan_q_windows(windows, tile0, pmasks, is_pad, h_init, m_real,
                           boundary_m, eq_mode)


def scan_variant_plain(windows, pmasks, variant: str):
    """Plain PyTorch version of the row-step ablations (the arithmetic of
    the reference's ``scripts/kernel_variants.py``, on int64 values masked
    to 32 bits): one pattern, pmasks (M, 4), iupac eq without pad rows,
    every row's carries from hp = 1, hm = 0. "full": the row step; "noeq":
    eq is plane 0's word; "nomem": a row's incoming h deltas are vp and vm
    and no carry is kept; "nostore": the sum of vp's popcounts over the
    words. Returns vp (NW, T) int32, for "nostore" the sums (1, T)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    NW, P, T = windows.shape
    M = pmasks.shape[0]
    FULL, u32, i32 = minima.FULL, minima.u32, minima.i32
    pm = u32(pmasks)
    hp = torch.ones((M, T), dtype=torch.int64, device=windows.device)
    hm = torch.zeros_like(hp)
    acc = torch.zeros((T,), dtype=torch.int64, device=windows.device)
    out = torch.empty((1 if variant == "nostore" else NW, T),
                      dtype=torch.int32, device=windows.device)
    for w in range(NW):
        x = u32(windows[w])
        vp = torch.zeros_like(acc)
        vm = torch.zeros_like(acc)
        for j in range(M):
            if variant == "noeq":
                eq = x[0]
            else:
                eq = torch.zeros_like(acc)
                for p in range(P):
                    eq = eq | (x[p] & pm[j, p])
            hp_j, hm_j = (vp, vm) if variant == "nomem" else (hp[j].clone(),
                                                             hm[j].clone())
            vx = eq | vm
            eqh = eq | hm_j
            hx = ((((eqh & vp) + vp) & FULL) ^ vp) | eqh
            hp_o = vm | (~(hx | vp) & FULL)
            hm_o = vp & hx
            if variant != "nomem":
                hp[j] = hp_o >> 31
                hm[j] = hm_o >> 31
            hp_sh = ((hp_o << 1) & FULL) | hp_j
            hm_sh = ((hm_o << 1) & FULL) | hm_j
            vp = hm_sh | (~(vx | hp_sh) & FULL)
            vm = hp_sh & vx
        if variant != "nostore":
            out[w] = i32(vp)
        acc = acc + myers_torch._popcount32(vp)
    if variant == "nostore":
        out[0] = acc.to(torch.int32)
    return out


def scan_plain(win, tile0, pmasks, is_pad, h_init, m_real: int,
               boundary_m: int, eq_mode: str):
    """Plain PyTorch version of the q1 kernel: ``scan_q_plain`` of the one
    pattern."""
    scal = torch.tensor([[m_real], [boundary_m]], dtype=torch.int32,
                        device=win.device)
    outs = scan_q_plain(win, tile0, pmasks[None], is_pad[None],
                        h_init[None], scal[0], scal[1], eq_mode)
    return tuple(o[0] for o in outs)


def scan_q_meta_plain(win, tile0, valid_from, valid_to, pmasks, is_pad,
                      h_init, m_real, boundary_m, k: int, eq_mode: str):
    """Plain PyTorch version of the q2meta kernel: ``scan_q_plain``, then
    ``minima.meta_from_words``."""
    vp, vm, cost = scan_q_plain(win, tile0, pmasks, is_pad, h_init,
                                m_real, boundary_m, eq_mode)
    meta, final = minima.meta_from_words(vp, vm, cost, valid_from, valid_to, k)
    return vp, vm, cost, meta, final


def scan_meta_plain(win, tile0, valid_from, valid_to, pmasks, is_pad,
                    h_init, m_real: int, boundary_m: int, k: int,
                    eq_mode: str):
    """Plain PyTorch version of the q1meta kernel: ``scan_q_meta_plain`` of
    the one pattern."""
    scal = torch.tensor([[m_real], [boundary_m]], dtype=torch.int32,
                        device=win.device)
    outs = scan_q_meta_plain(win, tile0, valid_from, valid_to,
                             pmasks[None], is_pad[None], h_init[None],
                             scal[0], scal[1], k, eq_mode)
    return tuple(o[0] for o in outs)


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, windows on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(shape, dev, tile0, valid_from, valid_to, pmasks, is_pad,
                  h_init, eq_mode: str, lead: tuple):
    """Device, dtype, shape and contiguity of the inputs the kernels share
    (``valid_from``/``valid_to`` None for the kernels without metadata),
    for windows of ``shape`` (NW, P, T) on ``dev``; ``lead`` is () for one
    pattern, (Q,) for Q."""
    if dev.type != "cuda":
        raise ValueError(f"the scan kernels run on cpu or cuda, not {dev}")
    if eq_mode not in EQ_MODES:
        raise ValueError(f"unknown eq_mode {eq_mode!r}")
    NW, P, T = shape
    M = pmasks.shape[len(lead)]
    if P != PLANES[eq_mode]:
        raise ValueError(f"eq_mode {eq_mode!r} takes {PLANES[eq_mode]} "
                         f"planes, windows have {P}")
    PM = P - 1 if eq_mode == "ascii" else P  # no mask for the validity plane
    if M * (PM + 2) * 4 > MAX_SMEM:
        raise ValueError(f"{M} pattern rows exceed the kernel's shared memory")
    _check("tile0", tile0, torch.bool, (T,), dev)
    if valid_from is not None:
        _check("valid_from", valid_from, torch.int32, (T,), dev)
        _check("valid_to", valid_to, torch.int32, (T,), dev)
    _check("pmasks", pmasks, torch.int32, (*lead, M, PM), dev)
    _check("is_pad", is_pad, torch.int32, (*lead, M), dev)
    _check("h_init", h_init, torch.int32, (*lead, M), dev)


def _check_window_tensor(windows):
    """An (NW, P, T) int32 window tensor, contiguous."""
    if windows.dim() != 3:
        raise ValueError(f"windows: expected (NW, P, T), got "
                         f"{tuple(windows.shape)}")
    _check("windows", windows, torch.int32, tuple(windows.shape),
           windows.device)


def _descriptor(win):
    """The ``myers_torch.Windows`` the four search-path kernels read,
    checked: the planes (P, L) int32, contiguous, 16-byte aligned, L a
    multiple of ``myers_torch.PLANE_ALIGN_WORDS`` (the vector loads of
    ``csrc/window_read.cuh``); wstart and wend (T,) int64 on their
    device."""
    planes = _windows_of(win).planes
    dev = planes.device
    if dev.type != "cuda":
        raise ValueError(f"the scan kernels run on cpu or cuda, not {dev}")
    if planes.dim() != 2:
        raise ValueError(f"planes: expected (P, L), got {tuple(planes.shape)}")
    P, L = planes.shape
    _check("planes", planes, torch.int32, (P, L), dev)
    align = myers_torch.PLANE_ALIGN_WORDS
    if L == 0 or L % align or planes.data_ptr() % (4 * align):
        raise ValueError(f"planes: {L} words a plane at address "
                         f"{planes.data_ptr():#x}; the kernels read rows "
                         f"of a multiple of {align} words, "
                         f"{4 * align}-byte aligned")
    T = win.wstart.shape[0]
    _check("wstart", win.wstart, torch.int64, (T,), dev)
    _check("wend", win.wend, torch.int64, (T,), dev)
    if win.NW < 1:
        raise ValueError(f"NW = {win.NW}: a window holds a word or more")
    return win


def _ptr(x):
    return None if x is None else x.data_ptr()


def _carries(Q: int, M: int, T: int, device):
    """Device-memory row carries of patterns past the register rows."""
    if M <= REG_ROWS:
        return None
    return torch.empty((Q, 2 * -(-M // 32), T), dtype=torch.int32,
                       device=device)


def _pure_index(pmasks, eq_mode: str):
    """(..., M) int32 plane index per row for the pure eq, else None."""
    if eq_mode != "pure":
        return None
    return myers_torch.pure_plane_index(
        pmasks.reshape(-1, pmasks.shape[-1])).view(pmasks.shape[:-1]).contiguous()


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _desc_args(win) -> tuple:
    """The C entry points' first four arguments: planes, wstart, wend and
    the words a plane."""
    return (_ptr(win.planes), _ptr(win.wstart), _ptr(win.wend),
            win.planes.shape[1])


def launch(lib, win, tile0, valid_from, valid_to, pmasks, is_pad, h_init,
           m_real: int, boundary_m: int, k: int, eq_mode: str, stream):
    """Allocate the outputs and launch the q1meta kernel of ``lib`` on
    ``stream`` (a raw stream handle) over the windows ``win`` describes;
    the caller has checked the inputs."""
    NW, P, T = win.shape
    M = pmasks.shape[0]
    dev = win.device
    out = [torch.empty((NW, T), dtype=torch.int32, device=dev)
           for _ in range(4)]
    final = torch.empty((T,), dtype=torch.int32, device=dev)
    pidx = _pure_index(pmasks, eq_mode)
    carries = _carries(1, M, T, dev)
    _raise_on(lib.sassy_scan_meta(
        *_desc_args(win), _ptr(tile0), _ptr(valid_from), _ptr(valid_to),
        _ptr(pmasks), _ptr(is_pad), _ptr(h_init), _ptr(pidx),
        *(_ptr(o) for o in out), _ptr(final), _ptr(carries),
        T, NW, P, M, m_real, boundary_m, k, EQ_MODES[eq_mode], stream,
    ), "scan_meta")
    return (*out, final)


def launch_q(lib, win, tile0, valid_from, valid_to, pmasks, is_pad,
             h_init, m_real, boundary_m, k: int, eq_mode: str, stream):
    """Allocate the outputs and launch the q2meta kernel of ``lib`` on
    ``stream`` over the windows ``win`` describes; the caller has checked
    the inputs."""
    NW, P, T = win.shape
    Q, M = pmasks.shape[:2]
    dev = win.device
    out = [torch.empty((Q, NW, T), dtype=torch.int32, device=dev)
           for _ in range(4)]
    final = torch.empty((Q, T), dtype=torch.int32, device=dev)
    pidx = _pure_index(pmasks, eq_mode)
    carries = _carries(Q, M, T, dev)
    _raise_on(lib.sassy_scan_q_meta(
        *_desc_args(win), _ptr(tile0), _ptr(valid_from), _ptr(valid_to),
        _ptr(pmasks), _ptr(is_pad), _ptr(h_init), _ptr(pidx), _ptr(m_real),
        _ptr(boundary_m), *(_ptr(o) for o in out), _ptr(final),
        _ptr(carries), T, NW, P, M, Q, k, EQ_MODES[eq_mode], stream,
    ), "scan_q_meta")
    return (*out, final)


def launch_scan(lib, win, tile0, pmasks, is_pad, h_init, m_real: int,
                boundary_m: int, eq_mode: str, stream):
    """Allocate the outputs and launch the q1 kernel of ``lib`` on
    ``stream`` over the windows ``win`` describes; the caller has checked
    the inputs."""
    NW, P, T = win.shape
    M = pmasks.shape[0]
    dev = win.device
    out = [torch.empty((NW, T), dtype=torch.int32, device=dev)
           for _ in range(3)]
    pidx = _pure_index(pmasks, eq_mode)
    carries = _carries(1, M, T, dev)
    _raise_on(lib.sassy_scan(
        *_desc_args(win), _ptr(tile0), _ptr(pmasks), _ptr(is_pad),
        _ptr(h_init), _ptr(pidx), *(_ptr(o) for o in out), _ptr(carries),
        T, NW, P, M, m_real, boundary_m, EQ_MODES[eq_mode], stream,
    ), "scan")
    return tuple(out)


def launch_scan_q(lib, win, tile0, pmasks, is_pad, h_init, m_real,
                  boundary_m, eq_mode: str, stream):
    """Allocate the outputs and launch the q2 kernel of ``lib`` on
    ``stream`` over the windows ``win`` describes; the caller has checked
    the inputs."""
    NW, P, T = win.shape
    Q, M = pmasks.shape[:2]
    dev = win.device
    out = [torch.empty((Q, NW, T), dtype=torch.int32, device=dev)
           for _ in range(3)]
    pidx = _pure_index(pmasks, eq_mode)
    carries = _carries(Q, M, T, dev)
    _raise_on(lib.sassy_scan_q(
        *_desc_args(win), _ptr(tile0), _ptr(pmasks), _ptr(is_pad),
        _ptr(h_init), _ptr(pidx), _ptr(m_real), _ptr(boundary_m),
        *(_ptr(o) for o in out), _ptr(carries), T, NW, P, M, Q,
        EQ_MODES[eq_mode], stream,
    ), "scan_q")
    return tuple(out)


def scan_meta(win, tile0, valid_from, valid_to, pmasks, is_pad, h_init,
              m_real: int, boundary_m: int, k: int, eq_mode: str):
    """Single-pattern window scan with selection metadata.

    win: a ``myers_torch.Windows`` descriptor (the packed planes and each
    tile's ``wstart``/``wend``: window word i of tile t, plane p, is
    ``planes[p, wstart[t] + i]`` where ``0 <= wstart[t] + i <
    min(wend[t], L)``, else 0; ``Windows.of`` describes an (NW, P, T)
    window tensor); tile0 (T,) bool, the tile owns the text
    start; valid_from/valid_to (T,) int32 owned range; pmasks (M, P), is_pad
    (M,), h_init (M,) int32 bit patterns (ascii: pmasks (M, P - 1), the
    validity plane has no mask); eq_mode "iupac", "pure" (ACGT rows, one
    plane each) or "ascii". Returns vp, vm, cost, meta, each (NW, T), and
    final (T,), all int32.
    """
    if win.device.type == "cpu":
        return scan_meta_plain(win, tile0, valid_from, valid_to, pmasks,
                               is_pad, h_init, m_real, boundary_m, k, eq_mode)
    win = _descriptor(win)
    dev = win.device
    _check_inputs(win.shape, dev, tile0, valid_from, valid_to, pmasks,
                  is_pad, h_init, eq_mode, ())
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = launch(lib, win, tile0, valid_from, valid_to, pmasks,
                      is_pad, h_init, m_real, boundary_m, k, eq_mode, stream)
    scan_meta.launches += 1
    return outs


scan_meta.launches = 0


def scan_q_meta(win, tile0, valid_from, valid_to, pmasks, is_pad, h_init,
                m_real, boundary_m, k: int, eq_mode: str):
    """Pattern-batched window scan with selection metadata.

    The inputs of ``scan_meta`` with a leading pattern axis on the
    pattern's: pmasks (Q, M, P) ((Q, M, P - 1) for ascii), is_pad and
    h_init (Q, M), m_real and boundary_m (Q,) int32; the windows and tile
    vectors are shared. Returns vp, vm, cost, meta, each (Q, NW, T), and
    final (Q, T), all int32.
    """
    if win.device.type == "cpu":
        return scan_q_meta_plain(win, tile0, valid_from, valid_to,
                                 pmasks, is_pad, h_init, m_real, boundary_m,
                                 k, eq_mode)
    Q = pmasks.shape[0]
    win = _descriptor(win)
    dev = win.device
    _check_inputs(win.shape, dev, tile0, valid_from, valid_to, pmasks,
                  is_pad, h_init, eq_mode, (Q,))
    _check("m_real", m_real, torch.int32, (Q,), dev)
    _check("boundary_m", boundary_m, torch.int32, (Q,), dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = launch_q(lib, win, tile0, valid_from, valid_to, pmasks,
                        is_pad, h_init, m_real, boundary_m, k, eq_mode,
                        stream)
    scan_q_meta.launches += 1
    return outs


scan_q_meta.launches = 0


def scan(win, tile0, pmasks, is_pad, h_init, m_real: int, boundary_m: int,
         eq_mode: str):
    """Single-pattern window scan without metadata (q1).

    The inputs of ``scan_meta`` without the owned range and k. Returns vp,
    vm and cost, each (NW, T) int32.
    """
    if win.device.type == "cpu":
        return scan_plain(win, tile0, pmasks, is_pad, h_init, m_real,
                          boundary_m, eq_mode)
    win = _descriptor(win)
    dev = win.device
    _check_inputs(win.shape, dev, tile0, None, None, pmasks, is_pad, h_init,
                  eq_mode, ())
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = launch_scan(lib, win, tile0, pmasks, is_pad, h_init,
                           m_real, boundary_m, eq_mode, stream)
    scan.launches += 1
    return outs


scan.launches = 0


def scan_q(win, tile0, pmasks, is_pad, h_init, m_real, boundary_m,
           eq_mode: str):
    """Pattern-batched window scan without metadata (q2).

    The inputs of ``scan_q_meta`` without the owned range and k. Returns
    vp, vm and cost, each (Q, NW, T) int32.
    """
    if win.device.type == "cpu":
        return scan_q_plain(win, tile0, pmasks, is_pad, h_init, m_real,
                            boundary_m, eq_mode)
    Q = pmasks.shape[0]
    win = _descriptor(win)
    dev = win.device
    _check_inputs(win.shape, dev, tile0, None, None, pmasks, is_pad, h_init,
                  eq_mode, (Q,))
    _check("m_real", m_real, torch.int32, (Q,), dev)
    _check("boundary_m", boundary_m, torch.int32, (Q,), dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = launch_scan_q(lib, win, tile0, pmasks, is_pad, h_init,
                             m_real, boundary_m, eq_mode, stream)
    scan_q.launches += 1
    return outs


scan_q.launches = 0


def launch_scan_qn(lib, windows, tile0, pmasks, is_pad, h_init, m_real,
                   boundary_m, eq_mode: str, U: int, unroll: bool, WU: int,
                   stream):
    """Allocate the outputs and launch one member of the scan_qn family of
    ``lib`` on ``stream``; the caller has checked the inputs."""
    NW, P, T = windows.shape
    Q, M = pmasks.shape[:2]
    out = [torch.empty((Q, NW, T), dtype=torch.int32, device=windows.device)
           for _ in range(3)]
    pidx = _pure_index(pmasks, eq_mode)
    _raise_on(lib.sassy_scan_qn(
        _ptr(windows), _ptr(tile0), _ptr(pmasks), _ptr(is_pad), _ptr(h_init),
        _ptr(pidx), _ptr(m_real), _ptr(boundary_m), *(_ptr(o) for o in out),
        T, NW, P, M, Q, EQ_MODES[eq_mode], U, int(unroll), WU, stream,
    ), "scan_qn")
    return tuple(out)


def launch_scan_variant(lib, windows, pmasks, variant: str, stream):
    """Allocate the output and launch one row-step ablation of ``lib`` on
    ``stream``; the caller has checked the inputs."""
    NW, P, T = windows.shape
    out = torch.empty((1 if variant == "nostore" else NW, T),
                      dtype=torch.int32, device=windows.device)
    _raise_on(lib.sassy_scan_variant(
        _ptr(windows), _ptr(pmasks), _ptr(out), T, NW, P, pmasks.shape[0],
        VARIANTS[variant], stream,
    ), "scan_variant")
    return out


def qn_member_built(eq_mode: str, M: int, U: int, unroll: bool,
                    WU: int) -> bool:
    """Whether csrc/scan_qn.cu builds this member of the family."""
    if not unroll:
        return WU == 1 and U in QN_LOOP_U and (U == 1 or eq_mode == "iupac")
    return (eq_mode == "iupac" and (U, WU) in QN_UNROLL
            and M in QN_UNROLL_ROWS)


def scan_qn(windows, tile0, pmasks, is_pad, h_init, m_real, boundary_m,
            eq_mode: str, U: int = 1, unroll: bool = False, WU: int = 1):
    """The pattern-batched window scan without metadata, as one member of
    the kernel-design family: U patterns per thread, the row loop kept or
    (``unroll``) unrolled for this M, WU window words per iteration.

    The inputs and outputs of ``scan_q``; M <= 64, Q a multiple of U, NW a
    multiple of WU. U = 1 without unrolling at WU = 1 takes every eq_mode
    (the one-pattern-per-thread batched scan); the other members are built
    for "iupac", the unrolled ones for M in ``QN_UNROLL_ROWS``.
    ``scan_qn.members`` counts the launches per (U, unroll, WU).
    """
    if windows.device.type == "cpu":
        return scan_qn_plain(windows, tile0, pmasks, is_pad, h_init, m_real,
                             boundary_m, eq_mode, U, unroll, WU)
    Q, M = pmasks.shape[:2]
    dev = windows.device
    _check_inputs(tuple(windows.shape), dev, tile0, None, None, pmasks,
                  is_pad, h_init, eq_mode, (Q,))
    _check_window_tensor(windows)
    _check("m_real", m_real, torch.int32, (Q,), dev)
    _check("boundary_m", boundary_m, torch.int32, (Q,), dev)
    _check_qn(Q, windows.shape[0], M, U, WU)
    if not qn_member_built(eq_mode, M, U, unroll, WU):
        raise ValueError(
            f"scan_qn is not built for eq_mode {eq_mode!r}, M = {M}, U = {U},"
            f" unroll = {unroll}, WU = {WU}")
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = launch_scan_qn(lib, windows, tile0, pmasks, is_pad, h_init,
                              m_real, boundary_m, eq_mode, U, unroll, WU,
                              stream)
    scan_qn.launches += 1
    member = (U, bool(unroll), WU)
    scan_qn.members[member] = scan_qn.members.get(member, 0) + 1
    return outs


scan_qn.launches = 0
scan_qn.members = {}


def scan_variant(windows, pmasks, variant: str):
    """One ablation of the row step ("full", "noeq", "nomem", "nostore").

    windows (NW, 4, T) int32, pmasks (M, 4) int32, M <= 64. Returns vp
    (NW, T) int32; for "nostore" the per-tile sums of vp's popcounts,
    (1, T). ``scan_variant.members`` counts the launches per variant.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    NW, P, T = windows.shape
    M = pmasks.shape[0]
    if P != PLANES["iupac"]:
        raise ValueError(f"the ablations take {PLANES['iupac']} planes, "
                         f"windows have {P}")
    if M > REG_ROWS:
        raise ValueError(f"scan_variant keeps its row carries in registers: "
                         f"M = {M} > {REG_ROWS}")
    if windows.device.type == "cpu":
        return scan_variant_plain(windows, pmasks, variant)
    if windows.device.type != "cuda":
        raise ValueError(f"the scan kernels run on cpu or cuda, not "
                         f"{windows.device}")
    dev = windows.device
    _check("windows", windows, torch.int32, (NW, P, T), dev)
    _check("pmasks", pmasks, torch.int32, (M, P), dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        out = launch_scan_variant(lib, windows, pmasks, variant, stream)
    scan_variant.launches += 1
    scan_variant.members[variant] = scan_variant.members.get(variant, 0) + 1
    return out


scan_variant.launches = 0
scan_variant.members = {}


# -- the candidate selection -------------------------------------------------


def _check_words(name: str, x, shape, like=None):
    """A (…, NW, T) int32 word array on a CUDA device (that of ``like``)."""
    if x.dtype != torch.int32 or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected torch.int32 {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"the selection kernels run on cpu or cuda, not "
                         f"{x.device}")
    if like is not None and x.device != like.device:
        raise ValueError(f"{name} is on {x.device}, vp_w on {like.device}")


def _check_strides(name: str, x, like):
    """A word array read in place: the strides of ``like``, tiles adjacent
    (stride 1), as a range of tiles sliced from the scan outputs has."""
    if x.stride() != like.stride():
        raise ValueError(f"{name} must have the strides {like.stride()} of "
                         f"vp_w, not {x.stride()}")
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        raise ValueError(f"{name}: tiles must be adjacent (stride 1)")


def _small(name: str, x, dtype, shape, device):
    """A tile vector or per-(pattern, tile) table, checked and made
    contiguous (a few bytes per tile)."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, vp_w on {device}")
    return x.contiguous()


def _three_passes(launch, scratch, rows: int, device, emit_empty: bool):
    """The selections' three launches, with no PyTorch op between them:
    ``launch(0)`` counts or walks (the records), ``launch(1)`` scans them
    (the offsets, the carry out and the total, the last word of
    ``scratch``); the one host read of the total sizes the (rows, N) int64
    output, which ``launch(2, out, N)`` fills (also at N = 0 with
    ``emit_empty``, for a carry out written there)."""
    launch(0)
    launch(1)
    with spans.span("device_wait", device_waits=1):
        N = int(scratch[-1])
    out = torch.empty((rows, N), dtype=torch.int64, device=device)
    if N or emit_empty:
        launch(2, out, N)
    return out


def _carry_through(carry, Q: int, all_minima: bool, device):
    """The code carried out of a call over no tile: the carry in (code 3
    up, else 0; as it came with ``all_minima``), or 0."""
    if carry is None:
        return torch.zeros((Q, 1), dtype=torch.int32, device=device)
    if all_minima:
        return carry.clone()
    return torch.where((carry & 3) == 3, 3, 0).to(torch.int32)


def _select_words(counter, vp_w, vm_w, cost_w, meta, valid_from, valid_to,
                  islast_at, pos_base, k: int, all_minima: bool, text_end,
                  alpha, n_prev: int, state0=None, final=None, is_start=None,
                  carry=None):
    """The word-level selection kernel's three passes (``counter`` counts
    the call in ``.launches`` and each launch in ``.passes``); see
    ``select_words_chained``."""
    if vp_w.dim() != 3:
        raise ValueError(f"vp_w: expected (Q, NW, T), got {tuple(vp_w.shape)}")
    Q, NW, T = vp_w.shape
    _check_words("vp_w", vp_w, (Q, NW, T))
    for name, x in (("vm_w", vm_w), ("cost_w", cost_w), ("meta", meta)):
        _check_words(name, x, (Q, NW, T), vp_w)
    vp_w, vm_w, cost_w, meta = (x.contiguous()
                                for x in (vp_w, vm_w, cost_w, meta))
    dev = vp_w.device
    vf = _small("valid_from", valid_from, torch.int32, (T,), dev)
    vt = _small("valid_to", valid_to, torch.int32, (T,), dev)
    il = _small("islast_at", islast_at, torch.int32, (T,), dev)
    pb = _small("pos_base", pos_base, torch.int64, (T,), dev)
    if state0 is not None:
        state0 = _small("state0", state0, torch.int32, (Q, T), dev)
    if final is not None:
        final = _small("final", final, torch.int32, (Q, T), dev)
    if is_start is not None:
        is_start = _small("is_start", is_start, torch.bool, (T,), dev)
    if carry is not None:
        carry = _small("carry", carry, torch.int32, (Q, 1), dev)
    if text_end is not None:
        text_end = _small("text_end", text_end, torch.int64, (T,), dev)
        if alpha is None:
            raise ValueError("text_end needs alpha")
    if n_prev < 0:
        raise ValueError(f"n_prev = {n_prev} < 0")
    if Q * NW * T == 0:  # no element: the carry passes
        return (torch.empty((4, 0), dtype=torch.int64, device=dev),
                _carry_through(carry, Q, all_minima, dev))
    lib = _lib()
    carry_out = torch.empty((Q, 1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = torch.empty(lib.sassy_select_words_scratch(Q, NW, T),
                              dtype=torch.int64, device=dev)

        def launch(pass_, out=None, N=0):
            _raise_on(lib.sassy_select_words(
                _ptr(vp_w), _ptr(vm_w), _ptr(cost_w), _ptr(meta), _ptr(vf),
                _ptr(vt), _ptr(il), _ptr(pb), _ptr(text_end), _ptr(final),
                _ptr(is_start), _ptr(state0), _ptr(carry), _ptr(carry_out),
                _ptr(scratch), _ptr(out), N, Q, NW, T, k, int(all_minima),
                n_prev, 0.0 if alpha is None else alpha, pass_, stream,
            ), "select_words")
            counter.passes += 1

        out = _three_passes(launch, scratch, 4, dev, False)
    counter.launches += 1
    return out, carry_out


def select_words_chained(vp_w, vm_w, cost_w, meta, final, is_start, carry,
                         valid_from, valid_to, islast_at, pos_base, k: int,
                         all_minima: bool, text_end=None, alpha=None,
                         n_prev: int = 0):
    """The word-level selection kernel (``csrc/select_words.cu``) on CUDA
    tensors, the state chain across the tiles inside: what
    ``minima.select_words_chained_plain`` computes, with its inputs. vp_w,
    vm_w, cost_w, meta (Q, NW, T) int32, made contiguous (the engines pass
    whole scan outputs, which are); final (Q, T) int32, each tile's last
    owned delta code; is_start (T,) bool, the tiles that enter with the
    state reset; carry (Q, 1) int32 or None, the code entering tile 0 (3
    or 2 + 1 up); valid_from, valid_to, islast_at (T,) int32; pos_base
    (T,) int64; text_end (T,) int64 or None. At most three launches and
    one host read, no PyTorch op between them (``.passes`` counts the
    launches). Returns ((4, N) int64 [pattern; tile; end position; cost]
    in (pattern, word, tile, position) order, the (Q, 1) int32 code
    carried out: 3 up, else 0; with ``all_minima`` the carry in). Raises
    ValueError on other inputs."""
    return _select_words(select_words_chained, vp_w, vm_w, cost_w, meta,
                         valid_from, valid_to, islast_at, pos_base, k,
                         all_minima, text_end, alpha, n_prev, final=final,
                         is_start=is_start, carry=carry)


select_words_chained.launches = 0
select_words_chained.passes = 0


def select_words(vp_w, vm_w, cost_w, meta, valid_from, valid_to, islast_at,
                 pos_base, k: int, state0, all_minima: bool, text_end=None,
                 alpha=None, n_prev: int = 0):
    """The word-level selection kernel with each tile's entering state
    given, state0 (Q, T) int32 (1 up): what
    ``minima.select_words_tiles_q_plain`` computes, with its inputs (those
    of ``select_words_chained`` less the chain's). Returns the (4, N)
    columns. Raises ValueError on other inputs."""
    return _select_words(select_words, vp_w, vm_w, cost_w, meta, valid_from,
                         valid_to, islast_at, pos_base, k, all_minima,
                         text_end, alpha, n_prev, state0=state0)[0]


select_words.launches = 0
select_words.passes = 0


def select_positions(vp_w, vm_w, cost_w, W: int, halo: int, boundary_m: int,
                     n_text: int, max_pos: int, k: int, alpha,
                     all_minima: bool, min_pos: int | None = None,
                     owned_end: int | None = None, state0: int | None = None):
    """The position-level selection kernel of one text
    (``csrc/select_positions.cu``) on CUDA tensors: what
    ``minima.select_candidates_plain`` computes, with its inputs. vp_w,
    vm_w, cost_w (NW, T) int32 with the same strides, tiles adjacent,
    NW >= halo + W; each cost word is the scan's running sum (the walk
    reads one a tile). The state chain across the tiles (seeded by
    ``state0``) is the kernel's scan: at most three launches and one host
    read (``_three_passes``; ``.passes`` counts the launches). Returns
    (2, N) int64 [end position; cost] in position order. Raises
    ValueError on other inputs."""
    if vp_w.dim() != 2:
        raise ValueError(f"vp_w: expected (NW, T), got {tuple(vp_w.shape)}")
    NW, T = vp_w.shape
    _check_words("vp_w", vp_w, (NW, T))
    _check_strides("vp_w", vp_w, vp_w)
    for name, x in (("vm_w", vm_w), ("cost_w", cost_w)):
        _check_words(name, x, (NW, T), vp_w)
        _check_strides(name, x, vp_w)
    if W < 1 or halo < 0 or halo + W > NW:
        raise ValueError(f"tiles of W = {W} owned words after a halo of "
                         f"{halo} do not fit NW = {NW} window words")
    dev = vp_w.device
    if T == 0:
        return torch.empty((2, 0), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = torch.empty(lib.sassy_select_scratch_words(T),
                              dtype=torch.int64, device=dev)

        def launch(pass_, out=None, N=0):
            _raise_on(lib.sassy_select_positions(
                _ptr(vp_w), _ptr(vm_w), _ptr(cost_w), _ptr(scratch),
                _ptr(out), vp_w.stride(0), boundary_m, n_text, max_pos,
                0 if min_pos is None else min_pos,
                NO_END if owned_end is None else owned_end, N, T, W, halo, k,
                int(all_minima), int(state0 is not None), int(bool(state0)),
                0.0 if alpha is None else alpha, pass_, stream,
            ), "select_positions")
            select_positions.passes += 1

        out = _three_passes(launch, scratch, 2, dev, False)
    select_positions.launches += 1
    return out


select_positions.launches = 0
select_positions.passes = 0


def select_positions_tiles(vp_w, vm_w, cost_w, boundary0, text_end,
                           valid_from, valid_to, islast_at, pos_base, k: int,
                           alpha, state0, all_minima: bool, is_start=None,
                           carry=None):
    """The position-level selection kernel of Q patterns over pieces
    (``csrc/select_positions.cu``) on CUDA tensors. vp_w, vm_w, cost_w
    (Q, NW, T) int32 with the same strides, tiles adjacent, each cost word
    the scan's running sum; boundary0 (Q, T) int32; text_end, pos_base
    (T,) int64; valid_from, valid_to, islast_at (T,) int32.

    The state entering a piece: ``state0`` (Q, T) int32 (0 where None) at
    the pieces that reset, which are those of ``is_start`` (T,) bool, or
    every piece without it; else, at pattern q's first piece, ``carry``
    (Q, 1) int32 (code 3 up; 0 where None); else the state the piece
    before leaves. With ``state0`` alone this computes
    ``minima.select_candidates_tiles_plain``; with ``is_start`` and
    ``carry``, ``minima.select_candidates_chained_plain``. At most three
    launches and one host read (``_three_passes``; ``.passes`` counts
    the launches). Returns ((4, N) int64 [pattern; tile; end position;
    cost] in (pattern, tile, position) order, the (Q, 1) int32 code of
    the state leaving each pattern's last piece). Raises ValueError on
    other inputs."""
    if vp_w.dim() != 3:
        raise ValueError(f"vp_w: expected (Q, NW, T), got {tuple(vp_w.shape)}")
    Q, NW, T = vp_w.shape
    _check_words("vp_w", vp_w, (Q, NW, T))
    _check_strides("vp_w", vp_w, vp_w)
    for name, x in (("vm_w", vm_w), ("cost_w", cost_w)):
        _check_words(name, x, (Q, NW, T), vp_w)
        _check_strides(name, x, vp_w)
    dev = vp_w.device
    b0 = _small("boundary0", boundary0, torch.int32, (Q, T), dev)
    te = _small("text_end", text_end, torch.int64, (T,), dev)
    vf = _small("valid_from", valid_from, torch.int32, (T,), dev)
    vt = _small("valid_to", valid_to, torch.int32, (T,), dev)
    il = _small("islast_at", islast_at, torch.int32, (T,), dev)
    pb = _small("pos_base", pos_base, torch.int64, (T,), dev)
    if state0 is not None:
        state0 = _small("state0", state0, torch.int32, (Q, T), dev)
    if is_start is not None:
        is_start = _small("is_start", is_start, torch.bool, (T,), dev)
    if carry is not None:
        carry = _small("carry", carry, torch.int32, (Q, 1), dev)
    if Q * T == 0:  # no piece: the carry passes
        return (torch.empty((4, 0), dtype=torch.int64, device=dev),
                _carry_through(carry, Q, all_minima, dev))
    carry_out = torch.zeros((Q, 1), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = torch.empty(lib.sassy_select_scratch_words(Q * T),
                              dtype=torch.int64, device=dev)

        def launch(pass_, out=None, N=0):
            _raise_on(lib.sassy_select_positions_tiles(
                _ptr(vp_w), _ptr(vm_w), _ptr(cost_w), _ptr(b0), _ptr(te),
                _ptr(vf), _ptr(vt), _ptr(il), _ptr(pb), _ptr(state0),
                _ptr(is_start), _ptr(carry), _ptr(carry_out), _ptr(scratch),
                _ptr(out), vp_w.stride(0), vp_w.stride(1), N, Q, NW, T, k,
                int(all_minima), float(alpha), pass_, stream,
            ), "select_positions_tiles")
            select_positions_tiles.passes += 1

        out = _three_passes(launch, scratch, 4, dev, True)
    select_positions_tiles.launches += 1
    return out, carry_out


select_positions_tiles.launches = 0
select_positions_tiles.passes = 0


# -- the text pack -----------------------------------------------------------


def _check_pack(text_u8, nw: int, nb: int, planes: int, mode: str,
                shift: int, mask: int, pmasks, gw: int) -> None:
    """What the pack kernel takes: a contiguous 1-D uint8 text on a CUDA
    device holding every position < n = 32 nw + nb, and gw >= n / 32."""
    if not isinstance(text_u8, torch.Tensor) or text_u8.dtype != torch.uint8:
        raise ValueError(f"text: expected a torch.uint8 tensor, got "
                         f"{getattr(text_u8, 'dtype', type(text_u8))}")
    if text_u8.dim() != 1:
        raise ValueError(f"text: expected 1-D, got {tuple(text_u8.shape)}")
    if text_u8.device.type != "cuda":
        raise ValueError(f"the pack kernel runs on cpu or cuda, not "
                         f"{text_u8.device}")
    if not text_u8.is_contiguous():
        raise ValueError("text must be contiguous")
    if mode not in PACK_MODES:
        raise ValueError(f"unknown pack mode {mode!r}")
    if not 1 <= planes <= PACK_MAX_PLANES:
        raise ValueError(f"{planes} planes: the pack takes 1 to "
                         f"{PACK_MAX_PLANES}")
    if nw < 0 or not 0 <= nb < 32:
        raise ValueError(f"n = 32 * {nw} + {nb}: expected nw >= 0, "
                         f"0 <= nb < 32")
    n = 32 * nw + nb
    if n > text_u8.numel() or n > 32 * gw:
        raise ValueError(f"n = {n} positions: the text holds "
                         f"{text_u8.numel()}, {gw} words hold {32 * gw}")
    if mode == "table5" and (len(pmasks) < planes or not 0 <= shift <= 7
                             or not 0 <= mask <= 31):
        raise ValueError(f"table5 takes a plane mask a plane, shift 0-7 and "
                         f"mask 0-31: got {len(pmasks)} masks for {planes} "
                         f"planes, shift {shift}, mask {mask}")


def pack(text_u8, nw: int, nb: int, planes: int, with_valid: bool,
         mode: str, shift: int, mask: int, pmasks, fold: bool,
         gw: int | None = None):
    """The pack kernel (``csrc/pack.cu``) on a CUDA tensor: what
    ``myers_torch.pack_plain`` computes, bit for bit. text_u8 (L,) uint8,
    contiguous, holding positions 0 .. n - 1 (n = 32 nw + nb <= L; the
    kernel reads no byte at or past n); returns (planes + with_valid, gw)
    int32, gw defaulting to L // 32 (>= n / 32). One launch; raises
    ValueError before any build or launch on other inputs."""
    gw = text_u8.shape[0] // 32 if gw is None else int(gw)
    _check_pack(text_u8, nw, nb, planes, mode, shift, mask, pmasks, gw)
    dev = text_u8.device
    out = torch.empty((planes + int(bool(with_valid)), gw), dtype=torch.int32,
                      device=dev)
    if gw == 0:
        return out
    pm = (ctypes.c_uint * PACK_MAX_PLANES)(
        *[int(v) & 0xFFFFFFFF for v in tuple(pmasks)[:planes]])
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(lib.sassy_pack(
            _ptr(text_u8) if text_u8.numel() else None, text_u8.numel(),
            _ptr(out), gw, 0, nw, nb, planes, int(bool(with_valid)),
            PACK_MODES[mode], shift, mask, pm, int(bool(fold)), stream,
        ), "pack")
    pack.launches += 1
    return out


pack.launches = 0


def _check_pack_set(data, starts, lens, wofs, width: int, profile,
                    steps: int) -> None:
    """What the text set's pack kernel takes: a contiguous 1-D uint8 byte
    buffer on a CUDA device, contiguous int64 tables of T, T and T + 1
    entries on the same device, a positive width, no negative steps, and
    overhang steps only for a profile that supports overhang."""
    if (not isinstance(data, torch.Tensor) or data.dtype != torch.uint8
            or data.dim() != 1):
        raise ValueError(f"data: expected a 1-D torch.uint8 tensor, got "
                         f"{getattr(data, 'dtype', type(data))} "
                         f"{tuple(getattr(data, 'shape', ()))}")
    if data.device.type != "cuda":
        raise ValueError(f"the text set's pack kernel runs on cuda, not "
                         f"{data.device}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    T = starts.shape[0] if isinstance(starts, torch.Tensor) else -1
    for name, x, n in (("starts", starts, T), ("lens", lens, T),
                       ("wofs", wofs, T + 1)):
        if (not isinstance(x, torch.Tensor) or x.dtype != torch.int64
                or x.shape != (n,) or not x.is_contiguous()
                or x.device != data.device):
            raise ValueError(f"{name}: expected contiguous int64 ({n},) on "
                             f"{data.device}, got "
                             f"{getattr(x, 'dtype', type(x))} "
                             f"{tuple(getattr(x, 'shape', ()))}")
    if width < 1:
        raise ValueError(f"width {width}: the planes need a word")
    if steps < 0:
        raise ValueError(f"steps {steps} < 0")
    if steps and not profile.supports_overhang:
        raise ValueError(f"{steps} overhang steps on the {profile.name} "
                         f"profile, which has no overhang")
    planes = profile.planes
    if profile.pack_mode not in PACK_MODES or not 1 <= planes <= \
            PACK_MAX_PLANES:
        raise ValueError(f"pack mode {profile.pack_mode!r} with {planes} "
                         f"planes")
    if profile.pack_mode == "table5" and (
            len(profile.pack_plane_masks) < planes
            or not 0 <= profile.pack_shift <= 7
            or not 0 <= profile.pack_mask <= 31):
        raise ValueError("table5 takes a plane mask a plane, shift 0-7 and "
                         "mask 0-31")


def pack_set(data, starts, lens, wofs, width: int, profile,
             reverse: bool = False, steps: int = 0):
    """The text set's pack kernel (``csrc/pack.cu``, ``pack_set_words``)
    on CUDA tensors: what ``batch.pack_set_plain`` computes, bit for bit.
    data (L,) uint8, the texts' bytes; starts, lens (T,) int64, text t's
    first byte and length n_t; wofs (T + 1,) int64, its first plane word
    and the total. Returns (P[+1], width) int32: text t's words from
    wofs[t], its positions read backwards with ``reverse``, 'N' at its
    ``steps`` positions past n_t, zero past them and from word wofs[T] on;
    the kernel reads no byte outside a text (nor outside data). One
    launch; raises ValueError before any build or launch on other
    inputs."""
    width = int(width)
    _check_pack_set(data, starts, lens, wofs, width, profile, steps)
    with_valid = profile.eq_mode == "ascii"
    out = torch.empty((profile.planes + int(with_valid), width),
                      dtype=torch.int32, device=data.device)
    pm = (ctypes.c_uint * PACK_MAX_PLANES)(*[
        int(v) & 0xFFFFFFFF
        for v in tuple(profile.pack_plane_masks)[:profile.planes]])
    lib = _lib()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        _raise_on(lib.sassy_pack_set(
            _ptr(data) if data.numel() else None, data.numel(),
            _ptr(starts), _ptr(lens), _ptr(wofs), starts.shape[0], _ptr(out),
            width, int(steps), int(bool(reverse)), profile.planes,
            int(with_valid), PACK_MODES[profile.pack_mode],
            profile.pack_shift, profile.pack_mask, pm,
            int(bool(profile.pack_fold_case)), stream,
        ), "pack_set")
    pack_set.launches += 1
    return out


pack_set.launches = 0


# -- the host finish's traceback ---------------------------------------------


def _check_trace(planes, pcodes, cand, tables, profile, fill_len: int,
                 chunk: int) -> None:
    """What the traceback kernel takes: (rows, L) int32 planes on a CUDA
    device with a row a code plane at least, (Q, m) uint8 pattern codes,
    (5, B) int64 candidate columns and (3, m + 1) int32 tables, all
    contiguous on that device; fill_len >= 0, chunk >= 1."""
    if (not isinstance(planes, torch.Tensor) or planes.dtype != torch.int32
            or planes.dim() != 2):
        raise ValueError(f"planes: expected a 2-D torch.int32 tensor, got "
                         f"{getattr(planes, 'dtype', type(planes))} "
                         f"{tuple(getattr(planes, 'shape', ()))}")
    if planes.device.type != "cuda":
        raise ValueError(f"the traceback kernel runs on cuda, not "
                         f"{planes.device}")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")
    if profile.eq_mode not in TRACE_EQ or not 1 <= profile.planes <= min(
            PACK_MAX_PLANES, planes.shape[0]):
        raise ValueError(f"the {profile.name} profile's {profile.planes} "
                         f"planes ({profile.eq_mode} eq) in "
                         f"{planes.shape[0]} rows")
    for name, x, dtype in (("pcodes", pcodes, torch.uint8),
                           ("cand", cand, torch.int64),
                           ("tables", tables, torch.int32)):
        if (not isinstance(x, torch.Tensor) or x.dtype != dtype
                or x.dim() != 2 or not x.is_contiguous()
                or x.device != planes.device):
            raise ValueError(f"{name}: expected a contiguous 2-D {dtype} "
                             f"tensor on {planes.device}, got "
                             f"{getattr(x, 'dtype', type(x))} "
                             f"{tuple(getattr(x, 'shape', ()))} on "
                             f"{getattr(x, 'device', None)}")
    m = pcodes.shape[1]
    if cand.shape[0] != 5 or tuple(tables.shape) != (3, m + 1):
        raise ValueError(f"cand {tuple(cand.shape)}, tables "
                         f"{tuple(tables.shape)}: expected (5, B) and "
                         f"(3, {m + 1})")
    if fill_len < 0 or chunk < 1:
        raise ValueError(f"fill_len = {fill_len}, chunk = {chunk}")


def trace_cells(chunk: int, m: int, fill_len: int) -> int:
    """The traceback kernel's scratch in cells (``TRACE_CELL_BYTES``
    each) for ``chunk`` candidates: each candidate's (pattern row, window
    word) cells by anti-diagonal (``trace_at`` in ``csrc/trace.cuh``), m +
    nwp diagonals of nwp words, nwp the ceil(fill_len / 32) window words
    rounded up to a multiple of the words a row of the fill keeps in
    registers (``trace_dispatch``: all of them, at most
    ``TRACE_GROUP_MAX``)."""
    nw = -(-int(fill_len) // 32)
    group = min(max(nw, 1), TRACE_GROUP_MAX)
    nwp = -(-nw // group) * group
    return chunk * (m + nwp) * nwp


def trace_windows(planes, pcodes, cand, tables, profile, fill_len: int,
                  alpha_on: bool, chunk: int):
    """The traceback kernel (``csrc/trace.cu``) on CUDA tensors: what
    ``traceback.trace_plain`` computes on the same inputs, bit for bit.
    planes (rows, L) int32, the strand's; pcodes (Q, m) uint8; cand (5, B)
    int64: each candidate's pattern, its text's first plane word, its
    window's offset and length, its end; tables (3, m + 1) int32
    (``traceback.trace_tables``: a left boundary that starts at 0 and
    steps by 0 or 1). Every window must lie in the planes, hold at most
    ``fill_len`` positions and end no more than m before its candidate
    (the caller checks; a word at or past L reads as zero). Returns the
    (B, stride) int32 output rows on the device
    (``traceback.unpack_trace``). One launch a ``chunk`` of candidates, in
    one scratch of their delta words (``trace_cells``); raises ValueError
    before any build or launch on other inputs."""
    fill_len, chunk = int(fill_len), int(chunk)
    _check_trace(planes, pcodes, cand, tables, profile, fill_len, chunk)
    dev = planes.device
    m, B = pcodes.shape[1], cand.shape[1]
    stride = TRACE_FIELDS + -(-(m + fill_len + 1) // 4)
    out = torch.empty((B, stride), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    chunk = min(chunk, B)
    # int32 words: the allocator's blocks are 16-byte aligned
    cells = torch.empty(max(1, trace_cells(chunk, m, fill_len))
                        * (TRACE_CELL_BYTES // 4),
                        dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b0 in range(0, B, chunk):
            _raise_on(lib.sassy_trace(
                _ptr(planes), planes.shape[1], profile.planes,
                TRACE_EQ[profile.eq_mode], _ptr(pcodes) if m else None,
                _ptr(cand), B, _ptr(tables), m, fill_len, int(bool(alpha_on)),
                _ptr(out), stride, _ptr(cells), chunk, b0,
                min(chunk, B - b0), stream), "trace")
            trace_windows.launches += 1
    return out


trace_windows.launches = 0
