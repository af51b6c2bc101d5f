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

The sources share the row step of ``csrc/myers_step.cuh``. They are
compiled with one ``nvcc`` call for ``sm_90a`` at first use into one
library in ``build/sassy_tpu_torch/`` beside the package, keyed by a hash
of the sources and flags, and loaded with ctypes through plain C entry
points.

Each wrapper runs the plain version for tensors on the CPU and its kernel
for tensors on a CUDA device; there is no other fallback. Its
``launches`` attribute counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import minima, myers_torch

__all__ = ["scan_meta", "scan_meta_plain", "scan_q_meta",
           "scan_q_meta_plain", "scan", "scan_plain", "scan_q",
           "scan_q_plain", "scan_qn", "scan_qn_plain", "scan_variant",
           "scan_variant_plain", "build", "nvcc_path"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "scan_meta.cu", CSRC / "scan_q_meta.cu", CSRC / "scan.cu",
           CSRC / "scan_q.cu", CSRC / "scan_qn.cu", CSRC / "scan_variants.cu")
HEADERS = (CSRC / "myers_step.cuh",)
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


def build() -> Path:
    """Compile the kernel library unless these sources are built already.
    Returns its path; ``<path>.log`` keeps the compiler's report
    (registers, spills). Raises with nvcc's stderr when the build fails."""
    key = hashlib.sha256(
        b"".join(f.read_bytes() for f in SOURCES + HEADERS)
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"scan_kernels_{key}.so"
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
        lib.sassy_scan_meta.argtypes = [ptr] * 14 + [num] * 8 + [ptr]
        lib.sassy_scan_q_meta.argtypes = [ptr] * 16 + [num] * 7 + [ptr]
        lib.sassy_scan.argtypes = [ptr] * 10 + [num] * 7 + [ptr]
        lib.sassy_scan_q.argtypes = [ptr] * 12 + [num] * 6 + [ptr]
        lib.sassy_scan_qn.argtypes = [ptr] * 11 + [num] * 9 + [ptr]
        lib.sassy_scan_variant.argtypes = [ptr] * 3 + [num] * 5 + [ptr]
        for fn in (lib.sassy_scan_meta, lib.sassy_scan_q_meta, lib.sassy_scan,
                   lib.sassy_scan_q, lib.sassy_scan_qn,
                   lib.sassy_scan_variant):
            fn.restype = num
        _LIBS[path] = lib
    return lib


def scan_q_plain(windows, tile0, pmasks, is_pad, h_init, m_real,
                 boundary_m, eq_mode: str):
    """Plain PyTorch version of the q2 kernel: ``myers_torch.scan_core``
    over Q patterns from the tiles' initial state (the true-start h deltas
    and boundary cost where ``tile0`` is set, the plain cost-j boundary
    elsewhere). ``m_real``/``boundary_m`` are (Q,) int32."""
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
    ``scan_q_plain``; U, unroll and WU only shape the kernel."""
    _check_qn(pmasks.shape[0], windows.shape[0], pmasks.shape[1], U, WU)
    return scan_q_plain(windows, tile0, pmasks, is_pad, h_init, m_real,
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


def scan_plain(windows, tile0, pmasks, is_pad, h_init, m_real: int,
               boundary_m: int, eq_mode: str):
    """Plain PyTorch version of the q1 kernel: ``scan_q_plain`` of the one
    pattern."""
    scal = torch.tensor([[m_real], [boundary_m]], dtype=torch.int32,
                        device=windows.device)
    outs = scan_q_plain(windows, tile0, pmasks[None], is_pad[None],
                        h_init[None], scal[0], scal[1], eq_mode)
    return tuple(o[0] for o in outs)


def scan_q_meta_plain(windows, tile0, valid_from, valid_to, pmasks, is_pad,
                      h_init, m_real, boundary_m, k: int, eq_mode: str):
    """Plain PyTorch version of the q2meta kernel: ``scan_q_plain``, then
    ``minima.meta_from_words``."""
    vp, vm, cost = scan_q_plain(windows, tile0, pmasks, is_pad, h_init,
                                m_real, boundary_m, eq_mode)
    meta, final = minima.meta_from_words(vp, vm, cost, valid_from, valid_to, k)
    return vp, vm, cost, meta, final


def scan_meta_plain(windows, tile0, valid_from, valid_to, pmasks, is_pad,
                    h_init, m_real: int, boundary_m: int, k: int,
                    eq_mode: str):
    """Plain PyTorch version of the q1meta kernel: ``scan_q_meta_plain`` of
    the one pattern."""
    scal = torch.tensor([[m_real], [boundary_m]], dtype=torch.int32,
                        device=windows.device)
    outs = scan_q_meta_plain(windows, tile0, valid_from, valid_to,
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


def _check_inputs(windows, tile0, valid_from, valid_to, pmasks, is_pad,
                  h_init, eq_mode: str, lead: tuple):
    """Device, dtype, shape and contiguity of the inputs the kernels share
    (``valid_from``/``valid_to`` None for the kernels without metadata);
    ``lead`` is () for one pattern, (Q,) for Q. Returns the device."""
    if windows.device.type != "cuda":
        raise ValueError(f"the scan kernels run on cpu or cuda, not "
                         f"{windows.device}")
    if eq_mode not in EQ_MODES:
        raise ValueError(f"unknown eq_mode {eq_mode!r}")
    NW, P, T = windows.shape
    M = pmasks.shape[len(lead)]
    dev = windows.device
    if P != PLANES[eq_mode]:
        raise ValueError(f"eq_mode {eq_mode!r} takes {PLANES[eq_mode]} "
                         f"planes, windows have {P}")
    PM = P - 1 if eq_mode == "ascii" else P  # no mask for the validity plane
    if M * (PM + 2) * 4 > MAX_SMEM:
        raise ValueError(f"{M} pattern rows exceed the kernel's shared memory")
    _check("windows", windows, torch.int32, (NW, P, T), dev)
    _check("tile0", tile0, torch.bool, (T,), dev)
    if valid_from is not None:
        _check("valid_from", valid_from, torch.int32, (T,), dev)
        _check("valid_to", valid_to, torch.int32, (T,), dev)
    _check("pmasks", pmasks, torch.int32, (*lead, M, PM), dev)
    _check("is_pad", is_pad, torch.int32, (*lead, M), dev)
    _check("h_init", h_init, torch.int32, (*lead, M), dev)
    return dev


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


def launch(lib, windows, tile0, valid_from, valid_to, pmasks, is_pad, h_init,
           m_real: int, boundary_m: int, k: int, eq_mode: str, stream):
    """Allocate the outputs and launch the q1meta kernel of ``lib`` on
    ``stream`` (a raw stream handle); the caller has checked the inputs."""
    NW, P, T = windows.shape
    M = pmasks.shape[0]
    out = [torch.empty((NW, T), dtype=torch.int32, device=windows.device)
           for _ in range(4)]
    final = torch.empty((T,), dtype=torch.int32, device=windows.device)
    pidx = _pure_index(pmasks, eq_mode)
    carries = _carries(1, M, T, windows.device)
    _raise_on(lib.sassy_scan_meta(
        _ptr(windows), _ptr(tile0), _ptr(valid_from), _ptr(valid_to),
        _ptr(pmasks), _ptr(is_pad), _ptr(h_init), _ptr(pidx),
        *(_ptr(o) for o in out), _ptr(final), _ptr(carries),
        T, NW, P, M, m_real, boundary_m, k, EQ_MODES[eq_mode], stream,
    ), "scan_meta")
    return (*out, final)


def launch_q(lib, windows, tile0, valid_from, valid_to, pmasks, is_pad,
             h_init, m_real, boundary_m, k: int, eq_mode: str, stream):
    """Allocate the outputs and launch the q2meta kernel of ``lib`` on
    ``stream``; the caller has checked the inputs."""
    NW, P, T = windows.shape
    Q, M = pmasks.shape[:2]
    dev = windows.device
    out = [torch.empty((Q, NW, T), dtype=torch.int32, device=dev)
           for _ in range(4)]
    final = torch.empty((Q, T), dtype=torch.int32, device=dev)
    pidx = _pure_index(pmasks, eq_mode)
    carries = _carries(Q, M, T, dev)
    _raise_on(lib.sassy_scan_q_meta(
        _ptr(windows), _ptr(tile0), _ptr(valid_from), _ptr(valid_to),
        _ptr(pmasks), _ptr(is_pad), _ptr(h_init), _ptr(pidx), _ptr(m_real),
        _ptr(boundary_m), *(_ptr(o) for o in out), _ptr(final),
        _ptr(carries), T, NW, P, M, Q, k, EQ_MODES[eq_mode], stream,
    ), "scan_q_meta")
    return (*out, final)


def launch_scan(lib, windows, tile0, pmasks, is_pad, h_init, m_real: int,
                boundary_m: int, eq_mode: str, stream):
    """Allocate the outputs and launch the q1 kernel of ``lib`` on
    ``stream``; the caller has checked the inputs."""
    NW, P, T = windows.shape
    M = pmasks.shape[0]
    out = [torch.empty((NW, T), dtype=torch.int32, device=windows.device)
           for _ in range(3)]
    pidx = _pure_index(pmasks, eq_mode)
    carries = _carries(1, M, T, windows.device)
    _raise_on(lib.sassy_scan(
        _ptr(windows), _ptr(tile0), _ptr(pmasks), _ptr(is_pad), _ptr(h_init),
        _ptr(pidx), *(_ptr(o) for o in out), _ptr(carries), T, NW, P, M,
        m_real, boundary_m, EQ_MODES[eq_mode], stream,
    ), "scan")
    return tuple(out)


def launch_scan_q(lib, windows, tile0, pmasks, is_pad, h_init, m_real,
                  boundary_m, eq_mode: str, stream):
    """Allocate the outputs and launch the q2 kernel of ``lib`` on
    ``stream``; the caller has checked the inputs."""
    NW, P, T = windows.shape
    Q, M = pmasks.shape[:2]
    dev = windows.device
    out = [torch.empty((Q, NW, T), dtype=torch.int32, device=dev)
           for _ in range(3)]
    pidx = _pure_index(pmasks, eq_mode)
    carries = _carries(Q, M, T, dev)
    _raise_on(lib.sassy_scan_q(
        _ptr(windows), _ptr(tile0), _ptr(pmasks), _ptr(is_pad), _ptr(h_init),
        _ptr(pidx), _ptr(m_real), _ptr(boundary_m), *(_ptr(o) for o in out),
        _ptr(carries), T, NW, P, M, Q, EQ_MODES[eq_mode], stream,
    ), "scan_q")
    return tuple(out)


def scan_meta(windows, tile0, valid_from, valid_to, pmasks, is_pad, h_init,
              m_real: int, boundary_m: int, k: int, eq_mode: str):
    """Single-pattern window scan with selection metadata.

    windows (NW, P, T) int32 text words; tile0 (T,) bool, the tile owns the
    text start; valid_from/valid_to (T,) int32 owned range; pmasks (M, P),
    is_pad (M,), h_init (M,) int32 bit patterns (ascii: pmasks (M, P - 1),
    the validity plane has no mask); eq_mode "iupac", "pure"
    (ACGT rows, one plane each) or "ascii". Returns vp, vm, cost, meta,
    each (NW, T), and final (T,), all int32.
    """
    if windows.device.type == "cpu":
        return scan_meta_plain(windows, tile0, valid_from, valid_to, pmasks,
                               is_pad, h_init, m_real, boundary_m, k, eq_mode)
    dev = _check_inputs(windows, tile0, valid_from, valid_to, pmasks, is_pad,
                        h_init, eq_mode, ())
    lib = load_library(build())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = launch(lib, windows, tile0, valid_from, valid_to, pmasks,
                      is_pad, h_init, m_real, boundary_m, k, eq_mode, stream)
    scan_meta.launches += 1
    return outs


scan_meta.launches = 0


def scan_q_meta(windows, tile0, valid_from, valid_to, pmasks, is_pad, h_init,
                m_real, boundary_m, k: int, eq_mode: str):
    """Pattern-batched window scan with selection metadata.

    The inputs of ``scan_meta`` with a leading pattern axis on the
    pattern's: pmasks (Q, M, P) ((Q, M, P - 1) for ascii), is_pad and
    h_init (Q, M), m_real and boundary_m (Q,) int32; the windows and tile
    vectors are shared. Returns vp, vm, cost, meta, each (Q, NW, T), and
    final (Q, T), all int32.
    """
    if windows.device.type == "cpu":
        return scan_q_meta_plain(windows, tile0, valid_from, valid_to,
                                 pmasks, is_pad, h_init, m_real, boundary_m,
                                 k, eq_mode)
    Q = pmasks.shape[0]
    dev = _check_inputs(windows, tile0, valid_from, valid_to, pmasks, is_pad,
                        h_init, eq_mode, (Q,))
    _check("m_real", m_real, torch.int32, (Q,), dev)
    _check("boundary_m", boundary_m, torch.int32, (Q,), dev)
    lib = load_library(build())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = launch_q(lib, windows, tile0, valid_from, valid_to, pmasks,
                        is_pad, h_init, m_real, boundary_m, k, eq_mode,
                        stream)
    scan_q_meta.launches += 1
    return outs


scan_q_meta.launches = 0


def scan(windows, tile0, pmasks, is_pad, h_init, m_real: int,
         boundary_m: int, eq_mode: str):
    """Single-pattern window scan without metadata (q1).

    The inputs of ``scan_meta`` without the owned range and k. Returns vp,
    vm and cost, each (NW, T) int32.
    """
    if windows.device.type == "cpu":
        return scan_plain(windows, tile0, pmasks, is_pad, h_init, m_real,
                          boundary_m, eq_mode)
    dev = _check_inputs(windows, tile0, None, None, pmasks, is_pad, h_init,
                        eq_mode, ())
    lib = load_library(build())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = launch_scan(lib, windows, tile0, pmasks, is_pad, h_init,
                           m_real, boundary_m, eq_mode, stream)
    scan.launches += 1
    return outs


scan.launches = 0


def scan_q(windows, tile0, pmasks, is_pad, h_init, m_real, boundary_m,
           eq_mode: str):
    """Pattern-batched window scan without metadata (q2).

    The inputs of ``scan_q_meta`` without the owned range and k. Returns
    vp, vm and cost, each (Q, NW, T) int32.
    """
    if windows.device.type == "cpu":
        return scan_q_plain(windows, tile0, pmasks, is_pad, h_init, m_real,
                            boundary_m, eq_mode)
    Q = pmasks.shape[0]
    dev = _check_inputs(windows, tile0, None, None, pmasks, is_pad, h_init,
                        eq_mode, (Q,))
    _check("m_real", m_real, torch.int32, (Q,), dev)
    _check("boundary_m", boundary_m, torch.int32, (Q,), dev)
    lib = load_library(build())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = launch_scan_q(lib, windows, tile0, pmasks, is_pad, h_init,
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
    dev = _check_inputs(windows, tile0, None, None, pmasks, is_pad, h_init,
                        eq_mode, (Q,))
    _check("m_real", m_real, torch.int32, (Q,), dev)
    _check("boundary_m", boundary_m, torch.int32, (Q,), dev)
    _check_qn(Q, windows.shape[0], M, U, WU)
    if not qn_member_built(eq_mode, M, U, unroll, WU):
        raise ValueError(
            f"scan_qn is not built for eq_mode {eq_mode!r}, M = {M}, U = {U},"
            f" unroll = {unroll}, WU = {WU}")
    lib = load_library(build())
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
    lib = load_library(build())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        out = launch_scan_variant(lib, windows, pmasks, variant, stream)
    scan_variant.launches += 1
    scan_variant.members[variant] = scan_variant.members.get(variant, 0) + 1
    return out


scan_variant.launches = 0
scan_variant.members = {}
