"""The scan kernels on the H100: build, load and launch, each beside its
plain PyTorch version.

- ``scan_meta`` (q1meta, ``csrc/scan_meta.cu``) replaces
  ``get_pallas_scan_meta`` of ``sassy_tpu/ops/myers_pallas.py``: one
  pattern; ``scan_meta_plain`` is its plain version.
- ``scan_q_meta`` (q2meta, ``csrc/scan_q_meta.cu``) replaces
  ``get_pallas_scan_q2_meta``: Q patterns over the same windows;
  ``scan_q_meta_plain`` is its plain version.

Both sources share the per-tile scan of ``csrc/myers_step.cuh``. They are
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
           "scan_q_meta_plain", "build", "nvcc_path"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = (CSRC / "scan_meta.cu", CSRC / "scan_q_meta.cu")
HEADERS = (CSRC / "myers_step.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sassy_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
EQ_MODES = {"iupac": 0, "pure": 1, "ascii": 2}
PLANES = {"iupac": 4, "pure": 4, "ascii": 9}
#: pattern rows whose carries the kernel keeps in registers
REG_ROWS = 64
#: shared memory a block may use on the H100 (bytes)
MAX_SMEM = 232448

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
        lib.sassy_scan_meta.restype = num
        lib.sassy_scan_q_meta.restype = num
        _LIBS[path] = lib
    return lib


def scan_q_meta_plain(windows, tile0, valid_from, valid_to, pmasks, is_pad,
                      h_init, m_real, boundary_m, k: int, eq_mode: str):
    """Plain PyTorch version of the q2meta kernel: ``myers_torch.scan_core``
    over Q patterns from the tiles' initial state, then
    ``minima.meta_from_words``. ``m_real``/``boundary_m`` are (Q,) int32."""
    Q, M = pmasks.shape[:2]
    hp0 = torch.where(
        is_pad.view(Q, M, 1) != 0, 0,
        torch.where(tile0.view(1, 1, -1), h_init.view(Q, M, 1), 1),
    ).to(torch.int32)
    hm0 = torch.zeros_like(hp0)
    cost0 = torch.where(tile0.view(1, -1), boundary_m.view(Q, 1),
                        m_real.view(Q, 1)).to(torch.int32)
    vp, vm, cost = myers_torch.scan_core(
        windows, pmasks, is_pad, hp0, hm0, cost0, eq_mode
    )
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
    """Device, dtype, shape and contiguity of the inputs both kernels
    share; ``lead`` is () for one pattern, (Q,) for Q. Returns the device."""
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


def launch(lib, windows, tile0, valid_from, valid_to, pmasks, is_pad, h_init,
           m_real: int, boundary_m: int, k: int, eq_mode: str, stream):
    """Allocate the outputs and launch the q1meta kernel of ``lib`` on
    ``stream`` (a raw stream handle); the caller has checked the inputs."""
    NW, P, T = windows.shape
    M = pmasks.shape[0]
    out = [torch.empty((NW, T), dtype=torch.int32, device=windows.device)
           for _ in range(4)]
    final = torch.empty((T,), dtype=torch.int32, device=windows.device)
    pidx = (myers_torch.pure_plane_index(pmasks).contiguous()
            if eq_mode == "pure" else None)
    carries = _carries(1, M, T, windows.device)
    err = lib.sassy_scan_meta(
        _ptr(windows), _ptr(tile0), _ptr(valid_from), _ptr(valid_to),
        _ptr(pmasks), _ptr(is_pad), _ptr(h_init), _ptr(pidx),
        *(_ptr(o) for o in out), _ptr(final), _ptr(carries),
        T, NW, P, M, m_real, boundary_m, k, EQ_MODES[eq_mode], stream,
    )
    if err != 0:
        raise RuntimeError(f"scan_meta kernel launch failed: CUDA error {err}")
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
    pidx = (myers_torch.pure_plane_index(pmasks.reshape(Q * M, -1))
            .view(Q, M).contiguous() if eq_mode == "pure" else None)
    carries = _carries(Q, M, T, dev)
    err = lib.sassy_scan_q_meta(
        _ptr(windows), _ptr(tile0), _ptr(valid_from), _ptr(valid_to),
        _ptr(pmasks), _ptr(is_pad), _ptr(h_init), _ptr(pidx), _ptr(m_real),
        _ptr(boundary_m), *(_ptr(o) for o in out), _ptr(final),
        _ptr(carries), T, NW, P, M, Q, k, EQ_MODES[eq_mode], stream,
    )
    if err != 0:
        raise RuntimeError(
            f"scan_q_meta kernel launch failed: CUDA error {err}"
        )
    return (*out, final)


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
