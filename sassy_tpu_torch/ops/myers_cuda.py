"""The q1meta scan kernel on the H100: build, load and launch
(``scan_meta``), and its plain PyTorch version (``scan_meta_plain``).

``csrc/scan_meta.cu`` replaces ``get_pallas_scan_meta`` of
``sassy_tpu/ops/myers_pallas.py``. It is compiled with ``nvcc`` for
``sm_90a`` at first use into ``build/sassy_tpu_torch/`` beside the
package, keyed by a hash of the source and flags, and loaded with ctypes
through a plain C entry point.

``scan_meta`` runs the plain version for tensors on the CPU and the kernel
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

__all__ = ["scan_meta", "scan_meta_plain", "build", "nvcc_path"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "scan_meta.cu"
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
    """Compile the kernel library unless this source is built already.
    Returns its path; ``<path>.log`` keeps the compiler's report
    (registers, spills). Raises with nvcc's stderr when the build fails."""
    key = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"scan_meta_{key}.so"
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the scan kernel needs the CUDA "
                           "toolkit to build")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
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
    """Load a built kernel library and declare its C entry point."""
    path = str(path)
    lib = _LIBS.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        fn = lib.sassy_scan_meta
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _LIBS[path] = lib
    return lib


def scan_meta_plain(windows, tile0, valid_from, valid_to, pmasks, is_pad,
                    h_init, m_real: int, boundary_m: int, k: int,
                    eq_mode: str):
    """Plain PyTorch version of the kernel: ``myers_torch.scan_core`` from
    the tiles' initial state, then ``minima.meta_from_words``."""
    M = pmasks.shape[0]
    t0 = tile0.view(1, -1)
    hp0 = torch.where(
        is_pad.view(M, 1) != 0, 0, torch.where(t0, h_init.view(M, 1), 1)
    ).to(torch.int32)
    hm0 = torch.zeros_like(hp0)
    cost0 = torch.where(tile0, boundary_m, m_real).to(torch.int32)
    vp, vm, cost = myers_torch.scan_core(
        windows, pmasks, is_pad, hp0, hm0, cost0, eq_mode
    )
    meta, final = minima.meta_from_words(vp, vm, cost, valid_from, valid_to, k)
    return vp, vm, cost, meta, final


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, windows on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(lib, windows, tile0, valid_from, valid_to, pmasks, is_pad, h_init,
           m_real: int, boundary_m: int, k: int, eq_mode: str, stream):
    """Allocate the outputs and launch the kernel of ``lib`` on ``stream``
    (a raw stream handle); the caller has checked the inputs."""
    NW, P, T = windows.shape
    M = pmasks.shape[0]
    out = [torch.empty((NW, T), dtype=torch.int32, device=windows.device)
           for _ in range(4)]
    final = torch.empty((T,), dtype=torch.int32, device=windows.device)
    pidx = (myers_torch.pure_plane_index(pmasks).contiguous()
            if eq_mode == "pure" else None)
    carries = (torch.empty((2 * -(-M // 32), T), dtype=torch.int32,
                           device=windows.device)
               if M > REG_ROWS else None)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = lib.sassy_scan_meta(
        ptr(windows), ptr(tile0), ptr(valid_from), ptr(valid_to),
        ptr(pmasks), ptr(is_pad), ptr(h_init), ptr(pidx),
        *(ptr(o) for o in out), ptr(final), ptr(carries),
        T, NW, P, M, m_real, boundary_m, k, EQ_MODES[eq_mode], stream,
    )
    if err != 0:
        raise RuntimeError(f"scan_meta kernel launch failed: CUDA error {err}")
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
    if windows.device.type != "cuda":
        raise ValueError(f"scan_meta runs on cpu or cuda, not {windows.device}")
    if eq_mode not in EQ_MODES:
        raise ValueError(f"unknown eq_mode {eq_mode!r}")
    NW, P, T = windows.shape
    M = pmasks.shape[0]
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
    _check("pmasks", pmasks, torch.int32, (M, PM), dev)
    _check("is_pad", is_pad, torch.int32, (M,), dev)
    _check("h_init", h_init, torch.int32, (M,), dev)
    lib = load_library(build())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        outs = launch(lib, windows, tile0, valid_from, valid_to, pmasks,
                      is_pad, h_init, m_real, boundary_m, k, eq_mode, stream)
    scan_meta.launches += 1
    return outs


scan_meta.launches = 0
