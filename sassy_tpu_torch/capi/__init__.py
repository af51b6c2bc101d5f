"""The port's C ABI: ``sassy_tpu.h`` (the surface of the JAX package's
``c/sassy_tpu.h``), its implementation ``sassy_tpu_torch_c.cc``, which
embeds CPython and forwards to ``sassy_tpu_torch.Searcher`` on the device
that ``SASSY_DEVICE`` names ("cuda" by default), and ``example.c``.

``build()`` compiles the library and the example with g++ into
``build/sassy_tpu_torch/`` (``gxx.build``; never into ``c/``, which is the
JAX package's), with the include and link flags of the running Python from
``sysconfig``. Run the example as

    SASSY_DEVICE=cpu PYTHONPATH=<repo> <example path>

where PYTHONPATH also names the running Python's ``sys.path`` if its
packages (torch, numpy) live outside the embedded interpreter's default
path, e.g. in a virtual environment.
"""

from __future__ import annotations

import sysconfig
from pathlib import Path

from .. import gxx

__all__ = ["build", "HEADER", "SOURCE", "EXAMPLE"]

HERE = Path(__file__).resolve().parent
HEADER = HERE / "sassy_tpu.h"
SOURCE = HERE / "sassy_tpu_torch_c.cc"
EXAMPLE = HERE / "example.c"


def _python_flags() -> tuple[list[str], list[str]]:
    """(compile flags, link flags) that embed the running Python
    (``python3-config --includes`` / ``--ldflags --embed``, from
    ``sysconfig``)."""
    cv = sysconfig.get_config_var
    paths = sysconfig.get_paths()
    inc = sorted({paths["include"], paths["platinclude"]})
    libdir = cv("LIBDIR")
    libs = [f"-L{libdir}", f"-lpython{cv('LDVERSION')}",
            *(cv("LIBS") or "").split(), *(cv("SYSLIBS") or "").split(),
            f"-Wl,-rpath,{libdir}"]
    return [f"-I{d}" for d in inc], libs


def build(build_dir: Path | None = None) -> tuple[Path, Path]:
    """Compile ``libsassy_tpu_torch_c.so`` and the ``example`` program
    unless these sources are built already; returns (library, example).
    The example finds the library through its rpath. Raises
    ``RuntimeError`` with g++'s stderr when a build fails (e.g. the
    Python headers or libpython are missing)."""
    cflags, libs = _python_flags()
    lib = gxx.build(
        "libsassy_tpu_torch_c", [SOURCE, HEADER],
        ["-O2", "-fPIC", "-shared", *cflags], libs, build_dir=build_dir,
    )
    # the library's path is among the flags: a rebuilt library gets a
    # fresh example
    example = gxx.build(
        "example", [EXAMPLE, HEADER],
        ["-O2", "-x", "c", f"-I{HERE}"],
        ["-x", "none", str(lib), f"-Wl,-rpath,{lib.parent}"],
        suffix="", build_dir=build_dir,
    )
    return lib, example
