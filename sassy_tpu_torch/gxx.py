"""Host-side native builds of the port with g++: the refcost oracle and
the C ABI. Each output goes to ``build/sassy_tpu_torch/`` beside the
package, named by a hash of its sources and flags, and is written under a
temporary name and renamed into place, so concurrent builders race
harmlessly and nothing is ever written next to a source (``native/`` and
``c/`` belong to the JAX package)."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

#: the same directory as the CUDA kernels' library (ops/myers_cuda.py)
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "sassy_tpu_torch"


def build(stem: str, sources, flags, libs=(), suffix: str = ".so",
          build_dir: Path | None = None) -> Path:
    """Compile ``sources`` (C or C++ files, plus headers that only feed
    the hash) with ``flags``, linked against ``libs`` (after the sources),
    into ``<build_dir>/<stem>_<hash><suffix>`` unless it exists. Raises
    ``RuntimeError`` when the compiler is missing or fails, with its
    stderr."""
    sources = [Path(s) for s in sources]
    key = hashlib.sha256(
        b"".join(s.read_bytes() for s in sources)
        + " ".join([*flags, *libs]).encode()
    ).hexdigest()[:16]
    out = Path(build_dir or BUILD_DIR) / f"{stem}_{key}{suffix}"
    if out.exists():
        return out
    cc = shutil.which("g++")
    if cc is None:
        raise RuntimeError("g++ not found")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    compiled = [str(s) for s in sources if s.suffix in (".c", ".cc", ".cpp")]
    proc = subprocess.run([cc, *flags, "-o", str(tmp), *compiled, *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed with code {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out
