"""Build the port's CUDA kernels from the package's own sources.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface, compiled by
``nvcc`` into a shared library and loaded with :mod:`ctypes`.  Libraries go
to ``_build/`` inside the package (listed in ``.gitignore``), named by a
hash of the source and the flags, so a changed source is rebuilt and an
unchanged one is built once per checkout.  The build runs at first use;
a build that fails raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

__all__ = ["NVCC_FLAGS", "build", "build_log", "find_nvcc"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: Hopper only (``sm_90a``); no fast math, so sqrt and division stay IEEE.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> {"path", "seconds", "log"} of the builds made (or reused) here.
_BUILT: Dict[str, Dict] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the port's CUDA kernels are built from source at first use"
    )


def build(name: str) -> str:
    """Path of the shared library for ``csrc/<name>.cu``, compiling it if
    this checkout has not built this exact source yet."""
    done = _BUILT.get(name)
    if done is not None:
        return done["path"]
    src = CSRC / f"{name}.cu"
    text = src.read_bytes()
    digest = hashlib.sha1(text + repr(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True,
                text=True,
            )
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {src.name}:\n{log}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    _BUILT[name] = {
        "path": str(out),
        "seconds": time.perf_counter() - t0,
        "log": log,
    }
    return str(out)


def build_log(name: str) -> Dict:
    """``{"path", "seconds", "log"}`` of the build :func:`build` made for
    ``name`` in this process (``log`` is nvcc's output, ptxas's register
    and shared-memory report included; empty when the library was reused)."""
    return dict(_BUILT[name])
