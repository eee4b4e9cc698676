"""Build the package's CUDA sources with ``nvcc`` into shared libraries
with a plain C interface, and load them with ``ctypes``.

Each ``csrc/*.cu`` file becomes ``_build/lib<name>-<hash>.so``, where the
hash covers the source, the shared ``csrc/*.cuh`` headers and the flags,
so a changed source or header rebuilds and an unchanged one is reused.
Nothing is built when a module is imported: ``CudaLibrary.fn`` builds at
first use, and ``build_all`` builds several sources at once (one ``nvcc``
per source, started together).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional, Sequence

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)
NVCC_TIMEOUT_S = 600


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``/usr/local/cuda/bin`` or ``PATH``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the CUDA kernels are built from source at first use"
    )


def library_path(source: str) -> str:
    """Where the library built from ``csrc/<source>`` lives."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in (source, *headers):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build_all(sources: Sequence[str],
              logs: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Build every source not yet built, all ``nvcc`` runs at once; returns
    {source: library path}. Raises with the compiler's output on failure;
    on success, puts each built source's compiler output (with ``ptxas``'s
    registers, shared memory and spills per kernel) in ``logs``."""
    paths = {s: library_path(s) for s in sources}
    todo = [s for s in sources if not os.path.exists(paths[s])]
    if not todo:
        return paths
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for s in todo:
        tmp = f"{paths[s]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )))
    errors = []
    for s, tmp, proc in procs:
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            errors.append(f"{s}: nvcc timed out\n{log.decode()}")
            continue
        if proc.returncode != 0:
            errors.append(f"{s}: nvcc exit {proc.returncode}\n{log.decode()}")
            continue
        os.replace(tmp, paths[s])
        if logs is not None:
            logs[s] = log.decode()
    if errors:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(errors))
    return paths


class CudaLibrary:
    """One ``csrc`` source, built and loaded at first use, with the
    ``ctypes`` signature of its C entry point. ``launches`` is the plain
    integer count of kernel launches that the wrapper adds to."""

    def __init__(self, source: str, entry: str, argtypes):
        self.source = source
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    @property
    def fn(self):
        if self._fn is None:
            path = build_all([self.source])[self.source]
            fn = getattr(ctypes.CDLL(path), self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn
