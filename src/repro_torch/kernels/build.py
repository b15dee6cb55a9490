"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` (with the shared ``csrc/*.cuh`` headers) is
compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) and loaded with
``ctypes``.  Libraries go to ``build/`` at the repository root, named by a
hash of sources and flags, and are built at first use — nothing is
compiled when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    # the shared headers are part of every source
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def compile_libraries(names: Iterable[str]) -> Dict[str, Tuple[Path, str]]:
    """Compile every named source not yet built, one ``nvcc`` per source,
    all started together.  Returns {name: (library path, compiler log)}
    — the log holds ptxas' register / shared-memory / spill report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    out: Dict[str, Tuple[Path, str]] = {}
    for name in names:
        so = _target(name)
        log = so.with_suffix(".log")
        if so.exists():
            out[name] = (so, log.read_text() if log.exists() else "")
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (so, tmp, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{text}")
        so.with_suffix(".log").write_text(text)
        os.replace(tmp, so)
        out[name] = (so, text)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    if name not in _loaded:
        (path, _), = compile_libraries([name]).values()
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
