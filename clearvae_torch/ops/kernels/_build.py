"""Build and load the port's CUDA sources (``clearvae_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, at first use, and loaded with ``ctypes``.
The library's file name carries a hash of its source, so an edited source is
rebuilt and a built one is reused. The build directory,
``clearvae_torch/_build/``, is listed in ``.gitignore``.

Nothing here runs at import time: a CPU-only machine can import the package.

A build is a span ``kernels.build`` and a load of a built library one
``kernels.load`` (``utils/logging.py``); both are counted by source in
``BUILDS`` and ``LOADS``, which ``native/bindings.py`` shares.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from clearvae_torch.utils.logging import counter, span

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}   # ptxas output (registers, spills) per source
BUILDS = counter("kernels.builds")
LOADS = counter("kernels.loads")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str):
    """Start nvcc for one source; returns (proc, tmp, out) or None if built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    build_log[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build(names) -> None:
    """Compile the named sources, all nvcc processes started together."""
    with span("kernels.build"):
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                BUILDS[n] += 1
                _finish(n, job)


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _loaded:
            build([name])
            with span("kernels.load"):
                _loaded[name] = ctypes.CDLL(_lib_path(name))
            LOADS[name] += 1
        return _loaded[name]
