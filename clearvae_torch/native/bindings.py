"""ctypes bindings of the port's host library, ``csrc/host_ops.cpp``
(counterpart of ``clearvae_tpu/native/bindings.py``): the KSG mutual
information of MIG, and ``corrupt_batch``, K3's seven deterministic styles
on the host.

The library is compiled with ``g++ -O3 -std=c++17 -shared -fPIC`` at first
use into ``clearvae_torch/_build/`` (listed in ``.gitignore``), under a file
name that carries a hash of the source, so an edited source is rebuilt and a
built one reused. It is a host op, not a device kernel: where the build
fails, :func:`available` is False and the MIG backend ``"auto"`` takes numpy,
as in the JAX package. Nothing is built at import time. The build and the
load are spans and counts as the CUDA sources' are (``ops/kernels/_build.py``:
``kernels.build``, ``kernels.load``), under ``host_ops``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

from clearvae_torch.ops.kernels._build import BUILDS, LOADS
from clearvae_torch.utils.logging import span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "host_ops.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
# style codes understood by corrupt_batch (host_ops.cpp); K3's codes
NATIVE_STYLES = {"identity": 0, "stripe": 1, "brightness": 2, "inverse": 3,
                 "quantize": 4, "contrast": 5, "scale": 6}

_lib = None
_tried = False


def lib_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libhost_ops-{digest}.so")


def _build() -> str | None:
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    BUILDS["host_ops"] += 1
    try:
        with span("kernels.build"):
            subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp], check=True,
                           capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"# native host_ops build unavailable: {e}", file=sys.stderr)
        return None
    os.replace(tmp, out)
    return out


def _load():
    global _lib, _tried
    if _lib is None and not _tried:
        _tried = True
        path = _build()
        if path:
            with span("kernels.load"):
                lib = ctypes.CDLL(path)
            LOADS["host_ops"] += 1
            lib.ksg_mi_cd.restype = ctypes.c_int
            lib.ksg_mi_cd.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double)]
            lib.corrupt_batch.restype = ctypes.c_int
            lib.corrupt_batch.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32]
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the host library is built (building it on the first call)."""
    return _load() is not None


def ksg_mi_cd_native(x: np.ndarray, y: np.ndarray,
                     n_neighbors: int = 3) -> np.ndarray:
    """Per-feature KSG MI of preprocessed float64 columns ``x`` [n, f]
    against labels ``y`` [n]; raises if the library is not built."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native host_ops library is not built")
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.int64).ravel()
    if x.ndim != 2 or y.shape != (x.shape[0],):
        raise ValueError(f"ksg_mi_cd takes x [n, f] and y [n]; got "
                         f"{x.shape} and {y.shape}")
    n, f = x.shape
    out = np.empty(f, np.float64)
    rc = lib.ksg_mi_cd(x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                       y.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                       n, f, n_neighbors,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise RuntimeError(f"ksg_mi_cd failed: rc={rc}")
    return out


def corrupt_batch_native(images: np.ndarray, style_names: list[str],
                         style_idx: np.ndarray,
                         severity: int = 5) -> np.ndarray:
    """K3's deterministic styles of a [B, H, W] float32 0..255 batch on the
    host, into a copy: image i takes ``style_names[style_idx[i]]``, each a
    name of ``NATIVE_STYLES`` (else KeyError), all at one severity. Raises
    if the library is not built."""
    codes = np.asarray([NATIVE_STYLES[style_names[i]] for i in style_idx],
                       np.int32)
    lib = _load()
    if lib is None:
        raise RuntimeError("the native host_ops library is not built")
    out = np.ascontiguousarray(images, np.float32).copy()
    b, h, w = out.shape
    rc = lib.corrupt_batch(out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                           b, h, w, severity)
    if rc != 0:
        raise RuntimeError(f"corrupt_batch failed: rc={rc}")
    return out
