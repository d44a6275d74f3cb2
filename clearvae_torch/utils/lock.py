"""Single-GPU-process lock (counterpart of ``clearvae_tpu/utils/lock.py``).

Two processes that share one card do not fail: they time-slice it, and
every number either of them measures is slower than the card. Every entry
point that drives the card (the experiment runners' ``main``, ``bench.py``,
``kernel_ab.py`` and the trainers' ``fit``, through
``utils.cache.enable_compilation_cache``) takes an exclusive ``flock`` on
``clearvae_torch.lock`` in the temporary directory at start-up and holds it
for the life of the process; a second one fails fast with a message naming
the holder.

The lock is skipped when the process has no CUDA device (the CPU test
suite cannot contend for a card) or when ``CLEARVAE_TORCH_NO_LOCK=1`` is
set (the escape hatch, e.g. to queue deliberately behind a dying process).
"""

from __future__ import annotations

import errno
import fcntl
import json
import os
import sys
import tempfile
import time

import torch

LOCK_PATH = os.path.join(tempfile.gettempdir(), "clearvae_torch.lock")

_held_fd = None  # keeps the fd (and thus the flock) alive until exit


def _no_card() -> bool:
    """True where the process has no CUDA device and cannot contend for a
    card (the test suite replaces it to take the lock on the CPU)."""
    return not torch.cuda.is_available()


def acquire_gpu_lock(path: str = LOCK_PATH) -> bool:
    """Take the exclusive single-GPU-process lock; ``SystemExit`` if another
    process holds it.

    Returns True when acquired, False when skipped (no CUDA device, or
    ``CLEARVAE_TORCH_NO_LOCK=1``). Idempotent within a process. The lock is
    an ``flock``, so it dies with the process: a killed run leaves no stale
    lock behind.
    """
    global _held_fd
    if _held_fd is not None:
        return True
    if os.environ.get("CLEARVAE_TORCH_NO_LOCK") == "1" or _no_card():
        return False
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o666)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError as e:
        if e.errno not in (errno.EAGAIN, errno.EACCES):
            os.close(fd)
            raise
        try:
            holder = json.loads(os.read(fd, 4096).decode() or "{}")
        except ValueError:
            holder = {}
        os.close(fd)
        raise SystemExit(
            f"another GPU process holds {path} "
            f"(holder: {holder or 'unknown'}); two processes sharing the "
            f"card slow both runs down: wait for it or set "
            f"CLEARVAE_TORCH_NO_LOCK=1 to override")
    info = {"pid": os.getpid(),
            "label": os.path.basename(sys.argv[0]),
            "argv": " ".join(sys.argv[:4]),
            "since": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    os.ftruncate(fd, 0)
    os.write(fd, json.dumps(info).encode())
    os.fsync(fd)
    _held_fd = fd
    return True


def release_gpu_lock() -> None:
    """Drop the lock early (normally it dies with the process)."""
    global _held_fd
    if _held_fd is not None:
        fcntl.flock(_held_fd, fcntl.LOCK_UN)
        os.close(_held_fd)
        _held_fd = None
