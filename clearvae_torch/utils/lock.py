"""One-process-per-card lock (counterpart of ``clearvae_tpu/utils/lock.py``).

Two processes that share one card do not fail: they time-slice it, and
every number either of them measures is slower than the card. Every entry
point that drives the card (the experiment runners' ``main``,
``chip_smoke.py`` and the trainers' ``fit``, through
``utils.cache.enable_compilation_cache``) takes an exclusive ``flock`` on
the lock file of its card in the temporary directory,
``clearvae_torch-<card UUID>.lock``, and holds it for the life of the
process; a second process on that card fails fast with a message naming the
holder. The card's UUID does not depend on ``CUDA_VISIBLE_DEVICES``, so the
ranks of a job on several cards each take their own card's lock, while two
processes on one card still collide. (One JAX process drives every chip,
so the JAX lock is one file a machine.)

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

_held: dict = {}  # lock path -> fd: keeps each flock alive until exit


def _no_card() -> bool:
    """True where the process has no CUDA device and cannot contend for a
    card (the test suite replaces it to take the lock on the CPU)."""
    return not torch.cuda.is_available()


def _card_key(index: int) -> str:
    """The card's UUID (the test suite replaces it on the CPU)."""
    return str(torch.cuda.get_device_properties(index).uuid)


def lock_path(device=None) -> str:
    """The lock file of the card ``device`` names (default: the current
    card)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return os.path.join(tempfile.gettempdir(),
                        f"clearvae_torch-{_card_key(index)}.lock")


def acquire_gpu_lock(path: str | None = None, device=None) -> bool:
    """Take the exclusive lock of a card (the file ``path``, or by default
    that of ``device``'s card, ``lock_path``); ``SystemExit`` if another
    process holds it.

    Returns True when acquired, False when skipped (no CUDA device, a CPU
    ``device``, or ``CLEARVAE_TORCH_NO_LOCK=1``). Idempotent within a
    process. The lock is an ``flock``, so it dies with the process: a
    killed run leaves no stale lock behind.
    """
    if (os.environ.get("CLEARVAE_TORCH_NO_LOCK") == "1" or _no_card()
            or (device is not None and torch.device(device).type != "cuda")):
        return False
    path = lock_path(device) if path is None else path
    if path in _held:
        return True
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
    _held[path] = fd
    return True


def release_gpu_lock() -> None:
    """Drop every lock this process holds early (normally they die with
    the process)."""
    while _held:
        fd = _held.popitem()[1]
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
