"""The program's own spans, for the per-layer readers that read them: the
timeline and the aggregates of ``clearvae_torch``'s tracer
(``clearvae_torch/utils/logging.py``).

The tracer appends a record to its timeline for each span that closes while
a ``torch.profiler`` records, and opened while it did: in a run, those of
the traced stretch. Each record is {"id", "name", "start_ns", "end_ns",
"parent"}, the parent the id of the recorded span that encloses it. The
aggregates ({name: {"calls", "total_ns", "longest_ns"}}) count every span
since the process started. Both are None where the program has no tracer.
"""

from __future__ import annotations


def snapshot() -> dict | None:
    try:
        from clearvae_torch.utils.logging import snapshot as program_snapshot
    except ImportError:
        return None
    return program_snapshot()


def timeline() -> list:
    """The recorded spans; [] where the program has no tracer."""
    snap = snapshot()
    return snap["timeline"] if snap else []


def aggregates() -> dict:
    snap = snapshot()
    return snap["spans"] if snap else {}


def ns(rec: dict) -> int:
    return rec["end_ns"] - rec["start_ns"]


def named(recs: list, name: str) -> list:
    return [r for r in recs if r["name"] == name]


def children(recs: list, parents: list, names) -> list:
    """The records named in ``names`` whose parent is one of ``parents``."""
    ids = {p["id"] for p in parents}
    return [r for r in recs if r["name"] in names and r["parent"] in ids]


def outside(recs: list, rec: dict, name: str) -> bool:
    """Whether no span named ``name`` encloses ``rec`` among the recorded
    ones."""
    by_id = {r["id"]: r for r in recs}
    parent = by_id.get(rec["parent"])
    while parent is not None:
        if parent["name"] == name:
            return False
        parent = by_id.get(parent["parent"])
    return True
