"""The control of each cell's check comes out not correct, on the card at
the cell's own size: the reference computed in TF32, the precision below
the configuration's float32 with TF32 off, put in the program's place,
fails the cell's limits on each of three seeds, as the harness's own
``verdict`` judges them. So does the planted fault of half of each batch
left out, and a program whose graph replays train on a stale batch (the
captured step's index and noise staged only for the warm-up calls and the
capture). Skips without a card; run on one with
``python -m pytest portbench/tests -m card``."""

import os

import pytest
import torch

torch.set_num_threads(1)

from clearvae_torch.train import steps as PS  # noqa: E402
from portbench import check as C  # noqa: E402
from portbench import harness as H  # noqa: E402
from portbench import readings as RD  # noqa: E402

CELLS = sorted(f[:-5] for f in os.listdir(os.path.join(H.PKG, "workloads"))
               if f.endswith(".json"))
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


def _correct(numbers: dict, limits: dict) -> bool:
    return C.verdict(numbers, limits)[0]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_fault_fail_the_check(cell, card):
    limits = H.load_cell(cell).workload["limits"]
    for seed in SEEDS:
        r = RD.readings(cell, seed, card)
        assert _correct(r["program"], limits), r["program"]
        assert not _correct(r["control"], limits), r["control"]
        assert not _correct(r["half"], limits), r["half"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_stale_replay_is_not_correct(cell, card, monkeypatch):
    stage = PS._GraphedStep._stage

    def stale(self, row):
        self.staged = getattr(self, "staged", 0) + 1
        if self.staged <= self.WARMUP + 1:
            stage(self, row)

    monkeypatch.setattr(PS._GraphedStep, "_stage", stale)
    limits = H.load_cell(cell).workload["limits"]
    r = RD.readings(cell, SEEDS[0] + 1, card)
    assert not _correct(r["program"], limits), r["program"]
