"""A run with the timed path broken underneath comes out not correct: the
harness is driven on the CPU at a tiny size (past its look for a card),
once for each fault the cells can have: an optimizer step that leaves the
state unchanged; half of each batch left out of the loss's per-sample
means; an answer altered where it is produced (a validation's MSE, a
styled pixel). One card: no exchange between cards to leave out."""

import pytest
import torch

torch.set_num_threads(1)

from clearvae_torch.data import styled as PS  # noqa: E402
from clearvae_torch.ops import losses as PL  # noqa: E402
from clearvae_torch.train import trainers as PT  # noqa: E402
from portbench import run as R  # noqa: E402

TINY = {"vae28-downstream-fit": {"traffic": {"n_images": 400}},
        "vae64-celeba-fit": {"traffic": {"n_train": 160}},
        "vae28-styled6-ondevice": {"traffic": {"n_images": 300}}}


def _run(cell):
    over = {**TINY[cell], "config": {"fit": {"batch_size": 32}}}
    return R.run(cell, 77, 0.2, device="cpu", overrides=over)


def _no_update(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    whole = PL.sample_level_reduction
    monkeypatch.setattr(PL, "sample_level_reduction",
                        lambda t: whole(t[: max(1, t.shape[0] // 2)]))


def _mse_altered(monkeypatch):
    evaluate = PT.VAETrainerBase.evaluate

    def altered(self, *a, **k):
        mig, mse = evaluate(self, *a, **k)
        return mig, mse * 1.001

    monkeypatch.setattr(PT.VAETrainerBase, "evaluate", altered)


def _pixel_altered(monkeypatch):
    style = PS.StyledDataset.style

    def altered(self, raw, style_idx, draws):
        out = style(self, raw, style_idx, draws)
        return torch.cat([out[:1].clamp_min(0.5), out[1:]])

    monkeypatch.setattr(PS.StyledDataset, "style", altered)


FAULTS = [("vae28-downstream-fit", _no_update),
          ("vae64-celeba-fit", _no_update),
          ("vae28-styled6-ondevice", _no_update),
          ("vae28-downstream-fit", _half_batch),
          ("vae64-celeba-fit", _half_batch),
          ("vae28-styled6-ondevice", _half_batch),
          ("vae28-downstream-fit", _mse_altered),
          ("vae28-styled6-ondevice", _mse_altered),
          ("vae28-downstream-fit", _pixel_altered),
          ("vae28-styled6-ondevice", _pixel_altered)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    assert _run(cell)["correct"]
    fault(monkeypatch)
    res = _run(cell)
    assert not res["correct"], res["checks"]
