"""The traffic makers give the same data for one seed and other data for
another, with the shapes and ranges their files describe."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from portbench import harness as H  # noqa: E402

TINY = {"vae28-downstream-fit": {"n_images": 300},
        "vae64-celeba-fit": {"n_train": 64},
        "vae28-mnistc16-ondevice": {"n_images": 300}}


def _make(cell, seed):
    c = H.load_cell(cell, {"traffic": TINY[cell]})
    return H.maker(c).make(c.traffic, seed, "cpu")


def _same(a, b) -> bool:
    return (torch.equal(a["images"], b["images"])
            and torch.equal(a["labels"], b["labels"])
            and all(np.array_equal(a[k], b[k]) for k in ("style_idx",)
                    if k in a))


@pytest.mark.parametrize("cell", sorted(TINY))
def test_one_seed_one_traffic(cell):
    big = 2 ** 31 + 977
    a, b, c = _make(cell, big), _make(cell, big), _make(cell, big + 1)
    assert _same(a, b)
    assert not torch.equal(a["images"], c["images"])
    x = a["images"]
    top = 255.0 if x.ndim == 3 else 1.0
    assert float(x.min()) >= 0 and float(x.max()) <= top
    ink = float((x > 0).float().mean())
    assert 0.1 < ink <= 1.0


def test_styled_splits_cover_the_digits_once():
    d = _make("vae28-downstream-fit", 11)
    rows = np.concatenate([d["rows"]["train"], d["rows"]["valid"]])
    assert sorted(rows.tolist()) == list(range(300))
    assert len(d["rows"]["train"]) == int(0.85 * 300)
    # k = 5 train styles a class: each class shows at most 5 of the 6
    y = d["labels"].numpy()
    for c in range(10):
        assert len(set(d["style_idx"][y == c].tolist())) <= 5
