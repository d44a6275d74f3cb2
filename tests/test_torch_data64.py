"""The port's 64×64 data against the JAX package's: the four ``synth64``
generators bit for bit, each dataset's ``get_*`` / ``synthetic_*`` stand-in,
``kstyle_train_test_split`` and ``train_valid_split_array`` equal, and
every k-style split disjoint in (content, style)."""

import numpy as np
import pytest

from clearvae_tpu.data import camelyon17 as JCAM
from clearvae_tpu.data import celeba as JCEL
from clearvae_tpu.data import chexpert as JCHX
from clearvae_tpu.data import common as JCOM
from clearvae_tpu.data import pacs as JPACS
from clearvae_tpu.data import synth64 as JS64
from clearvae_torch.data import camelyon17 as TCAM
from clearvae_torch.data import celeba as TCEL
from clearvae_torch.data import chexpert as TCHX
from clearvae_torch.data import common as TCOM
from clearvae_torch.data import pacs as TPACS
from clearvae_torch.data import synth64 as TS64

N = 32
# dataset → (JAX getter, port getter, classes, styles, port k-split, JAX k-split)
SETS = {
    "celeba": (lambda n, s: JCEL.get_celeba(None, n_synthetic=n, seed=s),
               lambda n, s: TCEL.get_celeba(None, n_synthetic=n, seed=s),
               4, 4, TCEL.kceleba_train_test_split,
               JCEL.kceleba_train_test_split),
    "pacs": (lambda n, s: JPACS.get_pacs(None, n_synthetic=n, seed=s),
             lambda n, s: TPACS.get_pacs(None, n_synthetic=n, seed=s),
             7, 4, TPACS.kpacs_train_test_split, JPACS.kpacs_train_test_split),
    "camelyon17": (lambda n, s: JCAM.get_camelyon17(None, n_synthetic=n,
                                                    seed=s),
                   lambda n, s: TCAM.get_camelyon17(None, n_synthetic=n,
                                                    seed=s),
                   2, 5, TCAM.kcamelyon_train_test_split,
                   JCAM.kcamelyon_train_test_split),
    "chexpert": (JCHX.synthetic_chexpert, TCHX.synthetic_chexpert, 4, 6,
                 None, None),
}


def _equal(a, b):
    for f in ("images", "labels", "style_idx"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.fixture(scope="module")
def datasets():
    """Each set from both packages, built once (seed 3)."""
    return {name: (j(N, 3), t(N, 3)) for name, (j, t, *_) in SETS.items()}


@pytest.mark.parametrize("name", ["synthetic_celeba64", "synthetic_pacs64",
                                  "synthetic_camelyon64",
                                  "synthetic_chexpert64"])
def test_synth64_generators_are_bit_equal(name):
    j = getattr(JS64, name)(N, 11)
    t = getattr(TS64, name)(N, 11)
    assert len(j) == len(t) == 3
    for a, b in zip(j, t):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    images = t[0]
    assert images.shape[:3] == (N, 64, 64) and images.dtype == np.float32
    assert images.min() >= 0.0 and images.max() <= 1.0


@pytest.mark.parametrize("name", list(SETS))
def test_getters_equal_jax(datasets, name):
    j, t = datasets[name]
    assert type(t) is TCOM.ArrayDataset and len(t) == N
    _equal(j, t)
    assert t.images.shape[-1] == (1 if name == "chexpert" else 3)


@pytest.mark.parametrize("name", list(SETS))
@pytest.mark.parametrize("k", [1, 2])
def test_kstyle_and_valid_splits_equal_jax_and_are_disjoint(datasets, name, k):
    """The dataset's own k-split (``kstyle_train_test_split`` over its
    classes and styles for CheXpert, as its runner calls it), then the
    85/15 train/valid split: equal to JAX's, the style dicts too. Per
    class the train and test styles partition the styles, and no (content,
    style) pair of the test split is in the train split."""
    j, t = datasets[name]
    _, _, n_class, n_style, tsplit, jsplit = SETS[name]
    classes, styles = range(n_class), range(n_style)
    if tsplit is None:
        tr, te, sd = TCOM.kstyle_train_test_split(t, classes, styles, k, 5)
        jtr, jte, jsd = JCOM.kstyle_train_test_split(j, classes, styles, k, 5)
    else:
        tr, te, sd = tsplit(t, k, 5)
        jtr, jte, jsd = jsplit(j, k, 5)
    _equal(jtr, tr)
    _equal(jte, te)
    assert sd.keys() == jsd.keys()
    for c in sd:
        for part in ("train", "test"):
            np.testing.assert_array_equal(sd[c][part], jsd[c][part])
        assert len(sd[c]["train"]) == k
        assert sorted([*sd[c]["train"], *sd[c]["test"]]) == list(styles)
    pairs = {(int(c), int(s)) for c, s in zip(tr.labels, tr.style_idx)}
    assert not pairs & {(int(c), int(s)) for c, s in zip(te.labels,
                                                          te.style_idx)}
    for c, s in pairs:
        assert s in sd[c]["train"]
    train, valid = TCOM.train_valid_split_array(tr, 0.85, 5)
    jtrain, jvalid = JCOM.train_valid_split_array(jtr, 0.85, 5)
    _equal(jtrain, train)
    _equal(jvalid, valid)
    assert len(train) + len(valid) == len(tr)

