"""The port's four 64×64 archive loaders against the JAX package's, on the
tiny archive layouts of ``tests/test_real_loaders.py`` written into a temp
directory (CelebA attr file + JPEGs, CheXpert DataFrame + X-rays,
Camelyon17 WILDS layout, PACS HF ``save_to_disk``): images, labels and
styles equal exactly."""

import os
import zlib

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from clearvae_tpu.data import camelyon17 as JCAM
from clearvae_tpu.data import celeba as JCEL
from clearvae_tpu.data import chexpert as JCHX
from clearvae_tpu.data import pacs as JPACS
from clearvae_torch.data import camelyon17 as TCAM
from clearvae_torch.data import celeba as TCEL
from clearvae_torch.data import chexpert as TCHX
from clearvae_torch.data import pacs as TPACS


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(path, size=(32, 40), mode="RGB"):
    rs = np.random.RandomState(zlib.crc32(path.encode()))
    arr = (rs.rand(size[1], size[0], 3) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).convert(mode).save(path)


def _same(ours, theirs, n):
    assert len(ours) == len(theirs) == n
    for field in ("images", "labels", "style_idx"):
        a, b = np.asarray(getattr(ours, field)), np.asarray(getattr(theirs, field))
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def _celeba(root, n=6):
    names = [f"{i:06d}.jpg" for i in range(1, n + 1)]
    attrs = []
    for i, name in enumerate(names):
        _img(str(root / "img_align_celeba" / name), size=(40 + i, 48))
        a = ["-1"] * 40
        a[20] = "1" if i % 2 else "-1"       # male
        a[31] = "1" if i % 3 else "-1"       # smiling
        a[9 if i % 2 else 8] = "1"           # blond or black hair
        if i == 2:
            a[10] = "1"                      # blurry → filtered out
        if i == 3:
            a[8] = a[9] = "-1"               # no hair color → filtered out
        attrs.append(name + " " + " ".join(a))
    (root / "list_attr_celeba.txt").write_text(
        f"{len(names)}\nheader\n" + "\n".join(attrs) + "\n")


def test_load_celeba_matches_jax(tmp_path):
    root = tmp_path / "celeba"
    _celeba(root)
    _same(TCEL.load_celeba(str(root)), JCEL.load_celeba(str(root)), 4)
    _same(TCEL.load_celeba(str(root), image_size=32, max_images=3),
          JCEL.load_celeba(str(root), image_size=32, max_images=3), 3)


def test_load_chexpert_matches_jax(tmp_path):
    root = str(tmp_path) + "/"
    rows = []
    for i in range(5):
        rel = f"CheXpert-v1.0/train/p{i}/study/img.jpg"
        _img(root + rel.split("/", 1)[1], size=(30 + 7 * i, 50), mode="L")
        rows.append({"Path": rel, "Sex": i % 2, "Age": i % 3,
                     "Pneumonia": i % 4})
    df = pd.DataFrame(rows)
    _same(TCHX.load_chexpert(root, df, "Pneumonia"),
          JCHX.load_chexpert(root, df, "Pneumonia"), 5)


def test_load_camelyon17_matches_jax(tmp_path):
    base = tmp_path / "camelyon17_v1.0"
    rows = []
    for i in range(4):
        rows.append({"patient": f"{i:03d}", "node": 0, "x_coord": 10 * i,
                     "y_coord": 20 * i, "tumor": i % 2, "center": i % 5,
                     "slide": 0, "split": 0})
        _img(str(base / "patches" / f"patient_{i:03d}_node_0" /
                 f"patch_patient_{i:03d}_node_0_x_{10*i}_y_{20*i}.png"),
             size=(96, 96))
    pd.DataFrame(rows).to_csv(base / "metadata.csv")
    _same(TCAM.load_camelyon17(str(tmp_path)),
          JCAM.load_camelyon17(str(tmp_path)), 4)


def test_load_pacs_matches_jax(tmp_path):
    datasets = pytest.importorskip("datasets")
    imgs = [Image.fromarray((np.random.RandomState(i).rand(70, 60 + i, 3)
                             * 255).astype(np.uint8)) for i in range(4)]
    dd = datasets.Dataset.from_dict({
        "image": imgs, "label": [0, 1, 2, 3],
        "domain": ["art_painting", "cartoon", "photo", "sketch"],
    })
    dd.save_to_disk(str(tmp_path / "pacs"))
    _same(TPACS.load_pacs(str(tmp_path / "pacs")),
          JPACS.load_pacs(str(tmp_path / "pacs")), 4)
