"""The port's qualitative-artifact path against the JAX package's, on the
CPU: the host ``batches`` iterators, ``encode_dataset`` on bridged weights,
Colored-MNIST (``rgb_change``, ``make_colored_mnist``), illustrate's three
grids, demo's ``build_trainer`` for every model × dataset and a tiny
``main``, the MI simulation's threefry normals, blobs, losses and sweep,
and every function of ``analyze`` on the same result JSONs."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from clearvae_tpu.data import colored_mnist as JCM
from clearvae_tpu.data.common import ArrayDataset as JArrayDataset
from clearvae_tpu.data.styled import make_styled_mnist as jax_make_styled
from clearvae_tpu.experiments import analyze as JA
from clearvae_tpu.experiments import demo as JD
from clearvae_tpu.experiments import illustrate as JI
from clearvae_tpu.experiments import mi_simulation as JMI
from clearvae_tpu.models.vae import VAE as JVAE
from clearvae_tpu.ops import corruptions as JC
from clearvae_tpu.train.trainers import CLEARVAETrainer as JTrainer
from clearvae_torch.bridge import params_from_flax
from clearvae_torch.data import colored_mnist as TCM
from clearvae_torch.data.common import ArrayDataset
from clearvae_torch.data.mnist import synthetic_mnist
from clearvae_torch.data.styled import make_styled_mnist
from clearvae_torch.experiments import analyze as TA
from clearvae_torch.experiments import demo as TD
from clearvae_torch.experiments import illustrate as TI
from clearvae_torch.experiments import mi_simulation as TMI
from clearvae_torch.ops import corruptions as TC
from clearvae_torch.ops import prng as P
from clearvae_torch.train import factories as TF

# tests/test_torch_data.py's bars on the [0, 1] scale: 1e-5 outside
# zigzag, 2e-5 for zigzag (its anti-aliased line's float rounding)
PIX_ATOL, ZIG_ATOL = 1e-5, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch and one for the BLAS and OpenMP pools
    (sklearn's t-SNE): the parallel test run puts several workers on a
    machine, where more threads only contend (a 40-point t-SNE took
    minutes there with OpenMP's default, under a second with one)."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def digits():
    return synthetic_mnist(100, seed=6)


# ---------------------------------------------------------------------------
# the host batches iterators
# ---------------------------------------------------------------------------

BATCH_CASES = [dict(shuffle=False), dict(shuffle=True, seed=3),
               dict(shuffle=True, seed=1, drop_last=False),
               dict(shuffle=False, drop_last=True, include_style=False)]


@pytest.mark.parametrize("kw", BATCH_CASES)
def test_array_batches_equal_jax(kw):
    rs = np.random.RandomState(0)
    arrays = (rs.rand(45, 4, 4, 3).astype(np.float32), rs.randint(0, 5, 45),
              rs.randint(0, 3, 45))
    ours = list(ArrayDataset(*arrays).batches(16, **kw))
    theirs = list(JArrayDataset(*arrays).batches(16, **kw))
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("kw", BATCH_CASES)
def test_styled_batches_equal_jax(digits, kw):
    imgs, labels = digits
    td = make_styled_mnist(imgs, labels, seed=2)
    jd = jax_make_styled(imgs, labels, seed=2)
    ours = list(td.batches(32, device="cpu", **kw))
    theirs = list(jd.batches(32, **kw))
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert len(a) == len(b) == (3 if kw.get("include_style", True) else 2)
        x, jx = a[0], np.asarray(b[0])
        assert x.shape == jx.shape and x.shape[-1] == 1 and x.dtype == np.float32
        np.testing.assert_array_equal(a[1], b[1])
        if len(a) > 2:
            np.testing.assert_array_equal(a[2], b[2])
        zig = np.asarray(b[2] if len(b) > 2 else np.zeros(len(x))) == 2
        np.testing.assert_allclose(x[~zig], jx[~zig], rtol=0, atol=PIX_ATOL)
        np.testing.assert_allclose(x[zig], jx[zig], rtol=0, atol=ZIG_ATOL)
    # styled once and cached: a second call restyles nothing
    cached = td.materialize("cpu")
    next(td.batches(32, shuffle=False, device="cpu"))
    assert td.materialize("cpu") is cached


def test_styled_batches_default_to_cuda(digits):
    ds = make_styled_mnist(*digits, seed=2)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(ds.batches(32, shuffle=False))


# ---------------------------------------------------------------------------
# encode_dataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bridged_pair():
    jt = JTrainer(JVAE(total_z_dim=16), optax.adam(5e-4), sim_fn="cosine",
                  hyperparameter=dict(beta=1 / 8, ps=True, alpha=100.0,
                                      temperature=0.1), seed=0,
                  mig_backend="numpy")
    jt.state = jt._init_state()
    tt = TF.get_clearvae_trainer(beta=1 / 8, ps=True, vae_lr=5e-4, z_dim=16,
                                 alpha=100.0, temperature=0.1, seed=0,
                                 mig_backend="numpy", device="cpu")
    tt.model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jt.state.params),
        jax.tree.map(np.asarray, jt.state.batch_stats)))
    rs = np.random.RandomState(1)
    n = 40     # two batches of 16 and a ragged tail of 8
    arrays = (rs.rand(n, 28, 28, 1).astype(np.float32), rs.randint(0, 10, n),
              rs.randint(0, 6, n))
    return jt, tt, arrays


@pytest.mark.parametrize("what", ["mu_c", "logvar_c", "mu_s", "logvar_s"])
def test_encode_dataset_matches_jax(bridged_pair, what):
    jt, tt, arrays = bridged_pair
    feats, labels, styles = tt.encode_dataset(ArrayDataset(*arrays), 16, what)
    jfeats, jlabels, jstyles = jt.encode_dataset(JArrayDataset(*arrays), 16,
                                                 what)
    assert feats.shape == (40, 8) and feats.dtype == np.float32
    np.testing.assert_allclose(feats, jfeats, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(styles, jstyles)


def test_encode_dataset_styles_on_the_trainer_device(bridged_pair, digits):
    _, tt, _ = bridged_pair
    ds = make_styled_mnist(*digits, seed=5)
    feats, labels, styles = tt.encode_dataset(ds, 32, "mu_s")
    x = ds.materialize("cpu")[..., None]
    ref = tt.model.encode(x, train=False)[2].detach().numpy()
    np.testing.assert_allclose(feats, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(labels, ds.labels)
    np.testing.assert_array_equal(styles, ds.style_idx)


# ---------------------------------------------------------------------------
# Colored-MNIST
# ---------------------------------------------------------------------------

def test_colored_mnist_bit_equal(digits):
    imgs, labels = digits
    assert TCM.COLOR_NAMES == JCM.COLOR_NAMES
    assert TC.COLOR_DICT == JC.COLOR_DICT
    probs = np.arange(1, 8, dtype=np.float64)
    for kw in (dict(seed=0), dict(seed=4, color_probs=probs)):
        ours, theirs = (TCM.make_colored_mnist(imgs, labels, **kw),
                        JCM.make_colored_mnist(imgs, labels, **kw))
        for field in ("images", "labels", "style_idx"):
            a, b = getattr(ours, field), getattr(theirs, field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("color", list(JC.COLOR_DICT))
def test_rgb_change_equals_jax(digits, color):
    imgs, _ = digits
    ref = np.stack([np.asarray(JC.rgb_change(jnp.asarray(im), color))
                    for im in imgs[:3]])
    np.testing.assert_array_equal(TC.rgb_change(imgs[:3], color).numpy(), ref)
    np.testing.assert_array_equal(TC.rgb_change(imgs[0], color).numpy(), ref[0])


# ---------------------------------------------------------------------------
# illustrate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["example_data_grid", "content_grid",
                                  "styles_grid"])
def test_illustrate_grids_match_jax(digits, name):
    imgs, labels = digits
    imgs = np.asarray(imgs, np.float32)
    got = getattr(TI, name)(imgs, labels, 3, device="cpu")
    ref = getattr(JI, name)(imgs, labels, 3)
    assert got.shape == ref.shape
    # the grids hold zigzag pixels among the others: the zigzag bar
    np.testing.assert_allclose(got, ref, rtol=0, atol=ZIG_ATOL)


def test_illustrate_main_writes_three_grids(tmp_path):
    grids = TI.main(["--device", "cpu", "--n_synthetic", "80", "--seed", "1",
                     "--out", str(tmp_path)])
    assert sorted(grids) == ["example-data", "illustrate_content",
                             "illustrate_styles"]
    for name in grids:
        assert os.path.getsize(tmp_path / f"{name}.png") > 0


# ---------------------------------------------------------------------------
# demo
# ---------------------------------------------------------------------------

FACTORIES = ("get_clearvae_trainer", "get_cleartcvae_trainer",
             "get_clearmimvae_trainer", "get_hierarchical_vae_trainer")


@pytest.mark.parametrize("dataset", ["styled", "colored", "celeba"])
@pytest.mark.parametrize("model", ["clearvae", "bvae", "clearmimvae",
                                   "cleartcvae", "gvae", "mlvae"])
def test_build_trainer_matches_jax(model, dataset, monkeypatch):
    seen = {}
    for mod, tag in ((JD, "jax"), (TD, "torch")):
        for f in FACTORIES:
            monkeypatch.setattr(mod, f, lambda _f=f, _t=tag, **kw:
                                seen.setdefault(_t, (_f, kw)))
    argv = ["--model", model, "--dataset", dataset, "--z_dim", "12",
            "--alpha", "10", "--temperature", "0.3", "--beta", "0.25",
            "--seed", "7"]
    JD.build_trainer(JD.get_args(argv))
    targs = TD.get_args(argv + ["--device", "cpu"])
    targs.device = torch.device("cpu")
    TD.build_trainer(targs)
    (jf, jkw), (tf, tkw) = seen["jax"], seen["torch"]
    assert tf == jf
    assert tkw.pop("device") == torch.device("cpu")
    assert tkw == jkw


@pytest.mark.parametrize("dataset", ["styled", "colored"])
def test_demo_main_writes_every_artifact(tmp_path, dataset):
    out = tmp_path / dataset
    r = TD.main(["--device", "cpu", "--dataset", dataset, "--n_total", "256",
                 "--epochs", "1", "--batch_size", "32", "--out", str(out)])
    assert np.isfinite(r["mig"]) and np.isfinite(r["mse"])
    assert r["swap"].shape == (8 * 30 + 2 + 32, 8 * 30 + 2 + 32, 3)
    assert np.isfinite(r["swap"]).all() and r["tsne"] is not None
    for name in ("swapping", "interp-style", "interp-content",
                 "tsne-muc-by-class", "tsne-muc-by-style",
                 "tsne-mus-by-style", "tsne-mus-by-class"):
        assert os.path.getsize(out / f"clearvae-{name}.png") > 0


# ---------------------------------------------------------------------------
# mi_simulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 - 1])
def test_normal_matches_jax(seed):
    k = jax.random.key(seed)
    for shape in [(300, 3), (7,), (2, 3, 4)]:
        got = P.normal(P.key(seed), shape).numpy()
        ref = np.asarray(jax.random.normal(k, shape))
        assert got.shape == ref.shape and got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        k2 = jax.random.split(k)[1]
        np.testing.assert_allclose(P.normal(P.split(P.key(seed))[1],
                                            shape).numpy(),
                                   np.asarray(jax.random.normal(k2, shape)),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("std", [1.0, 2.5, 4.0])
def test_blobs_and_snn_value_match_jax(std):
    x, y = TMI.generate_gaussian_blobs(P.key(3), 150, cluster_std=std)
    jx, jy = JMI.generate_gaussian_blobs(jax.random.key(3), 150,
                                         cluster_std=std)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    for tau in TMI.TAUS:
        for ps in (True, False):
            np.testing.assert_allclose(
                TMI.snn_value(torch.as_tensor(np.array(jx)), y, tau, ps),
                JMI.snn_value(jx, jy, tau, ps), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ps", [True, False])
def test_mi_simulation_run_matches_jax(ps):
    stds = np.linspace(1, 4, 3)
    got = TMI.run(stds, n_samples=90, reps=2, seed=4, ps=ps, device="cpu")
    ref = JMI.run(stds, n_samples=90, reps=2, seed=4, ps=ps)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_mi_simulation_main_writes_both_plots(tmp_path):
    ps, snn = TMI.main(["--device", "cpu", "--reps", "1", "--n_stds", "3",
                        "--n_samples", "90", "--out", str(tmp_path)])
    assert len(ps["knn_mi"]) == len(snn["tau_0.1"]) == 3
    assert all(np.isfinite(v).all() for v in (*ps.values(), *snn.values()))
    assert os.path.getsize(tmp_path / "mi-min.png") > 0
    assert os.path.getsize(tmp_path / "mi-max.png") > 0


# ---------------------------------------------------------------------------
# analyze
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Result JSONs of three models × k = 1, 2 × six seeds (Wilcoxon needs
    five signed pairs), and one stray file that does not match."""
    d = tmp_path_factory.mktemp("results")
    rs = np.random.RandomState(0)
    for k in (1, 2):
        for seed in range(6):
            res = {m: {"acc": float(rs.rand()),
                       "pr": {"overall": float(rs.rand()), "stratified": []},
                       "roc": {"overall": float(rs.rand()), "stratified": []}}
                   for m in ("baseline", "clear", "gvae")}
            (d / f"styledmnist-k{k}-{seed}.json").write_text(json.dumps(res))
    (d / "styledmnist-kx-0.json").write_text("{}")
    return str(d)


def test_analyze_functions_equal_jax(results):
    df, jdf = TA.load_results(results, "styledmnist"), JA.load_results(
        results, "styledmnist")
    pd.testing.assert_frame_equal(df, jdf)
    assert len(df) == 36
    pd.testing.assert_frame_equal(TA.relative_to_baseline(df),
                                  JA.relative_to_baseline(jdf))
    for metric in ("acc", "map", "mauc"):
        assert TA.markdown_table(df, metric) == JA.markdown_table(jdf, metric)
        pd.testing.assert_frame_equal(TA.paired_deltas(df, metric),
                                      JA.paired_deltas(jdf, metric))
        assert TA.paired_markdown(df, metric) == JA.paired_markdown(jdf, metric)
    one_seed = df[df.seed == 0]
    assert TA.markdown_table(one_seed) == JA.markdown_table(one_seed)
    assert TA.paired_markdown(one_seed) == JA.paired_markdown(one_seed)
    assert TA.paired_markdown(df[df.model != "baseline"]) == \
        JA.paired_markdown(df[df.model != "baseline"])
    for deltas in ([0.1, -0.2, 0.3, 0.4, 0.5, 0.6], [0.1, 0.0, 0.2],
                   [0.0] * 6):
        np.testing.assert_equal(TA._wilcoxon_greater(deltas),
                                JA._wilcoxon_greater(deltas))


def test_analyze_boxplots_and_main_equal_jax(results, tmp_path, capsys):
    rel = TA.relative_to_baseline(TA.load_results(results, "styledmnist"))
    TA.boxplots(rel, "rel_acc", str(tmp_path / "ours.png"))
    JA.boxplots(rel, "rel_acc", str(tmp_path / "theirs.png"))
    assert os.path.getsize(tmp_path / "ours.png") > 0
    capsys.readouterr()
    for extra in ([], ["--markdown", "--paired"]):
        out = {}
        for mod, tag in ((TA, "ours"), (JA, "theirs")):
            argv = ["--result_dir", results, *extra, "--out",
                    str(tmp_path / tag)]
            df, rel = mod.main(argv)
            out[tag] = (df, rel, capsys.readouterr().out)
        pd.testing.assert_frame_equal(out["ours"][0], out["theirs"][0])
        pd.testing.assert_frame_equal(out["ours"][1], out["theirs"][1])
        assert out["ours"][2] == out["theirs"][2]
        assert sorted(os.listdir(tmp_path / "ours")) == sorted(
            os.listdir(tmp_path / "theirs")) == [
            f"styledmnist-{m}.png" for m in ("rel_acc", "rel_map", "rel_mauc")]
