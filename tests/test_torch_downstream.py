"""The slice as a whole: styling on the device inside the port's training and
evaluation loops (equal to the materialized path, and overlaying the JAX
trainer's own ``style_on_device`` path), and the port's Styled-MNIST
downstream runner writing the JAX package's result schema."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clearvae_tpu.data import styled as JD
from clearvae_tpu.models.vae import VAE as JVAE
from clearvae_tpu.train.trainers import CLEARVAETrainer as JTrainer
from clearvae_torch.bridge import params_from_flax
from clearvae_torch.data import styled as TD
from clearvae_torch.data.mnist import synthetic_mnist
from clearvae_torch.experiments import styledmnist_downstream as RUN
from clearvae_torch.ops.kernels import style as K3
from clearvae_torch.train.factories import get_clearvae_trainer

HP = dict(beta=1 / 8, ps=True, alpha=100.0, temperature=0.1)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _splits(mod, n_train, n_eval, seed):
    """A styled dataset cut into train/held-out halves that keep their
    absolute sample ids (the styling keys)."""
    imgs, labels = synthetic_mnist(n_train + n_eval, seed=seed)
    ds = mod.make_styled_mnist(imgs, labels, seed=seed)

    def sub(sel):
        return mod.StyledDataset(ds.images[sel], ds.labels[sel],
                                 ds.style_idx[sel], ds.styles, ds.seed,
                                 ds.sample_ids[sel])

    return sub(slice(0, n_train)), sub(slice(n_train, None))


def _port_trainer(**kw):
    return get_clearvae_trainer(vae_lr=5e-4, z_dim=16, seed=0,
                                mig_backend="numpy", device="cpu",
                                verbose_period=1, **HP, **kw)


def test_fit_style_on_device_equals_materialized():
    train, valid = _splits(TD, 96, 40, seed=3)
    runs = {}
    for on_device in (False, True):
        t = _port_trainer()
        t.fit(2, train, valid, batch_size=32, style_on_device=on_device)
        runs[on_device] = (t, t.evaluate(valid, batch_size=32,
                                         style_on_device=on_device))
    (tm, (mig_m, mse_m)), (ts, (mig_s, mse_s)) = runs[False], runs[True]
    for e in range(2):
        for k, v in tm.history[e].items():
            np.testing.assert_allclose(ts.history[e][k], v, rtol=1e-6,
                                       err_msg=f"epoch {e} {k}")
    np.testing.assert_allclose(mse_s, mse_m, rtol=1e-6)
    assert mig_s == mig_m
    for k, v in tm.last_eval_totals.items():
        np.testing.assert_allclose(ts.last_eval_totals[k], v, rtol=1e-6)
    # a styled batch of a CPU trainer takes K3's plain twin: no launch
    assert K3.LAUNCHES["style"] == 0


def _eps(jm, variables, key, n):
    """The (eps_c, eps_s) that VAE.__call__ draws from ``key``."""
    zeros = jnp.zeros((n, jm.z_dim))

    def draw(mdl):
        return mdl.sample(zeros, zeros), mdl.sample(zeros, zeros)

    return [torch.as_tensor(np.array(e)) for e in
            jm.apply(variables, method=draw, rngs={"reparam": key})]


def test_styled_fit_and_evaluate_overlay_jax():
    """tests/test_torch_trainer.py's twin with ``style_on_device=True`` on
    both sides: the JAX trainer styles inside its scanned epoch program, the
    port inside its loop, from the same raw images, keys and noise."""
    n_train, n_eval, bs, epochs, seed = 256, 72, 32, 2, 0
    jtrain, jvalid = _splits(JD, n_train, n_eval, seed)
    ttrain, tvalid = _splits(TD, n_train, n_eval, seed)
    jm = JVAE(total_z_dim=16)
    jt = JTrainer(jm, optax.adam(5e-4), sim_fn="cosine",
                  hyperparameter={**HP, "loc": 0, "scale": 1, "fused": True},
                  seed=seed, mig_backend="numpy")
    jt.state = jt._init_state()
    variables = {"params": jt.state.params, "batch_stats": jt.state.batch_stats}
    tt = _port_trainer(hyperparameter={"fused": True})
    tt.model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"])))

    rng = jax.random.key(seed)
    rng, _ = jax.random.split(rng)
    queue = []
    for _ in range(epochs):
        rng, k = jax.random.split(rng)
        queue += [_eps(jm, variables, kk, bs)
                  for kk in jax.random.split(k, n_train // bs)]
    rng, k = jax.random.split(rng)
    queue += [_eps(jm, variables, kk, bs)
              for kk in jax.random.split(k, n_eval // bs)]
    rng, k = jax.random.split(rng)
    queue.append(_eps(jm, variables, k, n_eval % bs))
    tt._draw_eps = lambda n, out=None: queue.pop(0)

    jhist = []
    jt._post_train_epoch = jhist.append
    jt.fit(epochs, jtrain, batch_size=bs, style_on_device=True)
    jmig, jmse = jt.evaluate(jvalid, batch_size=bs, style_on_device=True)
    tt.fit(epochs, ttrain, batch_size=bs, style_on_device=True)
    mig, mse = tt.evaluate(tvalid, batch_size=bs, style_on_device=True)
    assert not queue

    # the bars of tests/test_torch_trainer.py, for the reasons given there
    for e in range(epochs):
        np.testing.assert_allclose(tt.history[e]["loss"],
                                   np.asarray(jhist[e]["loss"]), rtol=1e-4,
                                   err_msg=f"epoch {e} per-step loss")
        for k in ("loss", "recon", "kl_c", "kl_s", "c_loss", "s_loss"):
            rtol = 1e-4 if k in ("loss", "recon", "c_loss") else 3e-3
            np.testing.assert_allclose(tt.history[e][k].mean(),
                                       np.asarray(jhist[e][k]).mean(),
                                       rtol=rtol, err_msg=f"epoch {e} {k}")
    np.testing.assert_allclose(mse, jmse, rtol=3e-3)
    assert np.isfinite(mig) and abs(mig - jmig) < 0.05


ARGS = ["--epochs", "1", "--n_train", "300", "--n_test", "80",
        "--batch_size", "32", "--k_max", "1", "--seed", "7", "--models",
        "clear", "--device", "cpu"]


def test_cli_writes_the_reference_schema_with_and_without_styling_on_device(
        tmp_path):
    out = {}
    for flag in ([], ["--style_on_device"]):
        d = tmp_path / ("dev" if flag else "mat")
        RUN.main(ARGS + ["--out", str(d)] + flag)
        with open(d / "styledmnist-k1-7.json") as f:
            out[bool(flag)] = json.load(f)
    assert out[True] == out[False]
    res = out[True]
    assert list(res) == ["clear"]
    r = res["clear"]
    assert set(r) == {"acc", "pr", "roc"} and 0.0 <= r["acc"] <= 1.0
    for part in ("pr", "roc"):
        assert set(r[part]) == {"overall", "stratified"}
        assert sorted(r[part]["stratified"]) == [str(c) for c in range(10)]
        assert np.isclose(r[part]["overall"],
                          np.mean(list(r[part]["stratified"].values())),
                          atol=1e-3)


def test_cli_passes_epochs_per_scan_to_every_fit(tmp_path, monkeypatch):
    """``--epochs_per_scan`` reaches the fit of the CNN entry and of a VAE
    entry, as the JAX runner passes it (its styledmnist_downstream.py and
    experiments/common.py): 2 epochs in one block leave one history entry,
    the last batch of each epoch."""
    from clearvae_torch.train import trainers as TT

    seen = []
    fit = TT.TrainerCore.fit

    def recording_fit(self, *args, **kwargs):
        out = fit(self, *args, **kwargs)
        seen.append((type(self).__name__, kwargs.get("epochs_per_scan"),
                     [len(h["loss"]) for h in self.history]))
        return out

    monkeypatch.setattr(TT.TrainerCore, "fit", recording_fit)
    args = ARGS[: ARGS.index("--models")] + ["--device", "cpu"]
    args[args.index("--epochs") + 1] = "2"
    RUN.main(args + ["--models", "baseline", "gvae", "--epochs_per_scan",
                     "2", "--out", str(tmp_path)])
    assert seen == [("SimpleCNNTrainer", 2, [2]),
                    ("HierarchicalVAETrainer", 2, [2])]
    with open(tmp_path / "styledmnist-k1-7.json") as f:
        assert list(json.load(f)) == ["baseline", "gvae"]


def test_unported_zoo_entries_name_their_roadmap_item():
    """Every zoo entry is ported: the port's zoo carries the JAX zoo's
    names, factories and hyperparameters, plus the device, and each entry
    builds its trainer on the CPU."""
    from clearvae_tpu.experiments import styledmnist_downstream as JRUN
    from clearvae_torch.train import trainers as TT

    kw = {"beta": 1 / 8, "vae_lr": 5e-4, "z_dim": 16, "alpha": 100.0,
          "temperature": 0.1}
    jzoo = JRUN.model_zoo(kw, seed=3)
    zoo = RUN.model_zoo({**kw, "device": "cpu"}, seed=3)
    assert list(zoo) == list(jzoo) == [
        "baseline", "gvae", "mlvae", "clear", "clear-tc",
        "clear-mim (L1OutUB)", "clear-mim (CLUB-S)"]
    kinds = {"baseline": TT.SimpleCNNTrainer, "gvae": TT.HierarchicalVAETrainer,
             "mlvae": TT.HierarchicalVAETrainer, "clear": TT.CLEARVAETrainer,
             "clear-tc": TT.ClearTCVAETrainer,
             "clear-mim (L1OutUB)": TT.ClearMIMVAETrainer,
             "clear-mim (CLUB-S)": TT.ClearMIMVAETrainer}
    for name, (factory, params) in zoo.items():
        jfactory, jparams = jzoo[name]
        assert factory.__name__ == jfactory.__name__, name
        assert params == {**jparams, "device": "cpu"}, name
        trainer = factory(**params)
        assert type(trainer) is kinds[name], name
        assert trainer.device == torch.device("cpu")
    assert type(zoo["clear-mim (CLUB-S)"][0](
        **zoo["clear-mim (CLUB-S)"][1]).mi_estimator).__name__ == "CLUBSample"


def test_cli_runs_the_whole_zoo_in_the_reference_schema(tmp_path):
    """The seven-entry CPU smoke of the runner (no --models)."""
    args = [a for a in ARGS if a not in ("--models", "clear")]
    RUN.main(args + ["--out", str(tmp_path)])
    with open(tmp_path / "styledmnist-k1-7.json") as f:
        res = json.load(f)
    assert list(res) == ["baseline", "gvae", "mlvae", "clear", "clear-tc",
                         "clear-mim (L1OutUB)", "clear-mim (CLUB-S)"]
    for name, r in res.items():
        assert set(r) == {"acc", "pr", "roc"} and 0.0 <= r["acc"] <= 1.0, name
        for part in ("pr", "roc"):
            assert set(r[part]) == {"overall", "stratified"}
            assert sorted(r[part]["stratified"]) == [str(c) for c in range(10)]
            assert np.isfinite(r[part]["overall"])


def test_probe_uncached_path_matches_cached():
    """The per-batch probe path (encode every batch, ``make_probe_step``)
    trains the probe the cached path trains: the same batches (shuffled by
    RandomState(epoch)) and, the encoder being frozen in eval mode, the
    same features; and the probe's evaluation with and without styling on
    the device agrees."""
    from clearvae_torch.train.trainers import DownstreamMLPTrainer

    train, test = _splits(TD, 128, 60, seed=1)
    vae = _port_trainer()
    probes = [DownstreamMLPTrainer(vae, seed=3) for _ in range(2)]
    probes[0].fit(2, train, batch_size=32, cache_features=True)
    probes[1].fit(2, train, batch_size=32, cache_features=False)
    ref = probes[0].mlp.state_dict()
    for k, v in probes[1].mlp.state_dict().items():
        # dense_0's bias is moved by Adam on float noise (test_torch_probe.py)
        if k not in ("dense_0.bias", "bn.running_mean"):
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    (aupr, auroc), acc = probes[0].evaluate(test, batch_size=32)
    assert probes[0].evaluate(test, batch_size=32, style_on_device=True) == \
        ((aupr, auroc), acc)
