"""Data and tensor parallelism of the port (``clearvae_torch/parallel``)
against the single-device port and the JAX package's mesh, on the CPU.

The module starts ONE 4-rank gloo job (this file run as a script, one
process a rank, one intra-op thread each; the ranks import no JAX) that
runs every case on a data mesh of 4 (``make_mesh(4)``) and on a 2 × 2
(data, model) mesh (``make_mesh2d(2, 2)``) and writes its arrays under
``tmp_path``. Meanwhile this process computes the references: the port's
single-device runs and, on the 8 virtual CPU devices of ``conftest.py``,
the JAX package's ``make_mesh(4)`` step. The bars are
``tests/test_parallel.py``'s: a step's loss at rtol 1e-5 and its
parameters within max(1e-3·max|a|, 1.2e-3); the dual-optimizer steps at
rtol 2e-4; fits' per-batch losses at rtol 2e-4, their parameters within
8 Adam steps' drift (8e-3) and MSE at rtol 1e-3; checkpoint resumes at
atol 2e-5 / rtol 2e-4. Gradients before Adam are held at rtol 1e-5 (with
an atol of 1e-5 of the model's largest entry): a loss share off by the
data size W would miss by a factor of W.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
B = 32                      # the step's batch (tests/test_parallel.py)
N_FIT, B_FIT = 64, 16       # the fits' dataset and batch
HP = dict(temperature=0.1, alpha=100.0, beta=1 / 8, ps=True, vae_lr=5e-4,
          z_dim=16, seed=0, verbose_period=10 ** 9)
TWO_PLAYER = {
    "tc": ("get_cleartcvae_trainer", dict(la=1.0, factor_cls_lr=1e-4)),
    "mim": ("get_clearmimvae_trainer", dict(mi_estimator="CLUBSample", la=3.0,
                                            mi_estimator_lr=2e-3)),
}
GROUPS = ("GVAE", "MLVAE")


# ---------------------------------------------------------------------------
# shared by the ranks and the references (no JAX)
# ---------------------------------------------------------------------------


def _tiny_ds(n=N_FIT, seed=3):
    from clearvae_torch.data.common import ArrayDataset

    rs = np.random.RandomState(seed)
    return ArrayDataset(rs.rand(n, 28, 28, 1).astype(np.float32),
                        rs.randint(0, 10, n), np.zeros(n, np.int64))


def _styled_ds():
    from clearvae_torch.data.mnist import synthetic_mnist
    from clearvae_torch.data.styled import make_styled_mnist

    return make_styled_mnist(*synthetic_mnist(N_FIT, seed=0), seed=0)


def _state(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _clear_step(inp, mesh, steps=1):
    """The CLEAR step (unfused, as in tests/test_parallel.py's setup) from
    the bridged JAX init, ``steps`` times on ``inp``'s batch with the
    noise of each step; returns its metrics, state and the gradients that
    the first update saw."""
    from clearvae_torch.config import AnnealConfig, ContrastiveConfig
    from clearvae_torch.models.vae import VAE
    from clearvae_torch.parallel.mesh import place_state
    from clearvae_torch.train.steps import make_clear_vae_step

    model = VAE(total_z_dim=16)
    model.load_state_dict(inp["sd"])
    shard = place_state(mesh, model)
    opt = torch.optim.Adam(shard.parameters(model), lr=5e-4)
    grads = []
    update = opt.step

    def step_and_record():
        if not grads:
            grads.append([p.grad.clone() for p in opt.param_groups[0]["params"]])
        update()
    opt.step = step_and_record
    step = make_clear_vae_step(model, opt, AnnealConfig(),
                               ContrastiveConfig(alpha=100.0), shard)
    eps = inp["eps"] if steps == 1 else inp["eps3"]
    for i in range(steps):
        m = step(shard.rows(inp["x"]), inp["label"],
                 eps if steps == 1 else eps[i])
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": _state(model), "grads": grads[0]}


def _fit(mesh, ds, epochs, bs=B_FIT, **fit_kw):
    """A CLEAR trainer from its factory, fit as a user calls it; returns it
    and its per-epoch histories."""
    from clearvae_torch.train.factories import get_clearvae_trainer

    t = get_clearvae_trainer(**HP, device="cpu", mesh=mesh)
    hist = []
    t._post_train_epoch = hist.append
    t.fit(epochs, ds, batch_size=bs, **fit_kw)
    return t, [h["loss"] for h in hist]


def _fit_case(mesh, ds, epochs, bs=B_FIT, styled=False):
    t, losses = _fit(mesh, ds, epochs, bs, style_on_device=styled)
    mig, mse = t.evaluate(ds, batch_size=bs, style_on_device=styled)
    return {"losses": np.stack(losses), "state": _state(t.model), "mse": mse,
            "mig": mig}


def _styled_eval(mesh):
    """The styled eval epoch of a fresh trainer (the same weights on every
    side, as tests/test_parallel.py evaluates one state)."""
    from clearvae_torch.train.factories import get_clearvae_trainer

    t = get_clearvae_trainer(**HP, device="cpu", mesh=mesh)
    mig, _ = t.evaluate(_styled_ds(), batch_size=B_FIT, style_on_device=True)
    return {"totals": dict(t.last_eval_totals), "mig": mig}


def _two_player(kind, mesh, inp):
    from clearvae_torch.train import factories as TF

    name, kw = TWO_PLAYER[kind]
    t = getattr(TF, name)(**{k: v for k, v in HP.items() if k != "ps"}, **kw,
                          device="cpu", mesh=mesh)
    x, label = inp["x"][:16], inp["label"][:16]
    noise = inp[f"noise_{kind}"]
    m = t.train_step(t.shard.rows(x), label, noise)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": _state(t.model)}


def _group(mode, mesh, inp):
    from clearvae_torch.train.factories import get_hierarchical_vae_trainer

    t = get_hierarchical_vae_trainer(beta=1 / 8, vae_lr=5e-4, z_dim=16,
                                     group_mode=mode, device="cpu", mesh=mesh)
    t.evaluate(_tiny_ds(), batch_size=B_FIT, with_evidence_acc=True)
    totals = dict(t.last_eval_totals)
    m = t.train_step(t.shard.rows(inp["x"]), inp["label"], inp["eps"])
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": _state(t.model), "totals": totals}


def _resume(mesh, tmp):
    """An uninterrupted 3-epoch fit against 2 epochs, a checkpoint (rank 0
    writes it), a fresh trainer that restores it and runs the third."""
    ds = _tiny_ds()
    ref, _ = _fit(mesh, ds, 3)
    _fit(mesh, ds, 2, checkpoint_dir=tmp, checkpoint_every=1)
    from clearvae_torch.train.factories import get_clearvae_trainer

    t2 = get_clearvae_trainer(**HP, device="cpu", mesh=mesh)
    t2.restore_checkpoint(tmp)
    t2.fit(1, ds, batch_size=B_FIT, start_epoch=2)
    return {"ref": _state(ref.model), "resumed": _state(t2.model),
            "steps": (ref.train_step.step, t2.train_step.step)}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _rank_cases(inp, out_dir):
    from clearvae_torch.parallel import make_mesh, make_mesh2d

    mesh, mesh2 = make_mesh(WORLD), make_mesh2d(2, 2)
    res = {}
    t0 = time.perf_counter()
    res["step"] = _clear_step(inp, mesh)
    res["steps3"] = _clear_step(inp, mesh, 3)
    res["fit"] = _fit_case(mesh, _tiny_ds(), 2)
    res["styled"] = _fit_case(mesh, _styled_ds(), 2, styled=True)
    res["styled_eval"] = _styled_eval(mesh)
    for kind in TWO_PLAYER:
        res[kind] = _two_player(kind, mesh, inp)
    for mode in GROUPS:
        res[mode] = _group(mode, mesh, inp)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res["b15"] = _fit_case(mesh, _tiny_ds(60), 1, bs=15)
        with warnings.catch_warnings(record=True) as quiet:
            warnings.simplefilter("always")
            _fit(mesh, _tiny_ds(), 1)
    res["b15"]["warnings"] = [str(w.message) for w in caught]
    res["b15"]["quiet"] = [str(w.message) for w in quiet
                           if "does not divide" in str(w.message)]
    res["ckpt_dp"] = _resume(mesh, os.path.join(out_dir, "ck_dp"))
    res["tp_step"] = _clear_step(inp, mesh2)
    res["tp_fit"] = _fit_case(mesh2, _tiny_ds(), 2)
    res["tp_moments"] = _moments(mesh2)
    res["ckpt_tp"] = _resume(mesh2, os.path.join(out_dir, "ck_tp"))
    res["seconds"] = time.perf_counter() - t0
    return res


def _moments(mesh2):
    """(leaf, Adam exp_avg numel, the full leaf's numel) of every parameter
    of a 2 × 2 trainer after one epoch."""
    t, _ = _fit(mesh2, _tiny_ds(), 1)
    out = []
    for (name, p), q in zip(t.model.named_parameters(),
                            t.optimizer.param_groups[0]["params"]):
        st = t.optimizer.state[q]
        out.append((name, st["exp_avg"].numel(), st["exp_avg_sq"].numel(),
                    q.numel(), p.numel()))
    return out


def _rank_main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args(argv)
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port}",
                            rank=args.rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    out = os.path.join(args.dir, f"rank{args.rank}.pt")
    try:
        inp = torch.load(os.path.join(args.dir, "inputs.pt"),
                         weights_only=True)
        res = _rank_cases(inp, args.dir)
        res["jax_loaded"] = sorted({m.split(".")[0] for m in sys.modules}
                                   & {"jax", "flax", "optax", "clearvae_tpu"})
        torch.save(res, out)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the references and the job (pytest)
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_inputs():
    """The JAX package's CLEAR state on B = 32 (tests/test_parallel.py's
    setup), the noise its step draws, and a function that runs its step on
    JAX's meshes: make_mesh(4) and the 2 × 2 ``shard_state_tp`` mesh."""
    import jax
    import jax.numpy as jnp
    import optax

    from clearvae_torch.bridge import params_from_flax
    from clearvae_tpu.config import AnnealConfig, ContrastiveConfig
    from clearvae_tpu.models.vae import VAE
    from clearvae_tpu.parallel.mesh import (make_mesh, replicate_state,
                                            shard_batch)
    from clearvae_tpu.parallel.tp import make_mesh2d, shard_state_tp
    from clearvae_tpu.train.steps import init_vae_state, make_clear_vae_step

    jm = VAE(total_z_dim=16)
    tx = optax.adam(5e-4)
    state = init_vae_state(jm, tx, jax.random.key(0), 28, 1)
    rs = np.random.RandomState(0)
    x = rs.rand(B, 28, 28, 1).astype(np.float32)
    label = rs.randint(0, 10, B)
    key = jax.random.key(42)
    apply = jax.jit(lambda v, x, k: jm.apply(
        v, x, explicit=True, train=True, rngs={"reparam": k},
        mutable=["batch_stats"])[0])
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    _, lp, z = apply(variables, jnp.asarray(x), key)
    z = np.asarray(z)
    eps = np.stack([(z[:, h * 8:(h + 1) * 8] - np.asarray(lp[m]))
                    / np.exp(0.5 * np.asarray(lp[v]))
                    for h, (m, v) in enumerate((("mu_c", "logvar_c"),
                                                ("mu_s", "logvar_s")))])
    step = make_clear_vae_step(jm, tx, AnnealConfig(),
                               ContrastiveConfig(alpha=100.0))

    def mesh_steps():
        out = {}
        for name, mesh, place in (
                ("jax_mesh", make_mesh(4), replicate_state),
                ("jax_tp", make_mesh2d(2, 2), shard_state_tp)):
            xs, ls = shard_batch(mesh, jnp.asarray(x), jnp.asarray(label))
            s4, m4 = step(place(mesh, state), xs, ls, key)
            tree = jax.tree.map(np.asarray, (s4.params, s4.batch_stats))
            out[name] = {"metrics": {k: float(v) for k, v in m4.items()},
                         "state": params_from_flax(*tree)}
        return out

    tree = jax.tree.map(np.asarray, (state.params, state.batch_stats))
    return {"sd": params_from_flax(*tree),
            "x": torch.as_tensor(x), "label": torch.as_tensor(label),
            "eps": torch.as_tensor(eps.astype(np.float32))}, mesh_steps


def _noise_inputs():
    rs = np.random.RandomState(5)

    def normal(*shape):
        return torch.as_tensor(rs.randn(*shape).astype(np.float32))

    return {"eps3": normal(3, 2, B, 8),
            "noise_tc": (normal(2, 16, 8), normal(2, 16, 8)),
            "noise_mim": {"eps": normal(2, 16, 8),
                          "perm": torch.as_tensor(rs.permutation(16)),
                          "inner": normal(5, 16, 16)}}


def _references(inp):
    """The single-device port on every case the ranks run."""
    ref = {"step": _clear_step(inp, None), "steps3": _clear_step(inp, None, 3),
           "fit": _fit_case(None, _tiny_ds(), 2),
           "styled": _fit_case(None, _styled_ds(), 2, styled=True),
           "styled_eval": _styled_eval(None),
           "b15": _fit_case(None, _tiny_ds(60), 1, bs=15)}
    for kind in TWO_PLAYER:
        ref[kind] = _two_player(kind, None, inp)
    for mode in GROUPS:
        ref[mode] = _group(mode, None, inp)
    return ref


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """(the ranks' results, the references, the JAX mesh step), from one
    4-rank gloo job run beside the reference computations."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("parallel")
    t0 = time.perf_counter()
    jax_inp, jax_mesh_steps = _jax_inputs()
    inp = {**jax_inp, **_noise_inputs()}
    torch.save(inp, d / "inputs.pt")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank", str(r), "--port", str(port),
                               "--dir", str(d)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(WORLD)]
    try:
        jax_mesh = jax_mesh_steps()
        ref = _references(inp)
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        torch.set_num_threads(threads)
    for r, (p, log) in enumerate(zip(procs, logs)):
        err = d / f"rank{r}.pt.err"
        assert p.returncode == 0, (err.read_text() if err.exists() else log)
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    print(f"parallel job: {time.perf_counter() - t0:.1f} s in all, ranks "
          f"{[round(r['seconds'], 1) for r in ranks]} s of cases")
    return ranks, ref, jax_mesh, inp


# ---------------------------------------------------------------------------
# bars
# ---------------------------------------------------------------------------


def _step_params_close(got: dict, want: dict):
    """tests/test_parallel.py's bar for a step's updated parameters."""
    for k, w in want.items():
        a, b = np.asarray(w, np.float64), np.asarray(got[k], np.float64)
        tol = 1e-3 * max(np.abs(a).max(), 1e-3)
        assert np.abs(a - b).max() <= max(tol, 1.2e-3), k


def _fit_params_close(got: dict, want: dict, bound: float = 8 * 5e-4 * 2):
    for k, w in want.items():
        d = (got[k].double() - w.double()).abs().max()
        assert float(d) <= bound, (k, float(d))


def _ranks_equal(ranks, key):
    for r in ranks[1:]:
        for k, v in ranks[0][key]["state"].items():
            assert torch.equal(r[key]["state"][k], v), (key, k)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def test_ranks_import_no_jax(job):
    ranks, *_ = job
    assert all(r["jax_loaded"] == [] for r in ranks)


@pytest.mark.parametrize("against", ["jax_mesh", "port_single"])
def test_dp_step_matches(job, against):
    """DP(4) = JAX's make_mesh(4) step and = the port's single device."""
    ranks, ref, jax_mesh, _ = job
    want = jax_mesh["jax_mesh"] if against == "jax_mesh" else ref["step"]
    for r in ranks:
        for k in ("loss", "c_loss"):
            np.testing.assert_allclose(r["step"]["metrics"][k],
                                       want["metrics"][k], rtol=1e-5,
                                       err_msg=k)
        _step_params_close(r["step"]["state"],
                           {k: v for k, v in want["state"].items()
                            if "running" not in k})


def test_dp_gradients_are_the_global_gradient(job):
    """Before Adam, every rank's summed gradient is the single-device one:
    each rank's loss is its share of the global loss, not W times it. The
    atol is 1e-5 of the largest gradient entry of the model: an
    analytically zero gradient (the conv biases ahead of BatchNorm) is the
    float noise of the sums that cancel in it, of that size."""
    ranks, ref, *_ = job
    scale = max(float(w.abs().max()) for w in ref["step"]["grads"])
    for r in ranks:
        for g, w in zip(r["step"]["grads"], ref["step"]["grads"]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-5 * scale)


def test_dp_batchnorm_running_stats_are_the_global_batch(job):
    ranks, ref, *_ = job
    for r in ranks:
        for k, w in ref["step"]["state"].items():
            if "running" in k:
                np.testing.assert_allclose(r["step"]["state"][k].numpy(),
                                           w.numpy(), rtol=1e-5, atol=1e-7,
                                           err_msg=k)


def test_dp_three_steps_stay_synced(job):
    ranks, ref, *_ = job
    for r in ranks:
        np.testing.assert_allclose(r["steps3"]["metrics"]["loss"],
                                   ref["steps3"]["metrics"]["loss"],
                                   rtol=1e-4)
    _ranks_equal(ranks, "steps3")


@pytest.mark.parametrize("case", ["fit", "styled"])
def test_graphed_body_epochs_on_the_mesh(job, case):
    """``fit``'s default (the graph's body, uncaptured on the CPU), on
    resident data and styled per batch (K3's twin on each rank's rows):
    every per-batch loss and the parameters; on resident data the MSE of
    the evaluation too (as tests/test_parallel.py holds each). Every rank
    ends with the same state and evaluates the same MIG."""
    ranks, ref, *_ = job
    for r in ranks:
        np.testing.assert_allclose(r[case]["losses"], ref[case]["losses"],
                                   rtol=2e-4)
        _fit_params_close(r[case]["state"], ref[case]["state"])
        if case == "fit":
            np.testing.assert_allclose(r[case]["mse"], ref[case]["mse"],
                                       rtol=1e-3)
    _ranks_equal(ranks, case)
    assert len({(r[case]["mig"], r[case]["mse"]) for r in ranks}) == 1


def test_styled_eval_epoch_on_the_mesh(job):
    """The styled eval epoch of one state: each rank styles its rows, the
    step totals the scalars over the global batch (tests/test_parallel.py's
    2e-4), and MIG comes from the gathered latents."""
    ranks, ref, *_ = job
    want = ref["styled_eval"]
    for r in ranks:
        for k in ("recon", "kl_c", "kl_s", "c_loss", "s_loss"):
            np.testing.assert_allclose(r["styled_eval"]["totals"][k],
                                       want["totals"][k], rtol=2e-4,
                                       err_msg=k)
        np.testing.assert_allclose(r["styled_eval"]["mig"], want["mig"],
                                   rtol=1e-3)


@pytest.mark.parametrize("kind", list(TWO_PLAYER))
def test_dual_optimizer_dp_matches_single_device(job, kind):
    ranks, ref, *_ = job
    for r in ranks:
        assert r[kind]["metrics"].keys() == ref[kind]["metrics"].keys()
        for k, v in ref[kind]["metrics"].items():
            np.testing.assert_allclose(r[kind]["metrics"][k], v, rtol=2e-4,
                                       err_msg=k)
    _ranks_equal(ranks, kind)


@pytest.mark.parametrize("mode", GROUPS)
def test_group_evidence_over_the_global_batch(job, mode):
    """GVAE / ML-VAE: the evidence of the gathered rows, in the evaluation
    with the batch's evidence (of the fresh trainer) and in one step."""
    ranks, ref, *_ = job
    for r in ranks:
        for k, v in ref[mode]["metrics"].items():
            np.testing.assert_allclose(r[mode]["metrics"][k], v, rtol=1e-5,
                                       err_msg=k)
        _step_params_close(r[mode]["state"], ref[mode]["state"])
        for k, v in ref[mode]["totals"].items():
            np.testing.assert_allclose(r[mode]["totals"][k], v, rtol=2e-4,
                                       err_msg=k)


def test_uneven_blocks_b15_on_four_ranks(job):
    """B = 15 over 4 ranks: blocks of 4, 4, 4, 3, the single device's
    numbers, and JAX's warning text; a divisible batch stays silent."""
    ranks, ref, *_ = job
    for r in ranks:
        np.testing.assert_allclose(r["b15"]["losses"], ref["b15"]["losses"],
                                   rtol=2e-4)
        _fit_params_close(r["b15"]["state"], ref["b15"]["state"],
                          4 * 5e-4 * 2)
        assert any("batch size 15 does not divide the data axis" in w
                   for w in r["b15"]["warnings"])
        assert r["b15"]["quiet"] == []


@pytest.mark.parametrize("against", ["jax_mesh", "jax_tp", "port_single"])
def test_tp_step_matches_single_device(job, against):
    """The 2 × 2 step = JAX's make_mesh(4) step, JAX's 2 × 2
    ``shard_state_tp`` step and the port's single device (the single
    device's numbers, as JAX's ``test_tp_matches_single_device`` holds
    its TP step)."""
    ranks, ref, jax_mesh, _ = job
    want = ref["step"] if against == "port_single" else jax_mesh[against]
    for r in ranks:
        for k in ("loss", "c_loss"):
            np.testing.assert_allclose(r["tp_step"]["metrics"][k],
                                       want["metrics"][k], rtol=1e-5,
                                       err_msg=k)
        _step_params_close(r["tp_step"]["state"],
                           {k: v for k, v in want["state"].items()
                            if "running" not in k})


def test_tp_trainer_user_path(job):
    """``get_clearvae_trainer(mesh=make_mesh2d(2, 2))``: fit and evaluate
    with the numbers of the single device (params ≤ 8e-3, MSE rtol 1e-3)."""
    ranks, ref, *_ = job
    for r in ranks:
        _fit_params_close(r["tp_fit"]["state"], ref["fit"]["state"])
        np.testing.assert_allclose(r["tp_fit"]["mse"], ref["fit"]["mse"],
                                   rtol=1e-3)
    _ranks_equal(ranks, "tp_fit")


def test_tp_adam_moments_are_sharded(job):
    """Each rank's optimizer holds half of every leaf that the rule table
    shards (model axis 2), the whole of the others, and so do its
    moments."""
    from clearvae_torch.models.vae import VAE
    from clearvae_torch.parallel.tp import specs

    ranks, *_ = job
    spec = specs(VAE(total_z_dim=16), 2)
    sharded = 0
    for r in ranks:
        for name, m, v, q, full in r["tp_moments"]:
            assert m == v == q
            if spec[name] is None:
                assert q == full, name
            else:
                assert 2 * q == full, name
                sharded += 1
    assert sharded >= 4 * 8


@pytest.mark.parametrize("case", ["ckpt_dp", "ckpt_tp"])
def test_checkpoint_resume_on_the_mesh(job, case):
    """Rank 0 writes the whole state (on 2 × 2, the shards gathered); a
    fresh trainer on the mesh restores it and resumes as the uninterrupted
    run continued."""
    ranks, *_ = job
    for r in ranks:
        steps = r[case]["steps"]
        assert steps[0] == steps[1] == 3 * (N_FIT // B_FIT)
        for k, v in r[case]["ref"].items():
            np.testing.assert_allclose(r[case]["resumed"][k].numpy(),
                                       v.numpy(), atol=2e-5, rtol=2e-4,
                                       err_msg=k)


def test_tp_param_spec_marks_jax_leaves():
    """``param_spec`` shards the leaves that JAX's ``param_spec`` shards,
    at the dimension the bridge maps JAX's to: each JAX leaf is replaced by
    the index along its sharded dimension (zeros where it replicates), and
    the bridged tensor must vary along the torch leaf's dimension alone."""
    import jax
    import optax

    from clearvae_torch.bridge import params_from_flax
    from clearvae_torch.models.vae import VAE as TVAE
    from clearvae_torch.parallel.tp import specs
    from clearvae_tpu.models.vae import VAE
    from clearvae_tpu.parallel.tp import param_spec as jax_spec
    from clearvae_tpu.train.steps import init_vae_state

    state = init_vae_state(VAE(total_z_dim=16), optax.adam(5e-4),
                           jax.random.key(0), 28, 1)

    def marker(path, leaf):
        spec = jax_spec(path, leaf, 2)
        out = np.zeros(leaf.shape, np.float32)
        for d, axis in enumerate(spec):
            if axis is not None:
                shape = [1] * leaf.ndim
                shape[d] = leaf.shape[d]
                out = out + np.arange(leaf.shape[d], dtype=np.float32).reshape(
                    shape)
        return out

    marks = jax.tree_util.tree_map_with_path(
        marker, (state.params, state.batch_stats))
    bridged = params_from_flax(*marks)
    spec = specs(TVAE(total_z_dim=16), 2)
    assert spec.keys() == bridged.keys()
    for k, t in bridged.items():
        varies = [d for d in range(t.ndim)
                  if t.shape[d] > 1 and bool((t.diff(dim=d) != 0).any())]
        assert varies == ([] if spec[k] is None else [spec[k]]), k
    assert sum(d is not None for d in spec.values()) >= 8
    assert spec["decoder.convts.2.weight"] is None      # 1 output channel
    assert spec["decoder.convts.0.weight"] == 1         # [in, out, kh, kw]


def test_block_is_tensor_split():
    from clearvae_torch.parallel.mesh import block

    for n in (15, 16, 3, 0, 129):
        for w in (1, 2, 4, 8):
            parts = torch.tensor_split(torch.arange(n), w)
            for r, p in enumerate(parts):
                lo, hi = block(n, w, r)
                assert torch.equal(torch.arange(lo, hi), p)


def test_no_mesh_shard_is_the_identity():
    from clearvae_torch.parallel.mesh import Shard

    s, t = Shard(), torch.randn(4, 3)
    assert s.rows(t) is t and s.gather(t, 4) is t
    assert s.row_share(t, 2, 4) is t and s.rep_share(t) is t
    m = {"a": t[0, 0]}
    assert s.total(m) is m and s.leader


def test_make_mesh_needs_the_process_group():
    from clearvae_torch.parallel import make_mesh, make_mesh2d

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh2d(2, 2)


@pytest.mark.parametrize("factory", [
    "get_clearvae_trainer", "get_hierarchical_vae_trainer",
    "get_cleartcvae_trainer", "get_clearmimvae_trainer"])
def test_vae64_factories_refuse_a_mesh(factory):
    """VAE64 is not ported under a mesh: each VAE factory refuses it there
    (and ``bench.main`` leaves the 64×64 rows out on a mesh)."""
    from clearvae_torch.train import factories as TF

    kw = dict(beta=1 / 8, vae_lr=5e-4, z_dim=64, ps=True, alpha=100.0,
              temperature=0.1, group_mode="GVAE", la=1.0, factor_cls_lr=1e-4,
              mi_estimator="CLUBSample", mi_estimator_lr=2e-3)
    with pytest.raises(NotImplementedError, match="VAE64.*mesh"):
        getattr(TF, factory)(**kw, vae_arch="VAE64", in_channel=3,
                             device="cpu", mesh=object())


def test_cnn_factories_refuse_a_mesh():
    from clearvae_torch.train import factories as TF

    with pytest.raises(NotImplementedError, match="mesh"):
        TF.get_cnn_trainer(n_class=10, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        TF.get_lamcnn_trainer(n_class=2, lam_coef=1e-3, device="cpu",
                              mesh=object())


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
