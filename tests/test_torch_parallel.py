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
CNN_CLASSES = {"cnn": 10, "lam": 5}  # LAM's 5: its head stays whole on 2 × 2
LAM_COEF = 0.5
B64, Z64 = 8, 64            # the VAE64 cases' batch and z
V64_FACTORIES = {
    "clear": ("get_clearvae_trainer", dict(ps=True, alpha=100.0,
                                           temperature=0.1)),
    "gvae": ("get_hierarchical_vae_trainer", dict(group_mode="GVAE")),
    "tc": ("get_cleartcvae_trainer", dict(la=1.0, factor_cls_lr=1e-4,
                                          alpha=100.0, temperature=0.1)),
    "mim": ("get_clearmimvae_trainer", dict(mi_estimator="CLUBSample", la=3.0,
                                            mi_estimator_lr=2e-3, alpha=100.0,
                                            temperature=0.1)),
    "clear_bf16": ("get_clearvae_trainer", dict(
        ps=True, alpha=100.0, temperature=0.1,
        vae_kwargs={"dtype": torch.bfloat16, "fused_heads": True})),
}


# ---------------------------------------------------------------------------
# shared by the ranks and the references (no JAX)
# ---------------------------------------------------------------------------


def _tiny_ds(n=N_FIT, seed=3, n_class=10):
    from clearvae_torch.data.common import ArrayDataset

    rs = np.random.RandomState(seed)
    return ArrayDataset(rs.rand(n, 28, 28, 1).astype(np.float32),
                        rs.randint(0, n_class, n), np.zeros(n, np.int64))


def _styled_ds():
    from clearvae_torch.data.mnist import synthetic_mnist
    from clearvae_torch.data.styled import make_styled_mnist

    return make_styled_mnist(*synthetic_mnist(N_FIT, seed=0), seed=0)


def _state(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _recording_adam(params, lr):
    """Adam whose first update records the gradients it applies (under a
    mesh: summed over the data axis); returns it and the list they go
    to."""
    opt = torch.optim.Adam(params, lr=lr)
    grads = []
    update = opt.step

    def step_and_record():
        if not grads:
            grads.append([p.grad.clone() for p in opt.param_groups[0]["params"]])
        update()
    opt.step = step_and_record
    return opt, grads


def _clear_step(inp, mesh, steps=1, v64=False):
    """The CLEAR step (unfused, as in tests/test_parallel.py's setup) from
    the bridged JAX init, ``steps`` times on ``inp``'s batch with the
    noise of each step; returns its metrics, state and the gradients that
    the first update saw. ``v64``: VAE64 at z = 64 on the B = 8 batch of
    64×64×3 images."""
    from clearvae_torch.config import AnnealConfig, ContrastiveConfig
    from clearvae_torch.models.vae import VAE, VAE64
    from clearvae_torch.parallel.mesh import place_state
    from clearvae_torch.train.steps import make_clear_vae_step

    pre = "v64_" if v64 else ""
    model = VAE64(total_z_dim=Z64) if v64 else VAE(total_z_dim=16)
    model.load_state_dict(inp[pre + "sd"])
    shard = place_state(mesh, model)
    opt, grads = _recording_adam(shard.parameters(model), 5e-4)
    step = make_clear_vae_step(model, opt, AnnealConfig(),
                               ContrastiveConfig(alpha=100.0), shard)
    eps = inp[pre + "eps"] if steps == 1 else inp["eps3"]
    for i in range(steps):
        m = step(shard.rows(inp[pre + "x"]), inp[pre + "label"],
                 eps if steps == 1 else eps[i])
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": _state(model), "grads": grads[0]}


def _cnn_step(inp, mesh, kind):
    """One CNN (``kind`` "cnn") or LAM-CNN ("lam") step from the bridged
    JAX init on the B = 32 batch, Adam 1e-4 (the factories'), the LAM
    shuffle on JAX's uniforms: its metrics, state, the gradients the update
    saw and, for LAM, the x̃ rows that this rank's second trunk pass
    took."""
    from clearvae_torch.models.cnn import LAMCNN, SimpleCNN
    from clearvae_torch.parallel.mesh import place_state
    from clearvae_torch.train import steps as S

    model = (LAMCNN if kind == "lam" else SimpleCNN)(n_class=CNN_CLASSES[kind])
    model.load_state_dict(inp[f"{kind}_sd"])
    shard = place_state(mesh, model)
    opt, grads = _recording_adam(shard.parameters(model), 1e-4)
    seen = []
    if kind == "lam":
        features = model.features

        def features_seen(x, train=True, update_stats=True):
            if not update_stats:
                seen.append(x.detach().clone())
            return features(x, train, update_stats)
        model.features = features_seen
        step, noise = S.make_lam_cnn_step(model, opt, LAM_COEF, shard), \
            inp["lam_u"]
    else:
        step, noise = S.make_cnn_step(model, opt, shard), None
    m = step(shard.rows(inp["cnn_x"]), inp[f"{kind}_label"], noise)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": _state(model), "grads": grads[0],
            "x_tilde": seen[0] if seen else None}


def _trainer(kind, mesh):
    """The CLEAR ("clear"), CNN ("cnn") or LAM-CNN ("lam") trainer from its
    factory, seed 0, on the CPU and ``mesh``."""
    from clearvae_torch.train import factories as TF

    if kind == "clear":
        return TF.get_clearvae_trainer(**HP, device="cpu", mesh=mesh)
    kw = dict(seed=0, verbose_period=10 ** 9, device="cpu", mesh=mesh)
    if kind == "lam":
        return TF.get_lamcnn_trainer(CNN_CLASSES["lam"], LAM_COEF, **kw)
    return TF.get_cnn_trainer(CNN_CLASSES["cnn"], **kw)


def _fit(mesh, ds, epochs, bs=B_FIT, kind="clear", **fit_kw):
    """A trainer from its factory, fit as a user calls it; returns it and
    its per-epoch histories of the loss (LAM's: the cross-entropy)."""
    t = _trainer(kind, mesh)
    hist = []
    t._post_train_epoch = hist.append
    t.fit(epochs, ds, batch_size=bs, **fit_kw)
    return t, [h["ce_loss" if kind == "lam" else "loss"] for h in hist]


def _fit_case(mesh, ds, epochs, bs=B_FIT, styled=False):
    t, losses = _fit(mesh, ds, epochs, bs, style_on_device=styled)
    mig, mse = t.evaluate(ds, batch_size=bs, style_on_device=styled)
    return {"losses": np.stack(losses), "state": _state(t.model), "mse": mse,
            "mig": mig}


def _cnn_fit_case(mesh, kind, styled=False, **fit_kw):
    """A CNN or LAM-CNN trainer fit 2 epochs (on styled digits styled per
    batch, or resident data) and evaluated: losses, state, accuracy."""
    ds = _styled_ds() if styled else _tiny_ds(n_class=CNN_CLASSES[kind])
    t, losses = _fit(mesh, ds, 2, kind=kind, style_on_device=styled,
                     **fit_kw)
    _, acc = t.evaluate(ds, batch_size=B_FIT, style_on_device=styled)
    return {"losses": np.stack(losses), "state": _state(t.model), "acc": acc,
            "graphs": len(t._graphs), "history": t.history}


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


def _v64_factory_step(name, mesh, inp):
    """One step of a VAE64 trainer (z = 64, 64×64×3; CLEAR, CLEAR-TC and
    CLEAR-MIM with the latent losses fused) from its factory on the B = 8
    batch and its noise: the metrics and the updated 1-D leaves and latent
    heads (the whole state is ~6 M floats a rank)."""
    from clearvae_torch.train import factories as TF

    factory, kw = V64_FACTORIES[name]
    if name != "gvae":
        kw = {**kw, "hyperparameter": {"fused": True}}
    t = getattr(TF, factory)(beta=1 / 8, vae_lr=5e-4, z_dim=Z64,
                             vae_arch="VAE64", in_channel=3, seed=0,
                             device="cpu", mesh=mesh, **kw)
    m = t.train_step(t.shard.rows(inp["v64_x"]), inp["v64_label"],
                     inp[f"v64_noise_{name}"])
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": {k: v for k, v in _state(t.model).items()
                      if v.ndim == 1 or "head" in k}}


def _resume(mesh, tmp, kind="clear"):
    """An uninterrupted 3-epoch fit against 2 epochs, a checkpoint (rank 0
    writes it), a fresh trainer that restores it and runs the third."""
    ds = _tiny_ds(n_class=CNN_CLASSES.get(kind, 10))
    ref, _ = _fit(mesh, ds, 3, kind=kind)
    _fit(mesh, ds, 2, kind=kind, checkpoint_dir=tmp, checkpoint_every=1)
    t2 = _trainer(kind, mesh)
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
    t1 = time.perf_counter()
    for kind in CNN_CLASSES:
        res[f"{kind}_step"] = _cnn_step(inp, mesh, kind)
        res[f"{kind}_tp_step"] = _cnn_step(inp, mesh2, kind)
    res["cnn_tp_graphed"] = _cnn_fit_case(mesh2, "cnn")
    res["cnn_tp_eager"] = _cnn_fit_case(mesh2, "cnn", use_scan=False)
    res["cnn_styled"] = _cnn_fit_case(mesh, "cnn", styled=True)
    res["ckpt_lam_tp"] = _resume(mesh2, os.path.join(out_dir, "ck_lam"), "lam")
    res["v64_step"] = _clear_step(inp, mesh, v64=True)
    for name in V64_FACTORIES:
        for tag, m in (("dp", mesh), ("tp", mesh2)):
            res[f"v64_{name}_{tag}"] = _v64_factory_step(name, m, inp)
    res["seconds"] = (t1 - t0, time.perf_counter() - t1)
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


def _jax_vae(jm, size, ch, b, seed):
    """A JAX VAE's init (adam 5e-4), a batch of ``b`` images of ``size``²
    × ``ch`` with labels 0..9, the reparameterization noise JAX's step
    draws from its key (recovered from one train-mode forward) and its
    CLEAR step."""
    import jax
    import jax.numpy as jnp
    import optax

    from clearvae_tpu.config import AnnealConfig, ContrastiveConfig
    from clearvae_tpu.train.steps import init_vae_state, make_clear_vae_step

    tx = optax.adam(5e-4)
    state = init_vae_state(jm, tx, jax.random.key(0), size, ch)
    rs = np.random.RandomState(seed)
    x = rs.rand(b, size, size, ch).astype(np.float32)
    label = rs.randint(0, 10, b)
    key = jax.random.key(42)
    apply = jax.jit(lambda v, x, k: jm.apply(
        v, x, explicit=True, train=True, rngs={"reparam": k},
        mutable=["batch_stats"])[0])
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    _, lp, z = apply(variables, jnp.asarray(x), key)
    z, h = np.asarray(z), z.shape[-1] // 2
    eps = np.stack([(z[:, i * h:(i + 1) * h] - np.asarray(lp[m]))
                    / np.exp(0.5 * np.asarray(lp[v]))
                    for i, (m, v) in enumerate((("mu_c", "logvar_c"),
                                                ("mu_s", "logvar_s")))])
    step = make_clear_vae_step(jm, tx, AnnealConfig(),
                               ContrastiveConfig(alpha=100.0))
    return state, x, label, eps.astype(np.float32), key, step


def _jax_cnn(name, n_class, x, label, key, seed):
    """A JAX CNN's init (running statistics drawn away from 0 and 1) and
    its step (``make_cnn_step``, or ``make_lam_cnn_step`` with ``key``'s
    shuffle) through ``optax.identity()``, whose update is the
    gradient."""
    import jax
    import jax.numpy as jnp
    import optax

    from clearvae_tpu.models import cnn as JC
    from clearvae_tpu.train import steps as JS

    jm = getattr(JC, name)(n_class=n_class, in_channel=1)
    v = jax.jit(jm.init)({"params": jax.random.key(seed)},
                         jnp.zeros((2, 28, 28, 1)))
    rs = np.random.RandomState(seed)
    stats = jax.tree.map(lambda a: (rs.rand(*a.shape) * 0.5 + 0.2)
                         .astype(np.float32), v["batch_stats"])
    tx = optax.identity()
    state = JS.TrainState(params=v["params"], batch_stats=stats,
                          opt_state=tx.init(v["params"]),
                          step=jnp.zeros((), jnp.int32))
    step = (JS.make_lam_cnn_step(jm, tx, LAM_COEF, JC.lam_head_weight)
            if name == "LAMCNN" else JS.make_cnn_step(jm, tx))
    return state, lambda mesh, place, xs, ls: step(place(mesh, state), xs, ls,
                                                    key)


def _jax_inputs():
    """The JAX package's CLEAR state on B = 32 (tests/test_parallel.py's
    setup), its VAE64 state on B = 8, its SimpleCNN and LAMCNN states on
    the B = 32 batch, the noise and uniforms their steps draw, and a
    function that runs their steps on JAX's meshes: make_mesh(4) for each,
    and the 2 × 2 ``shard_state_tp`` mesh for CLEAR."""
    import jax
    import jax.numpy as jnp

    from clearvae_torch.bridge import cnn_params_from_flax, params_from_flax
    from clearvae_tpu.models.vae import VAE, VAE64
    from clearvae_tpu.parallel.mesh import (make_mesh, replicate_state,
                                            shard_batch)
    from clearvae_tpu.parallel.tp import make_mesh2d, shard_state_tp

    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    state, x, label, eps, key, step = _jax_vae(VAE(total_z_dim=16), 28, 1,
                                               B, 0)
    s64, x64, l64, e64, k64, step64 = _jax_vae(VAE64(total_z_dim=Z64), 64, 3,
                                               B64, 7)
    rs = np.random.RandomState(8)
    cnn_label = {k: rs.randint(0, n, B) for k, n in CNN_CLASSES.items()}
    lam_key = jax.random.key(9)
    cnns = {kind: _jax_cnn(name, CNN_CLASSES[kind], x, cnn_label[kind],
                           lam_key, 1 + i)
            for i, (kind, name) in enumerate((("cnn", "SimpleCNN"),
                                              ("lam", "LAMCNN")))}

    def vae_result(s, m):
        return {"metrics": {k: float(v) for k, v in m.items()},
                "state": params_from_flax(*np_tree((s.params,
                                                    s.batch_stats)))}

    def mesh_steps():
        out = {}
        for name, mesh, place in (
                ("jax_mesh", make_mesh(4), replicate_state),
                ("jax_tp", make_mesh2d(2, 2), shard_state_tp)):
            xs, ls = shard_batch(mesh, jnp.asarray(x), jnp.asarray(label))
            out[name] = vae_result(*step(place(mesh, state), xs, ls, key))
        mesh = make_mesh(4)
        xs, ls = shard_batch(mesh, jnp.asarray(x64), jnp.asarray(l64))
        out["v64_jax_mesh"] = vae_result(*step64(
            replicate_state(mesh, s64), xs, ls, k64))
        for kind, (init, run) in cnns.items():
            xs, ls = shard_batch(mesh, jnp.asarray(x),
                                 jnp.asarray(cnn_label[kind]))
            new, m = run(mesh, replicate_state, xs, ls)
            grads = cnn_params_from_flax(
                jax.tree.map(lambda a, p: np.asarray(a) - np.asarray(p),
                             new.params, init.params),
                np_tree(new.batch_stats))
            out[f"{kind}_jax_mesh"] = {
                "metrics": {k: float(v) for k, v in m.items()},
                "grads": grads}
        return out

    def sd(s):
        return params_from_flax(*np_tree((s.params, s.batch_stats)))

    def cnn_sd(s):
        return cnn_params_from_flax(*np_tree((s.params, s.batch_stats)))

    t = torch.as_tensor
    return {"sd": sd(state), "x": t(x), "label": t(label), "eps": t(eps),
            "v64_sd": sd(s64), "v64_x": t(x64), "v64_label": t(l64),
            "v64_eps": t(e64), "cnn_x": t(x),
            "cnn_sd": cnn_sd(cnns["cnn"][0]), "lam_sd": cnn_sd(cnns["lam"][0]),
            **{f"{k}_label": t(v) for k, v in cnn_label.items()},
            "lam_u": t(_jax_uniforms(lam_key, B))}, mesh_steps


def _jax_uniforms(key, n):
    """The (u1, u2) that JAX's ``stratified_shuffle`` draws from ``key``
    (tests/test_torch_lam.py)."""
    import jax

    k1, k2 = jax.random.split(key)
    return np.stack([np.asarray(jax.random.uniform(k1, (n,))),
                     np.asarray(jax.random.uniform(k2, (n,)))])


def _noise_inputs():
    rs = np.random.RandomState(5)

    def normal(*shape):
        return torch.as_tensor(rs.randn(*shape).astype(np.float32))

    eps64 = normal(2, B64, Z64 // 2)
    return {"eps3": normal(3, 2, B, 8),
            "noise_tc": (normal(2, 16, 8), normal(2, 16, 8)),
            "noise_mim": {"eps": normal(2, 16, 8),
                          "perm": torch.as_tensor(rs.permutation(16)),
                          "inner": normal(5, 16, 16)},
            "v64_noise_clear": eps64, "v64_noise_clear_bf16": eps64,
            "v64_noise_gvae": eps64,
            "v64_noise_tc": (eps64, normal(2, B64, Z64 // 2)),
            "v64_noise_mim": {"eps": eps64,
                              "perm": torch.as_tensor(rs.permutation(B64)),
                              "inner": normal(5, B64, Z64)}}


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
    for kind in CNN_CLASSES:
        ref[f"{kind}_step"] = _cnn_step(inp, None, kind)
    ref["cnn_fit"] = _cnn_fit_case(None, "cnn")
    ref["cnn_styled"] = _cnn_fit_case(None, "cnn", styled=True)
    ref["v64_step"] = _clear_step(inp, None, v64=True)
    for name in V64_FACTORIES:
        ref[f"v64_{name}"] = _v64_factory_step(name, None, inp)
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
    print(f"parallel job: {time.perf_counter() - t0:.1f} s in all, ranks' "
          f"cases {[tuple(round(t, 1) for t in r['seconds']) for r in ranks]}"
          f" s (VAE, then CNN and VAE64)")
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


def _grads_close(got, want, scale):
    """Gradients before the update at rtol 1e-5, with an atol of 1e-5 of
    the model's largest gradient entry (``scale``): an analytically zero
    gradient (the conv biases ahead of BatchNorm) is float noise."""
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w),
                                   rtol=1e-5, atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("against", ["jax_mesh", "port_single"])
@pytest.mark.parametrize("kind", list(CNN_CLASSES))
def test_cnn_dp_step_matches(job, kind, against):
    """The CNN and the LAM-CNN step on make_mesh(4) = JAX's
    ``make_*_step`` on its make_mesh(4) (LAM on JAX's own uniforms) and =
    the port's single device: the losses (rtol 1e-5), the gradients
    before Adam, summed over the ranks, and the running statistics of the
    global batch (rtol 1e-5, atol 1e-7)."""
    ranks, ref, jax_mesh, _ = job
    single = ref[f"{kind}_step"]
    names = [k for k in single["state"] if "running" not in k]
    if against == "jax_mesh":
        want = jax_mesh[f"{kind}_jax_mesh"]
        grads = {k: want["grads"][k] for k in names}
        stats = {k: v for k, v in want["grads"].items() if "running" in k}
    else:
        want = single
        grads = dict(zip(names, single["grads"]))
        stats = {k: v for k, v in single["state"].items() if "running" in k}
    scale = max(float(np.abs(np.asarray(g)).max()) for g in grads.values())
    for r in ranks:
        got = r[f"{kind}_step"]
        assert got["metrics"].keys() == want["metrics"].keys()
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                       err_msg=k)
        _grads_close(dict(zip(names, got["grads"])), grads, scale)
        for k, v in stats.items():
            np.testing.assert_allclose(got["state"][k].numpy(),
                                       np.asarray(v), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    _ranks_equal(ranks, f"{kind}_step")


def test_lam_pairs_rows_across_ranks(job):
    """The shuffle is the global batch's: each rank's x̃ is its block of
    x[perm] for the one permutation of the global labels and uniforms,
    partners share a label, and some rank's x̃ holds a row of another
    rank's block (a per-rank shuffle never does)."""
    from clearvae_torch.parallel.mesh import block
    from clearvae_torch.train.steps import stratified_perm

    ranks, _, _, inp = job
    label, x = inp["lam_label"], inp["cnn_x"]
    perm = stratified_perm(label, inp["lam_u"])
    assert torch.equal(label[perm], label)
    crossed = 0
    for r, res in enumerate(ranks):
        lo, hi = block(B, WORLD, r)
        assert torch.equal(res["lam_step"]["x_tilde"], x[perm[lo:hi]])
        crossed += int(((perm[lo:hi] < lo) | (perm[lo:hi] >= hi)).sum())
    assert crossed > 0


@pytest.mark.parametrize("kind", list(CNN_CLASSES))
def test_cnn_tp_step_matches_single_device(job, kind):
    """The CNN and LAM-CNN steps on make_mesh2d(2, 2) = the single device
    (losses rtol 1e-5, parameters after Adam at tests/test_parallel.py's
    step bar, running statistics rtol 1e-5); both model ranks end whole
    and equal. LAM's 5-class head does not divide the model axis and
    stays replicated."""
    ranks, ref, *_ = job
    want = ref[f"{kind}_step"]
    for r in ranks:
        got = r[f"{kind}_tp_step"]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                       err_msg=k)
        _step_params_close(got["state"], {k: v for k, v in
                                          want["state"].items()
                                          if "running" not in k})
        for k, v in want["state"].items():
            if "running" in k:
                np.testing.assert_allclose(got["state"][k].numpy(),
                                           v.numpy(), rtol=1e-5, atol=1e-7,
                                           err_msg=k)
    _ranks_equal(ranks, f"{kind}_tp_step")


def test_cnn_graphed_fit_equals_eager_on_the_mesh(job):
    """``get_cnn_trainer(mesh=make_mesh2d(2, 2))``: ``fit``'s default (the
    graph's body, uncaptured on the CPU) = ``use_scan=False`` bit for bit
    (histories and state; the eager trainer built no graph), and both =
    the single device's fit (losses rtol 2e-4, parameters within 8 Adam
    steps' drift at lr 1e-4) and its accuracy."""
    ranks, ref, *_ = job
    want = ref["cnn_fit"]
    for r in ranks:
        g, e = r["cnn_tp_graphed"], r["cnn_tp_eager"]
        assert g["graphs"] and not e["graphs"]
        for hg, he in zip(g["history"], e["history"]):
            for k in hg:
                np.testing.assert_array_equal(hg[k], he[k])
        for k, v in g["state"].items():
            assert torch.equal(v, e["state"][k]), k
        np.testing.assert_allclose(g["losses"], want["losses"], rtol=2e-4)
        _fit_params_close(g["state"], want["state"], 8 * 1e-4 * 2)
        assert abs(g["acc"] - want["acc"]) <= 1 / N_FIT
    _ranks_equal(ranks, "cnn_tp_graphed")


def test_styled_cnn_fit_on_the_mesh(job):
    """A SimpleCNN fit on styled digits, each rank styling its rows of
    every batch (K3's twin) inside the graph's body: the single device's
    losses and parameters; the unsharded evaluation gives every rank the
    same accuracy."""
    ranks, ref, *_ = job
    want = ref["cnn_styled"]
    for r in ranks:
        np.testing.assert_allclose(r["cnn_styled"]["losses"], want["losses"],
                                   rtol=2e-4)
        _fit_params_close(r["cnn_styled"]["state"], want["state"],
                          8 * 1e-4 * 2)
        assert abs(r["cnn_styled"]["acc"] - want["acc"]) <= 1 / N_FIT
    _ranks_equal(ranks, "cnn_styled")
    assert len({r["cnn_styled"]["acc"] for r in ranks}) == 1


def test_lam_checkpoint_resume_on_2x2(job):
    """``get_lamcnn_trainer(mesh=make_mesh2d(2, 2))``: the checkpoint of
    ``TrainerCore.state_dict`` (shards and Adam's moments gathered, the
    uniforms' generator) restored into a fresh trainer resumes as the
    uninterrupted run continued."""
    ranks, *_ = job
    for r in ranks:
        steps = r["ckpt_lam_tp"]["steps"]
        assert steps[0] == steps[1] == 3 * (N_FIT // B_FIT)
        for k, v in r["ckpt_lam_tp"]["ref"].items():
            np.testing.assert_allclose(r["ckpt_lam_tp"]["resumed"][k].numpy(),
                                       v.numpy(), atol=2e-5, rtol=2e-4,
                                       err_msg=k)


@pytest.mark.parametrize("against", ["jax_mesh", "port_single"])
def test_vae64_dp_step_matches(job, against):
    """VAE64 at z = 64 on B = 8 over make_mesh(4) (two rows a rank) = JAX's
    VAE64 make_mesh(4) step and = the port's single device, at
    tests/test_parallel.py's DP bars (loss and c_loss rtol 1e-5, the
    parameters after Adam within max(1e-3·max|a|, 1.2e-3)); against the
    single device also the gradients before Adam and the running
    statistics."""
    ranks, ref, jax_mesh, _ = job
    want = (jax_mesh["v64_jax_mesh"] if against == "jax_mesh"
            else ref["v64_step"])
    for r in ranks:
        got = r["v64_step"]
        for k in ("loss", "c_loss"):
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                       rtol=1e-5, err_msg=k)
        _step_params_close(got["state"], {k: v for k, v in
                                          want["state"].items()
                                          if "running" not in k})
        if against == "port_single":
            scale = max(float(w.abs().max()) for w in want["grads"])
            for g, w in zip(got["grads"], want["grads"]):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                           atol=1e-5 * scale)
            for k, v in want["state"].items():
                if "running" in k:
                    np.testing.assert_allclose(got["state"][k].numpy(),
                                               v.numpy(), rtol=1e-5,
                                               atol=1e-7, err_msg=k)
    _ranks_equal(ranks, "v64_step")


@pytest.mark.parametrize("name", list(V64_FACTORIES))
def test_vae64_factories_on_both_meshes(job, name):
    """Each VAE factory with ``vae_arch="VAE64"`` (z = 64; CLEAR, TC and
    MIM with the fused latent losses, K1's and K2's twins on the gathered
    heads; CLEAR also in the bf16 perf mode, bfloat16 conv stacks and
    fused heads) on make_mesh(4) and on make_mesh2d(2, 2): one step's
    metrics = the single device's (rtol 1e-5; the TC and MIM steps' 2e-4;
    bf16's one rounding of its 8-bit mantissa, 2⁻⁸: a rank's convolutions
    over its own rows round elsewhere) and its update (the 1-D leaves and
    the latent heads) within the step bar."""
    ranks, ref, *_ = job
    want = ref[f"v64_{name}"]
    rtol = {"tc": 2e-4, "mim": 2e-4, "clear_bf16": 2 ** -8}.get(name, 1e-5)
    for tag in ("dp", "tp"):
        for r in ranks:
            got = r[f"v64_{name}_{tag}"]
            assert got["metrics"].keys() == want["metrics"].keys()
            for k, v in want["metrics"].items():
                np.testing.assert_allclose(got["metrics"][k], v, rtol=rtol,
                                           err_msg=(tag, k))
            _step_params_close(got["state"], {k: v for k, v in
                                              want["state"].items()
                                              if "running" not in k})
        _ranks_equal(ranks, f"v64_{name}_{tag}")


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
