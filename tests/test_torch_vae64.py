"""The 64×64 models of the port against the JAX package's through the
weight bridge: ``VAE64`` in train and eval mode (plain and GVAE / ML-VAE
grouped, float32), its 4×4 transposed convolution at every decoder stage,
the bfloat16 perf-mode ``VAE64`` against JAX's bfloat16 one, and the
``SimpleCNN64``, ``LAMCNN`` and ``LAMCNN64`` classifiers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearvae_tpu.models import cnn as JC
from clearvae_tpu.models.layers import ConvTransposeTorch
from clearvae_tpu.models.vae import VAE64 as JVAE64
from clearvae_torch.bridge import cnn_params_from_flax, params_from_flax
from clearvae_torch.models import cnn as TC
from clearvae_torch.models.layers import conv_transpose2d
from clearvae_torch.models.vae import VAE64 as TVAE64

B, Z = 4, 64
ATOL = 1e-4          # float32 forward, the bar the issue sets for VAE64
# bfloat16 against bfloat16: the two frameworks round at other points
# (cuDNN / oneDNN accumulate a bf16 conv in float32 and round once, XLA on
# the CPU rounds its own way), so outputs in (0, 1) and latent heads of
# order 1 differ by a few bf16 steps (2^-8 = 0.0039 relative): 3e-2 is
# about eight of them.
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: these small CPU workloads run several to a
    machine under the parallel test run, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def vae64_variables():
    jm = JVAE64(total_z_dim=Z)
    # a jitted init compiles once instead of op by op
    v = jax.jit(jm.init)({"params": jax.random.key(0),
                          "reparam": jax.random.key(1)},
                         jnp.zeros((B, 64, 64, 3)))
    rs = np.random.RandomState(7)
    # running statistics away from their init, so eval mode reads them
    stats = jax.tree.map(lambda a: (rs.rand(*a.shape) * 0.5 + 0.2)
                         .astype(np.float32), _np_tree(v["batch_stats"]))
    return _np_tree(v["params"]), stats


def _jit_apply(jm, variables, x, train, **kw):
    """((x_hat, latent params, z), mutated batch_stats) of a jitted
    ``explicit=True`` forward (one compile instead of op-by-op dispatch)."""

    def fwd(variables, x, kw):
        return jm.apply(variables, x, explicit=True, train=train,
                        rngs={"reparam": jax.random.key(5)},
                        mutable=["batch_stats"] if train else [], **kw)

    return jax.jit(fwd)(variables, x, kw)


def _recover_eps(lp, z, label):
    """The (eps_c, eps_s) flax drew, from z and the posterior it drew from
    (per sample: the group's row when grouped)."""
    z = np.asarray(z)
    mu_c, lv_c = np.asarray(lp["mu_c"]), np.asarray(lp["logvar_c"])
    if label is not None:
        mu_c, lv_c = mu_c[label], lv_c[label]
    eps_c = (z[:, :Z // 2] - mu_c) / np.exp(0.5 * lv_c)
    eps_s = (z[:, Z // 2:] - np.asarray(lp["mu_s"])) / np.exp(
        0.5 * np.asarray(lp["logvar_s"]))
    return [torch.as_tensor(eps_c), torch.as_tensor(eps_s)]


@pytest.mark.parametrize("group_mode", [None, "GVAE", "MLVAE"])
@pytest.mark.parametrize("train", [True, False])
def test_vae64_forward_matches_flax(vae64_variables, group_mode, train):
    """``explicit=True``'s (x_hat, latent params, z), and the running
    statistics after a train-mode forward, at atol 1e-4."""
    params, stats = vae64_variables
    jm = JVAE64(total_z_dim=Z, group_mode=group_mode, n_classes=4)
    tm = TVAE64(total_z_dim=Z, group_mode=group_mode, n_classes=4)
    tm.load_state_dict(params_from_flax(params, stats))
    rs = np.random.RandomState(3)
    x = rs.rand(B, 64, 64, 3).astype(np.float32)
    label = np.array([0, 1, 0, 3]) if group_mode else None
    kw = {"label": jnp.asarray(label)} if group_mode else {}
    (jx_hat, jlp, jz), muts = _jit_apply(
        jm, {"params": params, "batch_stats": stats}, jnp.asarray(x), train,
        **kw)
    eps = _recover_eps(jlp, jz, label)
    with torch.no_grad():
        x_hat, lp, z = tm(torch.as_tensor(x), train=train, eps=eps,
                          label=None if label is None else torch.as_tensor(label))
    assert x_hat.shape == (B, 64, 64, 3) and x_hat.dtype == torch.float32
    np.testing.assert_allclose(x_hat.numpy(), np.asarray(jx_hat), atol=ATOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=ATOL)
    assert set(lp) == set(jlp)
    for k in jlp:
        np.testing.assert_allclose(lp[k].numpy(), np.asarray(jlp[k]),
                                   atol=ATOL, err_msg=k)
    if train:
        want = params_from_flax(params, _np_tree(muts["batch_stats"]))
        for k, v in tm.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("spatial,cin,cout", [(2, 24, 16), (4, 16, 12),
                                              (8, 12, 8), (16, 8, 6),
                                              (32, 6, 3)])
def test_convtranspose_4x4_matches_flax_at_every_stage(spatial, cin, cout):
    """VAE64's ConvTranspose (k=4, s=2, p=1, op=0) at each decoder stage's
    input size, 2 → 4 → … → 64, through the bridge's flip: JAX's
    lhs-dilated convolution against torch's ConvTranspose2d."""
    jl = ConvTransposeTorch(cout, 4, 2, 1, 0)
    x = np.random.RandomState(spatial).randn(2, spatial, spatial,
                                             cin).astype(np.float32)
    v = jax.jit(jl.init)(jax.random.key(spatial), jnp.asarray(x))
    v = {"params": {"kernel": _np_tree(v["params"]["kernel"]),
                    "bias": np.random.RandomState(1).randn(cout)
                    .astype(np.float32)}}
    want = np.asarray(jax.jit(jl.apply)(v, jnp.asarray(x)))
    tl = conv_transpose2d(cin, cout, 4, 2, 1, 0)
    k = v["params"]["kernel"]
    with torch.no_grad():
        tl.weight.copy_(torch.as_tensor(k[::-1, ::-1].transpose(2, 3, 0, 1)
                                        .copy()))
        tl.bias.copy_(torch.as_tensor(v["params"]["bias"]))
        got = tl(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (2, 2 * spatial, 2 * spatial, cout)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_vae64_bf16_fused_heads_matches_jax_bf16(train):
    """The perf mode's model, ``dtype`` bfloat16 with fused heads, against
    JAX's: the conv stacks compute in bfloat16 from float32 parameters,
    the heads and the reconstruction are float32 (BF16_TOL)."""
    jm = JVAE64(total_z_dim=Z, dtype=jnp.bfloat16, fused_heads=True)
    v = jax.jit(jm.init)({"params": jax.random.key(2),
                          "reparam": jax.random.key(1)},
                         jnp.zeros((B, 64, 64, 3)))
    params, stats = _np_tree(v["params"]), _np_tree(v["batch_stats"])
    tm = TVAE64(total_z_dim=Z, dtype=torch.bfloat16, fused_heads=True)
    tm.load_state_dict(params_from_flax(params, stats))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    x = np.random.RandomState(4).rand(B, 64, 64, 3).astype(np.float32)
    (jx_hat, jlp, jz), _ = _jit_apply(
        jm, {"params": params, "batch_stats": stats}, jnp.asarray(x), train)
    eps = _recover_eps(jlp, jz, None)
    with torch.no_grad():
        x_hat, lp, _ = tm(torch.as_tensor(x), train=train, eps=eps)
    assert x_hat.dtype == torch.float32 and lp["mu_c"].dtype == torch.float32
    assert all(b.dtype == torch.float32 for b in tm.buffers())
    np.testing.assert_allclose(x_hat.numpy(), np.asarray(jx_hat), **BF16_TOL)
    for k in jlp:
        np.testing.assert_allclose(lp[k].numpy(), np.asarray(jlp[k]),
                                   **BF16_TOL, err_msg=k)


@pytest.mark.parametrize("name,size,n_class", [
    ("SimpleCNN64", 64, 4), ("LAMCNN", 28, 10), ("LAMCNN64", 64, 7)])
def test_cnn_logits_match_flax_in_train_and_eval(name, size, n_class):
    """Logits in both modes and the running statistics after the
    train-mode pass, at B = 8 (rtol 1e-5, atol 2e-5, the bars of
    ``test_torch_cnn.py``); the LAM head weight is the JAX one's."""
    in_ch = 1 if size == 28 else 3
    b = 8
    jm = getattr(JC, name)(n_class=n_class, in_channel=in_ch)
    v = jax.jit(jm.init)({"params": jax.random.key(0)},
                         jnp.zeros((b, size, size, in_ch)))
    rs = np.random.RandomState(0)
    params = _np_tree(v["params"])
    stats = jax.tree.map(lambda a: (rs.rand(*a.shape) * 0.5 + 0.2)
                         .astype(np.float32), _np_tree(v["batch_stats"]))
    tm = getattr(TC, name)(n_class=n_class, in_channel=in_ch)
    tm.load_state_dict(cnn_params_from_flax(params, stats))
    x = rs.rand(b, size, size, in_ch).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    jeval = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    jtrain, muts = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.as_tensor(x), train=False).numpy(),
                                   np.asarray(jeval), rtol=1e-5, atol=2e-5)
        np.testing.assert_allclose(tm(torch.as_tensor(x), train=True).numpy(),
                                   np.asarray(jtrain), rtol=1e-5, atol=2e-5)
    want = cnn_params_from_flax(params, _np_tree(muts["batch_stats"]))
    for k, val in tm.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(val.numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    if name.startswith("LAM"):
        np.testing.assert_array_equal(TC.lam_head_weight(tm).detach().numpy(),
                                      np.asarray(JC.lam_head_weight(params)))


@pytest.mark.parametrize("kind", ["vae64", "lam_cnn64"])
def test_trainer_state_from_flax_maps_vae64_and_lam_cnn64(kind):
    """A JAX TrainState of each kind (its shapes from ``jax.eval_shape``,
    filled from a seed) bridged into the port trainer of the same factory:
    every parameter and buffer, Adam's moments in parameter order, its
    count and the update count land where ``params_from_flax`` /
    ``cnn_params_from_flax`` put them."""
    from clearvae_tpu.train import factories as JF
    from clearvae_torch.bridge import trainer_state_from_flax
    from clearvae_torch.train import factories as TF

    if kind == "vae64":
        kw = dict(beta=1 / 32, ps=True, vae_lr=3e-5, z_dim=Z, alpha=100.0,
                  temperature=0.1, vae_arch="VAE64", in_channel=3)
        jt = JF.get_clearvae_trainer(**kw, mig_backend="numpy")
        tt = TF.get_clearvae_trainer(**kw, mig_backend="numpy", device="cpu")
        to_sd = params_from_flax
    else:
        kw = dict(n_class=2, lam_coef=0.001, cnn_arch="LAMCNN64Classifier",
                  in_channel=3)
        jt, tt = JF.get_lamcnn_trainer(**kw), TF.get_lamcnn_trainer(
            **kw, device="cpu")
        to_sd = cnn_params_from_flax
    rs = np.random.RandomState(0)
    state = jax.tree.map(
        lambda a: (rs.rand(*a.shape) + 0.5).astype(a.dtype)
        if np.issubdtype(a.dtype, np.floating) else np.full(a.shape, 7, a.dtype),
        jax.eval_shape(jt._init_state))
    tt.load_state_dict(trainer_state_from_flax(state, tt))
    want = to_sd(state.params, state.batch_stats)
    for k, v in tt.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    adam = tt.optimizer.state_dict()["state"]
    mu = to_sd(state.opt_state[0].mu, state.batch_stats)
    for i, (name, _) in enumerate(tt.model.named_parameters()):
        np.testing.assert_array_equal(adam[i]["exp_avg"].numpy(),
                                      mu[name].numpy(), err_msg=name)
        assert float(adam[i]["step"]) == 7
    assert tt.train_step.step == 7
