"""Weight bridge: the JAX package's flax variables → state dicts of the
port's modules of the same names (``VAE`` and ``VAE64``, ``ProbeMLP``,
``FactorCls``, the MI estimators, ``SimpleCNN``, ``SimpleCNN64`` and the
LAM classifiers).

Takes the variables as nested dicts of numpy arrays (``params`` and
``batch_stats``), so it needs no JAX import. The map (after
scripts/reference_twin.py:67-140, without its flatten permutation: the port
flattens in flax's (H, W, C) order):

- Conv kernels HWIO → OIHW;
- ConvTranspose kernels (3×3, and VAE64's 4×4) flip(h, w) then HWIO →
  IOHW: the JAX layer is a cross-correlation over the lhs-dilated input,
  torch's ConvTranspose2d applies its kernel unflipped in the output
  domain;
- Dense kernels [in, out] → Linear weights [out, in];
- BatchNorm scale/bias → weight/bias, batch_stats mean/var → running stats.
"""

from __future__ import annotations

import numpy as np
import torch


def _dense(sd, prefix, d):
    sd[f"{prefix}.weight"] = np.asarray(d["kernel"]).T
    sd[f"{prefix}.bias"] = np.asarray(d["bias"])


def _bn(sd, prefix, p, s):
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])
    sd[f"{prefix}.running_mean"] = np.asarray(s["mean"])
    sd[f"{prefix}.running_var"] = np.asarray(s["var"])


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}


def _conv_stack(sd, prefix, p, s) -> set:
    """A ``ConvBNReluStack``'s convs and BatchNorms; returns the flax names
    it mapped."""
    used = set()
    n_conv = sum(k.startswith("BatchNorm_") for k in p)
    # with first_conv_pack the first conv is Conv1MXUPack_0 (same kernel
    # shape) and flax numbers the remaining ConvTorch modules from 0
    packed = "Conv1MXUPack_0" in p
    for i in range(n_conv):
        if packed and i == 0:
            conv, name = p["Conv1MXUPack_0"], "Conv1MXUPack_0"
        else:
            name = f"ConvTorch_{i - packed}"
            conv = p[name]["Conv_0"]
        sd[f"{prefix}.convs.{i}.weight"] = np.asarray(conv["kernel"]).transpose(
            3, 2, 0, 1)
        sd[f"{prefix}.convs.{i}.bias"] = np.asarray(conv["bias"])
        _bn(sd, f"{prefix}.bns.{i}", p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"])
        used |= {name, f"BatchNorm_{i}"}
    return used


def params_from_flax(params: dict, batch_stats: dict) -> dict:
    """State dict of ``clearvae_torch.models.vae.VAE`` from the JAX
    package's ``VAE`` variables. Raises if a flax parameter is left
    unmapped."""
    sd: dict = {}
    enc = params["encoder"]
    used = {("encoder", k) for k in _conv_stack(sd, "encoder", enc,
                                                batch_stats["encoder"])}
    used.add(("encoder",))

    heads = ("latent_heads",) if "latent_heads" in params else (
        "mu_c_head", "logvar_c_head", "mu_s_head", "logvar_s_head")
    for h in heads:
        _dense(sd, h, params[h]["Dense_0"])
        used.add((h,))

    dec, dec_s = params["decoder"], batch_stats["decoder"]
    _dense(sd, "decoder.dense", dec["DenseTorch_0"]["Dense_0"])
    n_ct = sum(k.startswith("ConvTransposeTorch_") for k in dec)
    for i in range(n_ct):
        k = np.asarray(dec[f"ConvTransposeTorch_{i}"]["kernel"])
        sd[f"decoder.convts.{i}.weight"] = k[::-1, ::-1].transpose(2, 3, 0, 1)
        sd[f"decoder.convts.{i}.bias"] = np.asarray(
            dec[f"ConvTransposeTorch_{i}"]["bias"])
    for i in range(n_ct + 1):
        _bn(sd, f"decoder.bns.{i}", dec[f"BatchNorm_{i}"],
            dec_s[f"BatchNorm_{i}"])
    used.add(("decoder",))
    left = [k for k in params if (k,) not in used]
    left += [f"encoder/{k}" for k in enc if ("encoder", k) not in used]
    left += [f"decoder/{k}" for k in dec
             if not (k == "DenseTorch_0" or k.startswith("ConvTransposeTorch_")
                     or k.startswith("BatchNorm_"))]
    if left:
        raise ValueError(f"flax parameters left unmapped: {sorted(left)}")
    return _tensors(sd)


def probe_params_from_flax(params: dict, batch_stats: dict) -> dict:
    """State dict of ``clearvae_torch.models.mlp.ProbeMLP`` from the JAX
    package's ``ProbeMLP`` variables."""
    if sorted(params) != ["BatchNorm_0", "DenseTorch_0", "DenseTorch_1"]:
        raise ValueError(f"not a ProbeMLP's parameters: {sorted(params)}")
    sd: dict = {}
    _dense(sd, "dense_0", params["DenseTorch_0"]["Dense_0"])
    _bn(sd, "bn", params["BatchNorm_0"], batch_stats["BatchNorm_0"])
    _dense(sd, "dense_1", params["DenseTorch_1"]["Dense_0"])
    return _tensors(sd)


def factor_params_from_flax(params: dict) -> dict:
    """State dict of ``clearvae_torch.models.factor.FactorCls`` from the JAX
    package's ``FactorCls`` params."""
    if sorted(params) != ["DenseTorch_0", "DenseTorch_1"]:
        raise ValueError(f"not a FactorCls's parameters: {sorted(params)}")
    sd: dict = {}
    for i in range(2):
        _dense(sd, f"dense_{i}", params[f"DenseTorch_{i}"]["Dense_0"])
    return _tensors(sd)


def mi_params_from_flax(params: dict) -> dict:
    """State dict of an estimator of ``clearvae_torch.models.mi_estimators``
    from the JAX package's estimator of the same name: its submodules carry
    the flax names (``net.mu_l1``, ``mu_out``, ``f_l1``, ...), each a
    ``DenseTorch``."""
    sd: dict = {}

    def walk(tree, path):
        for k, v in tree.items():
            if k == "Dense_0":
                _dense(sd, ".".join(path), v)
            elif isinstance(v, dict):
                walk(v, path + (k,))
            else:
                raise ValueError(f"not a DenseTorch parameter: {path + (k,)}")

    walk(params, ())
    return _tensors(sd)


def cnn_params_from_flax(params: dict, batch_stats: dict) -> dict:
    """State dict of a ``clearvae_torch.models.cnn`` classifier from the
    JAX package's variables of the same class: ``SimpleCNN`` /
    ``SimpleCNN64`` (hidden Linear + BN + output Linear) or ``LAMCNN`` /
    ``LAMCNN64`` (the linear ``cls_head``)."""
    heads = {("hidden", "hidden_bn", "net", "out"), ("cls_head", "net")}
    if tuple(sorted(params)) not in heads:
        raise ValueError(f"not a SimpleCNN's or LAMCNN's parameters: "
                         f"{sorted(params)}")
    sd: dict = {}
    used = _conv_stack(sd, "net", params["net"], batch_stats["net"])
    if used != set(params["net"]):
        raise ValueError("flax parameters left unmapped: "
                         f"{sorted(set(params['net']) - used)}")
    if "cls_head" in params:
        _dense(sd, "cls_head", params["cls_head"]["Dense_0"])
        return _tensors(sd)
    _dense(sd, "hidden", params["hidden"]["Dense_0"])
    _bn(sd, "hidden_bn", params["hidden_bn"], batch_stats["hidden_bn"])
    _dense(sd, "out", params["out"]["Dense_0"])
    return _tensors(sd)


def _adam_moments(opt_state):
    """optax.adam's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside
    an optimizer state (a chain's tuple of states)."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_moments(s)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state, params_map, names) -> dict:
    """The ``state`` of a torch Adam ``state_dict`` from optax.adam's state.

    ``params_map`` maps a tree shaped like the flax params to the module's
    state dict (e.g. ``lambda p: params_from_flax(p, batch_stats)``): the
    moments are laid out as the parameters are, so they map the same way.
    ``names`` are the module's parameter names in ``parameters()`` order,
    the order of the optimizer's state indices. optax's ``count`` is
    torch's per-parameter ``step``."""
    adam = _adam_moments(opt_state)
    if adam is None:
        raise ValueError("no optax ScaleByAdamState in the optimizer state")
    mu, nu = params_map(adam.mu), params_map(adam.nu)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    return {i: {"step": step.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
            for i, n in enumerate(names)}


def trainer_state_from_flax(state, trainer) -> dict:
    """A JAX ``TrainState`` (params, batch_stats, opt_state, step, and the
    second player's aux_params / aux_opt_state where there is one) as the
    port trainer's ``state_dict()``, for ``trainer.load_state_dict``:
    weights, Adam's moments and counts, and the update count. The optimizers'
    hyperparameters (their ``param_groups``) and the noise generator's state
    are the trainer's own. ``state``'s leaves are numpy arrays. The model
    is a VAE (28×28 or 64×64) or a CNN classifier (``net`` trunk)."""
    batch_stats = state.batch_stats
    model_map = cnn_params_from_flax if "net" in state.params \
        else params_from_flax
    maps = {"model": lambda p: model_map(p, batch_stats),
            "factor_cls": factor_params_from_flax,
            "mi_estimator": mi_params_from_flax}
    flax = {"model": (state.params, state.opt_state),
            "factor_cls": (state.aux_params, state.aux_opt_state),
            "mi_estimator": (state.aux_params, state.aux_opt_state)}
    out = trainer.state_dict()
    for module, opt in zip(trainer.MODULES, trainer.OPTIMIZERS):
        params, opt_state = flax[module]
        sd = maps[module](params)
        out["modules"][module] = {**out["modules"][module], **sd}
        names = [n for n, _ in getattr(trainer, module).named_parameters()]
        out["optimizers"][opt] = {
            "state": adam_state_from_optax(opt_state, maps[module], names),
            "param_groups": out["optimizers"][opt]["param_groups"]}
    out["step"] = torch.tensor(int(np.asarray(state.step)), dtype=torch.int64)
    return out
