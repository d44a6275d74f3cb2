"""Fused CLEAR latent-loss kernels: CUDA for Hopper, with their plain twins.

Counterpart of ``clearvae_tpu/ops/pallas/fused_loss.py``. CUDA kernels in
``clearvae_torch/csrc/`` replace the three Pallas kernels of the CLEAR path:

- ``clear_latent_fwdgrad`` (K1, for ``_clear_fwdgrad_kernel``;
  ``clear_latent.cu``): KL_c, KL_s, SNN(mu_c), SNN or PS-SNN(mu_s) and the
  unit-cotangent SNN gradients of both halves in one cooperative launch;
  its backward, ``clear_latent_bwd`` (for ``_fused_clear_bwd``), combines
  them with the closed-form KL gradients in one elementwise launch.
- ``snn_fwd`` (K2f, for ``_fwd_kernel``; ``clear_latent.cu``): the loss of
  one half, no gradient: K1's kernel in its loss-only one-half mode, one
  cooperative launch that stops after pass A's reduction.
- ``snn_bwd`` (K2b, for ``_bwd_kernel``; ``clear_latent.cu``): g * dSNN/dmu
  of one half, K1's kernel in its one-half mode, one cooperative launch.

Each has a plain PyTorch twin here (``*_plain``) that repeats its arithmetic,
masking constants included. A wrapper launches its kernel for a CUDA tensor
(or raises) and takes the plain twin only for a CPU tensor. ``LAUNCHES``
counts kernel launches, one per wrapper call that reaches the card. A call
made while a CUDA graph is being captured launches nothing: the graph
launches the kernel on every replay, and ``counts.GraphLaunches`` moves
the count there.

Semantics equal ``vae_loss``'s KL halves and ``contrastive_loss(sim_fn=
'cosine', loss_name='snn')``; ``fused_contrastive_loss`` routes other
similarity/loss choices to the plain ``ops.losses`` path.
"""

from __future__ import annotations

import ctypes

import torch

from clearvae_torch.ops import losses as L
from clearvae_torch.utils.logging import counter

Tensor = torch.Tensor

_EPS = 1e-8        # torch cosine_similarity norm clamp
_NEG = -1e30       # masked-entry fill
_MAX_FLOOR = -1e29
_SUM_FLOOR = 1e-37
Z_MAX = 64         # the kernels keep a row of mu in registers

LAUNCHES = counter("launches.fused_loss", (
    "clear_latent_fwdgrad", "clear_latent_bwd", "snn_fwd", "snn_bwd"))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain twins (the CPU path, and what the kernels are held to on the card)
# ---------------------------------------------------------------------------


def _row_stats_plain(mu: Tensor, label: Tensor, temperature: float, ps: bool):
    """Row-normalized mu, S = cos/tau, masks, and both masked logsumexps."""
    n = mu.shape[0]
    r = torch.sqrt((mu * mu).sum(1, keepdim=True))
    r_c = r.clamp_min(_EPS)
    mu_n = mu / r_c
    s = (mu_n @ mu_n.T) / temperature
    same = label[:, None] == label[None, :]
    valid = ~torch.eye(n, dtype=torch.bool, device=mu.device)
    pos = (~same if ps else same) & valid

    def lse_softmax(mask):
        sm = torch.where(mask, s, torch.full_like(s, _NEG))
        m = sm.amax(1, keepdim=True).clamp_min(_MAX_FLOOR)
        e = torch.where(mask, torch.exp(sm - m), torch.zeros_like(s))
        ssum = e.sum(1, keepdim=True).clamp_min(_SUM_FLOOR)
        return torch.log(ssum) + m, e / ssum

    lse_all, p_all = lse_softmax(valid)
    lse_pos, p_pos = lse_softmax(pos)
    row_ok = pos.any(1, keepdim=True)
    n_finite = row_ok.sum().clamp_min(1).to(mu.dtype)
    return r, r_c, mu_n, lse_all, p_all, lse_pos, p_pos, row_ok, n_finite


def snn_fwd_plain(mu: Tensor, label: Tensor, temperature: float,
                  ps: bool) -> Tensor:
    """Plain twin of K2f: the SNN / PS-SNN loss, mean over rows with a
    positive pair."""
    _, _, _, lse_all, _, lse_pos, _, row_ok, n_finite = _row_stats_plain(
        mu, label, temperature, ps)
    rows = torch.where(row_ok, -lse_pos + lse_all, torch.zeros_like(lse_all))
    return rows.sum() / n_finite


def snn_bwd_plain(mu: Tensor, label: Tensor, g: Tensor, temperature: float,
                  ps: bool) -> Tensor:
    """Plain twin of K2b: g * dSNN/dmu through the softmax difference, the
    (G + Gᵀ) mu_n product and the normalization projection."""
    r, r_c, mu_n, _, p_all, _, p_pos, row_ok, n_finite = _row_stats_plain(
        mu, label, temperature, ps)
    G = row_ok.to(mu.dtype) * (p_all - p_pos) / (temperature * n_finite)
    dmu_n = (G + G.T) @ mu_n
    inner = (dmu_n * mu_n).sum(1, keepdim=True)
    proj = torch.where(r > _EPS, inner, torch.zeros_like(inner))
    return g * (dmu_n - proj * mu_n) / r_c


def clear_latent_plain(mu_c, lv_c, mu_s, lv_s, label, temperature: float,
                       ps: bool):
    """Plain twin of K1: ([kl_c, kl_s, c_loss, s_loss], dsnn_c, dsnn_s)."""
    b = mu_c.shape[0]
    kl_c = -0.5 * (1 + lv_c - mu_c * mu_c - torch.exp(lv_c)).sum() / b
    kl_s = -0.5 * (1 + lv_s - mu_s * mu_s - torch.exp(lv_s)).sum() / b
    one = torch.ones((), dtype=mu_c.dtype, device=mu_c.device)
    c_loss = snn_fwd_plain(mu_c, label, temperature, False)
    s_loss = snn_fwd_plain(mu_s, label, temperature, ps)
    dsnn_c = snn_bwd_plain(mu_c, label, one, temperature, False)
    dsnn_s = snn_bwd_plain(mu_s, label, one, temperature, ps)
    return torch.stack([kl_c, kl_s, c_loss, s_loss]), dsnn_c, dsnn_s


def clear_latent_bwd_plain(mu_c, lv_c, mu_s, lv_s, dsnn_c, dsnn_s, g):
    """Plain twin of K1's backward (``_fused_clear_bwd``): the cotangent
    g = [g_kl_c, g_kl_s, g_c, g_s] of the four terms combined with the SNN
    gradients and the closed-form KL ones: (dmu_c, dlv_c, dmu_s, dlv_s)."""
    b = mu_c.shape[0]
    g_klc, g_kls, g_c, g_s = g.unbind()
    dmu_c = g_klc * mu_c / b + g_c * dsnn_c
    dlv_c = g_klc * (-0.5) * (1.0 - torch.exp(lv_c)) / b
    dmu_s = g_kls * mu_s / b + g_s * dsnn_s
    dlv_s = g_kls * (-0.5) * (1.0 - torch.exp(lv_s)) / b
    return dmu_c, dlv_c, dmu_s, dlv_s


# ---------------------------------------------------------------------------
# kernel launchers (CUDA tensors only)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the extern "C" functions of each csrc/<source>.cu that a wrapper calls
_SIGNATURES = {
    "clear_latent": {
        "clear_latent_config": [_I, _I, ctypes.POINTER(_I)],
        "clear_latent_fwdgrad": [_P] * 5 + [_I, _I, _F, _I] + [_P] * 6,
        "clear_latent_bwd": [_P] * 7 + [_I, _I] + [_P] * 5,
        "snn_fwd": [_P] * 2 + [_I, _I, _F, _I] + [_P] * 3,
        "snn_bwd": [_P] * 3 + [_I, _I, _F, _I] + [_P] * 4,
    },
}
_fns: dict = {}     # name -> typed ctypes function, resolved at first use


def _fn(name: str):
    if name not in _fns:
        from clearvae_torch.ops.kernels import _build

        for source, sigs in _SIGNATURES.items():
            if name in sigs:
                fn = getattr(_build.load(source), name)
                fn.argtypes, fn.restype = sigs[name], ctypes.c_int
                _fns[name] = fn
    return _fns[name]


def _check_inputs(label: Tensor, *mats: Tensor):
    b, z = mats[0].shape
    for m in mats:
        if m.device != mats[0].device or m.shape != (b, z):
            raise ValueError("latent inputs must share one device and a "
                             f"[B, z] shape; got {m.shape} on {m.device}")
    if mats[0].device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {mats[0].device}")
    if z > Z_MAX:
        raise ValueError(f"the fused kernels take z <= {Z_MAX}; got {z}")
    if label.shape != (b,):
        raise ValueError(f"label must be [B]={b}; got {tuple(label.shape)}")
    return b, z


def _f32(t: Tensor) -> Tensor:
    """t as contiguous float32 for a kernel's pointer; no new tensor (host
    time is what a step pays) when it already is."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.detach().to(torch.float32).contiguous()


def _run(name: str, *args) -> None:
    err = _fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def clear_latent_grid(b: int, z: int) -> dict:
    """K1's launch shape for (B, z) on the current CUDA device: CTAs per half
    ``T``, columns per tile ``TJ``, ``tiles`` and ``smem`` bytes per CTA."""
    out = (_I * 4)()
    err = _fn("clear_latent_config")(b, z, out)
    if err != 0:
        raise RuntimeError(f"clear_latent_config({b}, {z}) failed: "
                           f"cudaError {err}")
    return dict(zip(("T", "TJ", "tiles", "smem"), out))


def clear_latent_fwdgrad(mu_c, lv_c, mu_s, lv_s, label, temperature: float,
                         ps: bool):
    """K1: ([kl_c, kl_s, c_loss, s_loss], dsnn_c, dsnn_s). On a card, one
    launch; the outputs and the kernel's scratch are views of one buffer."""
    b, z = _check_inputs(label, mu_c, lv_c, mu_s, lv_s)
    if mu_c.device.type == "cpu":
        return clear_latent_plain(*(t.detach() for t in (mu_c, lv_c, mu_s, lv_s)),
                                  label, temperature, ps)
    dev = mu_c.device
    ins = [_f32(t) for t in (mu_c, lv_c, mu_s, lv_s)]
    lbl = label.to(device=dev, dtype=torch.int64).contiguous()
    # one buffer: [partial sums: 2 halves x ceil(B/32) CTAs x 3 doubles |
    #  out4 | exchange: 2 halves x 3 x round_up(B, 4) | dsnn_c | dsnn_s]
    sizes = [12 * -(-b // 32), 4, 6 * -(-b // 4) * 4, b * z, b * z]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    part, out, ex, dsnn_c, dsnn_s = buf.split(sizes)
    _run("clear_latent_fwdgrad", *(t.data_ptr() for t in ins), lbl.data_ptr(),
         b, z, float(temperature), int(bool(ps)), out.data_ptr(),
         dsnn_c.data_ptr(), dsnn_s.data_ptr(), ex.data_ptr(), part.data_ptr(),
         _stream(dev))
    return out, dsnn_c.view(b, z), dsnn_s.view(b, z)


def clear_latent_bwd(mu_c, lv_c, mu_s, lv_s, dsnn_c, dsnn_s, g):
    """K1's backward: (dmu_c, dlv_c, dmu_s, dlv_s) for the cotangent ``g``
    [4] of the four terms; on a card one launch that reads ``g`` there."""
    if mu_c.device.type == "cpu":
        return clear_latent_bwd_plain(mu_c, lv_c, mu_s, lv_s, dsnn_c, dsnn_s, g)
    b, z = mu_c.shape
    ins = [_f32(t) for t in (mu_c, lv_c, mu_s, lv_s, dsnn_c, dsnn_s)]
    gg = _f32(g.reshape(4))
    out = torch.empty((4, b, z), dtype=torch.float32,
                      device=mu_c.device).unbind()
    _run("clear_latent_bwd", *(t.data_ptr() for t in ins), gg.data_ptr(), b, z,
         *(o.data_ptr() for o in out), _stream(mu_c.device))
    return out


def snn_fwd(mu: Tensor, label: Tensor, temperature: float, ps: bool) -> Tensor:
    """K2f: the SNN / PS-SNN loss of one half (0-d tensor). On a card, one
    launch; the output and the kernel's scratch are views of one buffer."""
    b, z = _check_inputs(label, mu)
    if mu.device.type == "cpu":
        return snn_fwd_plain(mu.detach(), label, temperature, ps)
    dev = mu.device
    m = _f32(mu)
    lbl = label.to(device=dev, dtype=torch.int64).contiguous()
    # one buffer: [partial sums: ceil(B/32) CTAs x 3 doubles | loss]
    sizes = [6 * -(-b // 32), 1]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    part, out = buf.split(sizes)
    _run("snn_fwd", m.data_ptr(), lbl.data_ptr(), b, z, float(temperature),
         int(bool(ps)), out.data_ptr(), part.data_ptr(), _stream(dev))
    return out[0]


def snn_bwd(mu: Tensor, label: Tensor, g: Tensor, temperature: float,
            ps: bool) -> Tensor:
    """K2b: g * dSNN/dmu of one half; ``g`` is a 0-d tensor on mu's device,
    read there by the kernel. On a card, one launch; the output and the
    kernel's scratch are views of one buffer."""
    b, z = _check_inputs(label, mu)
    if mu.device.type == "cpu":
        return snn_bwd_plain(mu.detach(), label, g, temperature, ps)
    dev = mu.device
    m, gg = _f32(mu), _f32(g.reshape(1))
    lbl = label.to(device=dev, dtype=torch.int64).contiguous()
    # one buffer: [partial sums: ceil(B/32) CTAs x 3 doubles |
    #  exchange: 3 x round_up(B, 4) | dmu]
    sizes = [6 * -(-b // 32), 3 * -(-b // 4) * 4, b * z]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    part, ex, dmu = buf.split(sizes)
    _run("snn_bwd", m.data_ptr(), lbl.data_ptr(), gg.data_ptr(), b, z,
         float(temperature), int(bool(ps)), dmu.data_ptr(), ex.data_ptr(),
         part.data_ptr(), _stream(dev))
    return dmu.view(b, z)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _FusedClear(torch.autograd.Function):
    """K1 forward emits the SNN gradients; its backward kernel combines them
    with the closed-form KL gradients (``_fused_clear_bwd`` of the JAX
    package)."""

    @staticmethod
    def forward(ctx, mu_c, lv_c, mu_s, lv_s, label, temperature, ps):
        out, dsnn_c, dsnn_s = clear_latent_fwdgrad(mu_c, lv_c, mu_s, lv_s,
                                                   label, temperature, ps)
        ctx.save_for_backward(mu_c, lv_c, mu_s, lv_s, dsnn_c, dsnn_s)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*clear_latent_bwd(*ctx.saved_tensors, g), None, None, None)


class _FusedSNN(torch.autograd.Function):
    """K2f forward, K2b backward."""

    @staticmethod
    def forward(ctx, mu, label, temperature, ps):
        ctx.save_for_backward(mu, label)
        ctx.temperature, ctx.ps = temperature, ps
        return snn_fwd(mu, label, temperature, ps)

    @staticmethod
    def backward(ctx, g):
        mu, label = ctx.saved_tensors
        return snn_bwd(mu, label, g, ctx.temperature, ctx.ps), None, None, None


def fused_clear_latent_loss(mu_c: Tensor, logvar_c: Tensor, mu_s: Tensor,
                            logvar_s: Tensor, label: Tensor, *,
                            temperature: float = 0.1, ps: bool = True):
    """(kl_c, kl_s, snn(mu_c), snn/ps-snn(mu_s)) from one K1 call.

    The caller negates the style term when ``ps=False`` (reference
    trainer.py:463-472). Every call pays for the gradient pass, so a
    forward-only caller uses ``fused_contrastive_loss`` instead.
    """
    out = _FusedClear.apply(mu_c, logvar_c, mu_s, logvar_s, label,
                            float(temperature), bool(ps))
    return tuple(out.unbind())


def fused_contrastive_loss(mu: Tensor, logvar: Tensor, label: Tensor, *,
                           sim_fn: str = "cosine", temperature: float = 0.1,
                           loss_name: str = "snn", ps: bool = False) -> Tensor:
    """Drop-in for :func:`clearvae_torch.ops.losses.contrastive_loss`: the
    K2f/K2b kernels for cosine/snn, the plain path otherwise."""
    if sim_fn == "cosine" and loss_name == "snn":
        return _FusedSNN.apply(mu, label, float(temperature), bool(ps))
    return L.contrastive_loss(mu, logvar, label, sim_fn=sim_fn,
                              temperature=temperature, loss_name=loss_name,
                              ps=ps)
