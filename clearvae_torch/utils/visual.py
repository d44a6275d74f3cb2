"""Latent-space visualization: swapping grids, interpolation strips, t-SNE
(counterpart of ``clearvae_tpu/utils/visual.py``; reference
code/src/utils/display_utils.py, code/expr/visual_utils.py).

The latent arithmetic runs in torch on the latents' device; the grids are
numpy, NHWC in [0, 1], with torchvision's ``make_grid`` re-implemented.
Functions return image arrays and save PNGs when a path is given, so they
work headless: PIL writes the grids. matplotlib and sklearn are imported
inside ``tsne_plot``, the one function here that needs them;
``missing_packages`` tells an entry point which of them a machine lacks.
"""

from __future__ import annotations

import importlib.util

import numpy as np
import torch


def missing_packages(*names: str) -> list[str]:
    """Those of the named host packages that are not installed."""
    return [n for n in names if importlib.util.find_spec(n) is None]


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def interpolate_latent(latent1: torch.Tensor, latent2: torch.Tensor,
                       num_steps: int) -> torch.Tensor:
    """Linear interpolation matrix [num_steps, z] (reference
    display_utils.py:11-21: p runs 1→0 so row 0 is latent1)."""
    p = torch.linspace(1.0, 0.0, num_steps, dtype=latent1.dtype,
                       device=latent1.device)[:, None]
    return p * latent1[None, :] + (1 - p) * latent2[None, :]


def make_grid(imgs: np.ndarray, nrow: int, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """torchvision.utils.make_grid for NHWC numpy arrays → [H', W', 3]."""
    imgs = _numpy(imgs)
    if imgs.ndim == 3:
        imgs = imgs[..., None]
    n, h, w, c = imgs.shape
    if c == 1:
        imgs = np.repeat(imgs, 3, axis=-1)
        c = 3
    ncol = nrow  # torchvision's nrow = images per row
    nrows_ = int(np.ceil(n / ncol))
    H = nrows_ * (h + padding) + padding
    W = ncol * (w + padding) + padding
    grid = np.full((H, W, c), pad_value, np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = imgs[i]
    return grid


def make_colored_grid(imgs: np.ndarray, nrow: int, color: str) -> np.ndarray:
    """Grid with colored padding (reference visual_utils.py:13-26: padding
    value 0.25 recolored to pure red/blue)."""
    grid = make_grid(imgs, nrow=nrow, pad_value=0.25)
    mask = np.isclose(grid[..., 0], 0.25) & np.isclose(grid[..., 1], 0.25) \
        & np.isclose(grid[..., 2], 0.25)
    if color == "red":
        grid[mask] = [1.0, 0.0, 0.0]
    elif color == "blue":
        grid[mask] = [0.0, 0.0, 1.0]
    else:
        raise ValueError("other color not implemented yet")
    return grid


def _save(img: np.ndarray, save: str | None):
    """Write ``img``'s own pixels as a PNG (PIL; the JAX package renders it
    through matplotlib at 150 dpi)."""
    if save:
        from PIL import Image

        Image.fromarray(np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)
                        ).save(save)


def feature_swapping_plot(z_c, z_s, X, decode_fn, save: str | None = None):
    """n×n swap grid: every (z_c_i, z_s_j) pair decoded; source row/col images
    framed blue/red (reference visual_utils.py:29-58)."""
    z_c, z_s = _tensor(z_c), _tensor(z_s)
    n = z_c.shape[0]
    paired = torch.cat([z_c[:, None, :].expand(n, n, -1),
                        z_s[None, :, :].expand(n, n, -1)],
                       dim=-1).reshape(n * n, -1)
    x_inter = _numpy(decode_fn(paired))  # [n*n, H, W, C]
    X = _numpy(X)

    hgrid = make_colored_grid(X, nrow=n, color="blue")
    vgrid = make_colored_grid(X, nrow=1, color="red")
    maingrid = make_grid(x_inter, nrow=n)
    h, w = X.shape[1], X.shape[2]
    corner = np.ones((h + 4, w + 4, 3), np.float32)
    left = np.concatenate([corner, vgrid], axis=0)
    right = np.concatenate([hgrid, maingrid], axis=0)
    final = np.concatenate([left, right], axis=1)
    _save(final, save)
    return final


def _strips(z1, z2, z_dim: int, steps: int, decode_fn):
    """(style strip, content strip) decodes between two latents: z_s
    interpolated under z1's z_c, then z_c under z1's z_s."""
    zi = interpolate_latent(z1[z_dim:], z2[z_dim:], steps)
    style = decode_fn(torch.cat([z1[:z_dim][None].expand(steps, -1), zi], 1))
    zi = interpolate_latent(z1[:z_dim], z2[:z_dim], steps)
    content = decode_fn(torch.cat([zi, z1[z_dim:][None].expand(steps, -1)], 1))
    return _numpy(style), _numpy(content)


def interpolation_plot(X, z, decode_fn, z_dim: int, sample_size: int = 10,
                       inter_steps: int = 11, seed: int = 0,
                       save_prefix: str | None = None):
    """Style- and content-interpolation strips between random source/target
    pairs (reference visual_utils.py:61-128). Returns (style_grid,
    content_grid)."""
    z = _tensor(z)
    rs = np.random.RandomState(seed)
    src_ids = rs.permutation(z.shape[0])[:sample_size]
    tgt_ids = rs.permutation(z.shape[0])[:sample_size]
    X = _numpy(X)
    src_grid = make_colored_grid(X[src_ids], nrow=1, color="red")
    tgt_grid = make_colored_grid(X[tgt_ids], nrow=1, color="blue")
    space = np.ones((src_grid.shape[0], 8, 3), np.float32)
    src_grid = np.concatenate([src_grid, space], axis=1)
    tgt_grid = np.concatenate([space, tgt_grid], axis=1)

    style_rows, content_rows = [], []
    for i in range(sample_size):
        style, content = _strips(z[int(src_ids[i])], z[int(tgt_ids[i])],
                                 z_dim, inter_steps, decode_fn)
        style_rows.append(style)
        content_rows.append(content)

    style_grid = make_grid(np.concatenate(style_rows), nrow=inter_steps)
    content_grid = make_grid(np.concatenate(content_rows), nrow=inter_steps)
    style_grid = np.concatenate([src_grid, style_grid, tgt_grid], axis=1)
    content_grid = np.concatenate([src_grid, content_grid, tgt_grid], axis=1)
    if save_prefix:
        _save(style_grid, save_prefix + "-style.png")
        _save(content_grid, save_prefix + "-content.png")
    return style_grid, content_grid


def display_util(idx1: int, idx2: int, z, decode_fn, z_dim: int,
                 save_prefix: str | None = None):
    """Two-image style/content interpolation strips
    (reference display_utils.py:24-51)."""
    z = _tensor(z)
    style, content = _strips(z[idx1], z[idx2], z_dim, 11, decode_fn)
    style, content = make_grid(style, nrow=11), make_grid(content, nrow=11)
    if save_prefix:
        _save(style, save_prefix + "-style.png")
        _save(content, save_prefix + "-content.png")
    return style, content


def tsne_plot(mu_c, mu_s, labels, styles, content_labels=None,
              style_labels=None, save_prefix: str | None = None):
    """Four t-SNE scatter plots: mu_c by class & by style, mu_s by style &
    by class (reference visual_utils.py:144-183; embedding on the host by
    sklearn, identical hyperparameters)."""
    from sklearn.manifold import TSNE
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mu_c, mu_s = _numpy(mu_c), _numpy(mu_s)
    labels, styles = _numpy(labels), _numpy(styles)
    if content_labels is None:
        content_labels = list(range(int(labels.max()) + 1))
    if style_labels is None:
        style_labels = list(range(int(styles.max()) + 1))

    def scatter(emb, groups, names, path):
        cmap = plt.get_cmap("viridis")
        colors = [cmap(i) for i in np.linspace(0, 1, len(names))]
        fig, ax = plt.subplots()
        for g in range(len(names)):
            i = np.where(groups == g)[0]
            ax.scatter(emb[i, 0], emb[i, 1], alpha=0.2, c=[colors[g]],
                       label=names[g])
        ax.legend()
        if path:
            fig.savefig(path, bbox_inches="tight", dpi=120)
        plt.close(fig)

    # reference uses perplexity=30 (visual_utils.py:173); sklearn requires
    # perplexity < n_samples, so clamp for tiny inputs
    perp = min(30, max(2, len(mu_c) - 1))
    kw = dict(n_components=2, perplexity=perp, learning_rate=200, init="pca")
    emb_c = TSNE(**kw).fit_transform(mu_c)
    emb_s = TSNE(**kw).fit_transform(mu_s)
    p = save_prefix
    scatter(emb_c, labels, content_labels, p and p + "-muc-by-class.png")
    scatter(emb_c, styles, style_labels, p and p + "-muc-by-style.png")
    scatter(emb_s, styles, style_labels, p and p + "-mus-by-style.png")
    scatter(emb_s, labels, content_labels, p and p + "-mus-by-class.png")
    return emb_c, emb_s


def make_decode_fn(model):
    """Decode closure over the model's current weights in eval mode, on the
    model's device: latents [n, z] (tensor or array) → numpy [n, H, W, C]."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def decode(z):
        z = _tensor(z).to(device=device, dtype=torch.float32)
        return model.decode(z, train=False).cpu().numpy()

    return decode
