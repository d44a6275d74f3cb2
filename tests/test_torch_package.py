"""The port stands alone: importing clearvae_torch (and chip_smoke.py) loads
no JAX, flax, optax or clearvae_tpu module, and entry points refuse to fall
back to the CPU quietly."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import chip_smoke
import clearvae_torch
import clearvae_torch.bridge, clearvae_torch.data.styled
import clearvae_torch.ops.metrics, clearvae_torch.train.factories
import clearvae_torch.ops.prng, clearvae_torch.ops.kernels.style
import clearvae_torch.models.mlp, clearvae_torch.train.trainers
import clearvae_torch.experiments.common
import clearvae_torch.experiments.styledmnist_downstream
import clearvae_torch.models.cnn, clearvae_torch.models.factor
import clearvae_torch.models.mi_estimators, clearvae_torch.ops.group
import clearvae_torch.registry, clearvae_torch.native.bindings
import clearvae_torch.experiments.mig_expr
import clearvae_torch.serve, clearvae_torch.bench
import clearvae_torch.utils.checkpoint, clearvae_torch.utils.logging
import clearvae_torch.utils.visual
import clearvae_torch.data.common, clearvae_torch.data.synth64
import clearvae_torch.data.celeba, clearvae_torch.data.pacs
import clearvae_torch.data.camelyon17, clearvae_torch.data.chexpert
import clearvae_torch.experiments.downstream64
import clearvae_torch.experiments.celeba_downstream
import clearvae_torch.experiments.pacs_downstream
import clearvae_torch.experiments.camelyon17_downstream
import clearvae_torch.experiments.chexpert_downstream
import clearvae_torch.experiments.mig_expr_celeba
bad = sorted({m.split('.')[0] for m in sys.modules}
             & {'jax', 'jaxlib', 'flax', 'optax', 'clearvae_tpu'})
print(','.join(bad))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def test_entry_point_needs_cuda_or_an_explicit_cpu(monkeypatch):
    import torch

    from clearvae_torch import resolve_device
    from clearvae_torch.train import factories as F

    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    common = dict(beta=1 / 8, vae_lr=5e-4, z_dim=16, alpha=100,
                  temperature=0.1)
    for factory, kw in (
            (F.get_clearvae_trainer, dict(common, ps=True)),
            (F.get_cleartcvae_trainer, dict(common, la=1, factor_cls_lr=1e-4)),
            (F.get_clearmimvae_trainer, dict(common, mi_estimator="CLUBSample",
                                             la=3, mi_estimator_lr=2e-3)),
            (F.get_hierarchical_vae_trainer, dict(beta=1 / 8, vae_lr=5e-4,
                                                  z_dim=16, group_mode="GVAE")),
            (F.get_cnn_trainer, dict(n_class=10)),
            (F.get_lamcnn_trainer, dict(n_class=2, lam_coef=0.001))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            factory(**kw)
    from clearvae_torch.models.vae import VAE
    from clearvae_torch.serve import InferenceSession

    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceSession(VAE(total_z_dim=16))
