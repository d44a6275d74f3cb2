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
    from clearvae_torch.train.factories import get_clearvae_trainer

    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_clearvae_trainer(beta=1 / 8, ps=True, vae_lr=5e-4, z_dim=16,
                             alpha=100, temperature=0.1)
