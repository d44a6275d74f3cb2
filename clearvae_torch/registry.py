"""Name → constructor registries (counterpart of ``clearvae_tpu/registry.py``).

The reference resolves model, estimator and loss names with ``eval(string)``
(reference: code/src/utils/trainer_utils.py:28,45,69,99,132,174-175 and
code/src/losses.py:124). Here every name lives in an explicit registry, with
the reference's spelling as an alias. ``MODELS`` lists the architectures the
port has, the 28×28 ones; a name of the 64×64 or LAM architectures raises a
``KeyError`` that says they come with the 64×64 slice (ROADMAP item 15).
"""

from __future__ import annotations

from clearvae_torch.models.cnn import SimpleCNN
from clearvae_torch.models.mi_estimators import MI_ESTIMATORS
from clearvae_torch.models.vae import VAE
from clearvae_torch.ops.losses import CONTRASTIVE_LOSSES, SIM_FNS

# the JAX registry's names of architectures the port does not have yet
NOT_PORTED = ("vae64", "simple_cnn64", "lam_cnn", "lam_cnn64", "VAE64",
              "SimpleCNN64Classifier", "LAMCNNClassifier",
              "LAMCNN64Classifier")


class _Models(dict):
    def __missing__(self, name):
        if name in NOT_PORTED:
            raise KeyError(f"{name!r} is a 64x64 or LAM architecture, which "
                           f"the port does not have yet (ROADMAP item 15)")
        raise KeyError(f"unknown architecture {name!r}; the port has "
                       f"{sorted(self)}")


MODELS = _Models({
    "vae28": VAE,
    "simple_cnn": SimpleCNN,
    # reference spellings (trainer_utils.py arch strings)
    "VAE": VAE,
    "SimpleCNNClassifier": SimpleCNN,
})

__all__ = ["MODELS", "MI_ESTIMATORS", "SIM_FNS", "CONTRASTIVE_LOSSES"]
