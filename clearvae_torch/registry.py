"""Name → constructor registries (counterpart of ``clearvae_tpu/registry.py``).

The reference resolves model, estimator and loss names with ``eval(string)``
(reference: code/src/utils/trainer_utils.py:28,45,69,99,132,174-175 and
code/src/losses.py:124). Here every name lives in an explicit registry, with
the reference's spelling as an alias: the JAX registry's eight architecture
names, 28×28 and 64×64.
"""

from __future__ import annotations

from clearvae_torch.models.cnn import LAMCNN, LAMCNN64, SimpleCNN, SimpleCNN64
from clearvae_torch.models.mi_estimators import MI_ESTIMATORS
from clearvae_torch.models.vae import VAE, VAE64
from clearvae_torch.ops.losses import CONTRASTIVE_LOSSES, SIM_FNS


class _Models(dict):
    def __missing__(self, name):
        raise KeyError(f"unknown architecture {name!r}; the port has "
                       f"{sorted(self)}")


MODELS = _Models({
    "vae28": VAE,
    "vae64": VAE64,
    "simple_cnn": SimpleCNN,
    "simple_cnn64": SimpleCNN64,
    "lam_cnn": LAMCNN,
    "lam_cnn64": LAMCNN64,
    # reference spellings (trainer_utils.py arch strings)
    "VAE": VAE,
    "VAE64": VAE64,
    "SimpleCNNClassifier": SimpleCNN,
    "SimpleCNN64Classifier": SimpleCNN64,
    "LAMCNNClassifier": LAMCNN,
    "LAMCNN64Classifier": LAMCNN64,
})

__all__ = ["MODELS", "MI_ESTIMATORS", "SIM_FNS", "CONTRASTIVE_LOSSES"]
