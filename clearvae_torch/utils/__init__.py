"""Checkpoints, metric logging and the latent-space helpers of the port
(counterpart of ``clearvae_tpu/utils``)."""
