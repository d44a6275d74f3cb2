"""Experiment runners of the port (counterpart of
``clearvae_tpu/experiments``): so far the Styled-MNIST downstream
experiment."""
