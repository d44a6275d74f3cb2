"""The reference's styling: frozen copies of the port's plain styling code
(``clearvae_torch/ops/{prng,image,corruptions}.py`` and the plain twin of
``ops/kernels/style.py``), imports rewritten to this package, so that the
reference styles the raw images again without importing the program."""
