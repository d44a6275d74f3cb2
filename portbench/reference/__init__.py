"""The benchmark's plain reference: the VAE, its loss, Adam and evaluation
(``vae.py``), gMIG (``mig.py``) and the styling (``styling/``). Plain torch
and numpy; it imports nothing of the program."""
