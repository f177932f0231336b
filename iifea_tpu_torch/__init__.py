"""PyTorch/CUDA port of iifea_tpu: the 2D immersed-Poisson lattice path.

Imports torch, numpy and scipy only; the JAX package is the reference the
port is tested against.
"""
