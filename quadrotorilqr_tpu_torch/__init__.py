"""PyTorch and CUDA port of quadrotorilqr_tpu: the SE(3) quadrotor iLQR.

The JAX package `quadrotorilqr_tpu` is the reference this package is tested
against; module paths mirror it. This package never imports JAX.
"""
