"""PyTorch + CUDA port of latentsplat_tpu.

The JAX package `latentsplat_tpu` is the reference this package is held
against; module paths mirror it. Public functions keep the JAX layouts:
NHWC images, (b, v, ...) batches and (C, H, W) render outputs. Nothing here
imports jax or flax.
"""
