"""PyTorch/CUDA port of CoDA-TPU (the eval forward of the CoDA detector).

Module paths and names follow the JAX package `coda_neurips2023_tpu`, which
stays the reference.  This package imports torch and numpy, never jax.
The point and attention ops run hand-written Hopper kernels (csrc/) on CUDA
tensors and their plain PyTorch versions on CPU tensors.
"""
