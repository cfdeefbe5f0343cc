"""SPE in PyTorch for NVIDIA Hopper: the port of `spe_tpu` (JAX/TPU).

`spe_tpu` stays the frozen reference. This package imports its JAX-free host
code (`spe_tpu.config`, `spe_tpu.data`) and never imports jax or flax.
"""
