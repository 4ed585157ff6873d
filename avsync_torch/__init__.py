"""avsync_torch — the PyTorch/CUDA port of avsync for one NVIDIA H100.

Imports torch, never jax, and nothing of the `avsync` package (the JAX
reference, which stays as it is beside this one). Entry points run on the
card (`cuda`) unless the caller passes `device="cpu"`; on a CPU tensor every
kernel wrapper takes its plain PyTorch version.
"""
