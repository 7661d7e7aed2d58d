"""PyTorch/CUDA port of the MobiRNN reproduction.

The module tree mirrors ``repro`` (the JAX + Pallas package): each
``repro.X`` that has been ported has a ``repro_torch.X`` twin.  The port
imports torch and numpy only — never jax and never ``repro`` — and every
Pallas kernel on a ported path is a CUDA C++ kernel for Hopper
(``kernels/csrc``), with a plain PyTorch version beside it that CPU tensors
take.
"""
