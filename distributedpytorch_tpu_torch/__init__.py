"""PyTorch + CUDA port of ``distributedpytorch_tpu`` for NVIDIA Hopper.

The JAX package beside it is the reference; this package imports nothing
of it (nor JAX), keeping its own copies of the framework-free modules it
needs, with the same module names so each counterpart is easy to find.
Every Pallas TPU kernel on a ported path becomes a kernel written by hand
for Hopper under ``csrc/``.

Ported so far: ``python -m distributedpytorch_tpu_torch {train,test,serve}``
for the ``vit`` model with ``--attention full|flash``, on one process and
one device (flash = kernel K1, ``csrc/flash_fwd.cu``, forward, and kernels
K2/K3, ``csrc/flash_bwd.cu``, backward).  Entry points run on ``cuda`` unless the caller
asks for the CPU (``--device cpu`` / ``device="cpu"``); they never fall
back to the CPU on their own.
"""
