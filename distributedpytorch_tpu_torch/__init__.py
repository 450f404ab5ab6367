"""PyTorch + CUDA port of ``distributedpytorch_tpu`` for NVIDIA Hopper.

The JAX package beside it is the reference; this package imports nothing
of it (nor JAX), keeping its own copies of the framework-free modules it
needs, with the same module names so each counterpart is easy to find.
Every Pallas TPU kernel on a ported path becomes a kernel written by hand
for Hopper under ``csrc/``.

Ported so far: ``python -m distributedpytorch_tpu_torch {train,test,serve}``
for the nine models of the JAX registry on one rank or several (``serve``
as a world of replicas), and the ``fleet`` collector with the offline
readers (``cli.py`` lists them).  The Pallas kernels are K1-K5 and the
ring's K4/K2p/K3p, in ``csrc/``.  Entry points run on ``cuda`` unless the
caller asks for the CPU (``--device cpu`` / ``device="cpu"``); they never
fall back to the CPU on their own.
"""
