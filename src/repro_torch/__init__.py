"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

A package of its own beside the JAX reference: it imports ``torch`` and numpy,
never ``jax`` and nothing of ``repro``.  Module names follow the reference so
each counterpart is easy to find.  Entry points run on ``cuda`` unless the
caller asks for ``cpu``.
"""
