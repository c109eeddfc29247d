"""accessory_tpu_torch: the PyTorch/CUDA port of accessory_tpu for NVIDIA Hopper.

Module paths and function names mirror ``accessory_tpu`` so each counterpart
is easy to find; the code inside is PyTorch. Hand-written CUDA kernels live in
``csrc/`` and are built at first use (``kernels.py``). This package imports
neither JAX nor ``accessory_tpu``; importing it has no side effects.
"""
