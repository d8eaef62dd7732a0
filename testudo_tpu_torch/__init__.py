"""PyTorch/CUDA port of testudo_tpu (first slice: G1 multi-scalar multiplication).

The JAX package `testudo_tpu` is the reference; this package mirrors its
layout (fields/, curves/, and device/ for the JAX package's tpu/) and imports
only torch, numpy and the standard library.  Entry points take `device=` and
default to the CUDA device; on CUDA tensors every hot function launches a
hand-written sm_90a kernel from csrc/, on CPU tensors it runs the plain
PyTorch version that sits beside the kernel's wrapper.
"""
