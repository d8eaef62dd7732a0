"""PyTorch/CUDA port of testudo_tpu: the G1/G2 group layer, the sqrt-PST
commitment and TestudoNIZK (sumcheck, R1CS, the Spartan proof).

The JAX package `testudo_tpu` is the reference; this package mirrors its
layout (fields/, curves/, and device/ for the JAX package's tpu/) and imports
only torch, numpy and the standard library.  Entry points take `device=` and
default to the CUDA device; on CUDA tensors every hot function launches a
hand-written sm_90a kernel from csrc/, on CPU tensors it runs the plain
PyTorch version that sits beside the kernel's wrapper.
"""
