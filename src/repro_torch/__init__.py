"""PyTorch/CUDA port of the FASTLIBRA multi-LoRA serving system.

A second package beside ``repro`` (the JAX reference, which it never
imports). The control plane (``configs``, ``core``, ``obs``, and the
request/scheduler/metrics modules of ``serving``) is a copy of the
reference's own code; the data plane is PyTorch, with the TPU kernels of the
serving path rewritten as CUDA kernels for Hopper (``kernels/csrc``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
