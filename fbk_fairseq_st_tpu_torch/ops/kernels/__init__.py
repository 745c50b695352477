"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each kernel has a wrapper that launches it for CUDA tensors (or raises), a
plain PyTorch version the wrapper uses for CPU tensors, and a launch count.
Sources live in ``csrc/``; ``build.py`` compiles them at first use.
"""
