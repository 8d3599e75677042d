"""Hand-written Hopper kernels (CUDA C++ under csrc/) and their plain
PyTorch versions; see build.py for how they are built and loaded."""
