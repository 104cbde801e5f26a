# Hand-written Hopper kernels for the Pallas kernels of ``repro.kernels``.
# Each kernel sits beside its plain PyTorch version; ``csrc/`` holds the
# CUDA C++ sources, built with nvcc at first use (see ``_build.py``).
