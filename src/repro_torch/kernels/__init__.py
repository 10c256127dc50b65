"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  CUDA sources live in ``csrc/`` and are built with ``nvcc`` at
first use into ``build/`` (see :mod:`._nvcc`)."""
