"""Hand-written Hopper kernels of the port, each an ops/ref/kernel triple
(``ref.py`` the plain PyTorch version, ``kernel.py`` the CUDA wrapper,
``ops.py`` the entry point), plus the bucketed dispatch plane
(:mod:`repro_torch.kernels.dispatch`)."""
