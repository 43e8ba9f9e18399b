"""sgg_torch.kernels — hand-written Hopper kernels, each beside its plain
PyTorch version. CUDA sources live in ``csrc/`` and are built by ``build``."""
