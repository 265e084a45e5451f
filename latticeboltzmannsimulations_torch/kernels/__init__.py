"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  Modules here build nothing when imported: a kernel is compiled
(``_build``) at its first launch on the card."""
