"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs the
plain version only for a tensor on the CPU. Sources are under ``csrc/``;
``_build`` compiles them at first use.
"""
