"""vimoclip_tpu_torch — ViMoCLIP in PyTorch: the serving cascade, stage-1
student training and motion export, and stage-2 TFAM training, with the
attention kernels and the fused uint8 normalisation written by hand in
CUDA C++ for NVIDIA Hopper (sm_90a).

The module layout mirrors ``vimoclip_tpu`` so each counterpart is easy to
find; the JAX package stays the numerical reference the port is tested
against. This package imports ``torch`` and never ``jax`` nor anything of
``vimoclip_tpu``: what it needs from there it keeps as its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
``cuda`` request on a machine without a card raises (``utils.device``).
"""

__version__ = "0.1.0"
