"""apex_tpu_torch — the PyTorch/CUDA port of ``apex_tpu`` for NVIDIA Hopper.

The JAX package ``apex_tpu`` stays the reference; this package mirrors its
module paths and public names and imports nothing of it.  Every kernel the
JAX package wrote in Pallas for the TPU becomes a kernel written by hand
for Hopper under ``apex_tpu_torch/csrc/``, built at first use
(:mod:`apex_tpu_torch.utils.build`) and checked against a plain PyTorch
version kept beside it.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; a CUDA request on a host without CUDA raises.
"""
__version__ = "0.1.0"
