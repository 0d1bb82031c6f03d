"""AIGV-Assessor in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of `aigv_assessor_tpu` (JAX/Pallas), which stays the reference the
port is tested against. Module names follow the JAX package so that each
counterpart is easy to find. This package imports `torch` and never `jax`.

Ported so far: stage-2 scoring (`cli/score.py`) in bf16 with one question
per video, for the InternVL2-2B model. Its attention runs through the
fused-qkv flash-attention forward in `csrc/flash_attn_fwd.cu`.
"""

__version__ = "0.1.0"
