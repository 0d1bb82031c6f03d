"""AIGV-Assessor in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of `aigv_assessor_tpu` (JAX/Pallas), which stays the reference the
port is tested against. Module names follow the JAX package so that each
counterpart is easy to find. This package imports `torch` and never `jax`.

Ported so far, for the InternVL2-2B model: stage-2 scoring (`cli/score.py`)
with one question per video, in bf16, W8A8 or weight-only int8 / int4, and
stage-2 LoRA training (`cli/stage2_train.py`). The hand-written kernels are
in `csrc/`: the flash-attention forward and backward, the fused quantize
feeds and the weight-only matmuls.
"""

__version__ = "0.1.0"
