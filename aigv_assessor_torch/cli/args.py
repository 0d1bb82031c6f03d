"""Argument parsing helpers of the CLIs (`aigv_assessor_tpu/cli/args.py`),
copied without jax: the boolean flags take the reference's spellings."""

from __future__ import annotations


def _bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "t", "yes", "y")
