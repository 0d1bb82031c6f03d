"""Per-layer activation checkpointing (the JAX towers' `nn.remat`).

`torch.utils.checkpoint` saves and restores the global random state for its
recompute, not a generator that the layer draws from itself. The port's
dropout and drop-path masks come from an explicit `torch.Generator`, so
`checkpoint_layer` rewinds that generator to the state it had when the layer
first ran, for the recompute only, and puts it back afterwards: the
recompute draws the masks the first pass drew, and the generator's sequence
outside the layer is the one a run without checkpointing has.

`use_reentrant=False`: a layer's input may need no gradient while the
adapters inside it do (the first ViT layer). The global random state is
neither saved nor restored: nothing in the port draws from it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint


def checkpoint_layer(
    fn: Callable[..., torch.Tensor], generator: Optional[torch.Generator], *args
) -> torch.Tensor:
    """`fn(*args)` with its activations recomputed in the backward."""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    entry = generator.get_state()
    first_pass = [True]

    def body(*a):
        if first_pass[0]:
            first_pass[0] = False
            return fn(*a)
        now = generator.get_state()
        generator.set_state(entry)
        try:
            return fn(*a)
        finally:  # also when the recompute stops early
            generator.set_state(now)

    return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False)
