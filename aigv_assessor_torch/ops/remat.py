"""Per-layer activation checkpointing (the JAX towers' `nn.remat`), with the
JAX checkpoint policies that pick what a layer saves.

`torch.utils.checkpoint` saves and restores the global random state for its
recompute, not a generator that the layer draws from itself. The port's
dropout and drop-path masks come from an explicit `torch.Generator`, so
`checkpoint_layer` rewinds that generator to the state it had when the layer
first ran, for the recompute only, and puts it back afterwards: the
recompute draws the masks the first pass drew, and the generator's sequence
outside the layer is the one a run without checkpointing has.

A policy (`policy_fn`, by the name of its `jax.checkpoint_policies`
counterpart) runs the layer under
`torch.utils.checkpoint.create_selective_checkpoint_contexts`: the outputs of
the ATen ops it names are kept from the first pass, everything else is
recomputed in the backward.

- `nothing_saveable`: whole layers recomputed (what no policy does);
- `everything_saveable`: every op's output kept;
- `dots_saveable` (alias `checkpoint_dots`): the products' outputs, `mm`,
  `addmm`, `bmm`, `baddbmm`;
- `dots_with_no_batch_dims_saveable` (alias
  `checkpoint_dots_with_no_batch_dims`): the products without a batch
  dimension, `mm` and `addmm`: the dense projections and the adapters'
  products. The attention kernels are custom autograd Functions whose
  launches are no ATen product, so they are recomputed, as JAX's policy
  recomputes a Pallas call's output.

An unknown name raises ValueError, as `getattr(jax.checkpoint_policies,
name)` raises.

`use_reentrant=False`: a layer's input may need no gradient while the
adapters inside it do (the first ViT layer). The global random state is
neither saved nor restored: nothing in the port draws from it.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

_aten = torch.ops.aten
_UNBATCHED_DOTS = frozenset({_aten.mm.default, _aten.addmm.default})
_DOTS = _UNBATCHED_DOTS | {_aten.bmm.default, _aten.baddbmm.default}
# the ops each policy keeps; None: every op
POLICIES = {
    "nothing_saveable": frozenset(),
    "everything_saveable": None,
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _UNBATCHED_DOTS,
    "checkpoint_dots_with_no_batch_dims": _UNBATCHED_DOTS,
}


def policy_fn(name: str) -> Callable:
    """The selective-checkpoint policy of a JAX policy name."""
    if name not in POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; one of {sorted(POLICIES)}")
    saved = POLICIES[name]

    def policy(ctx, op, *args, **kwargs):
        if saved is None or op in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def checkpoint_layer(
    fn: Callable[..., torch.Tensor], generator: Optional[torch.Generator], *args,
    policy: Optional[str] = None,
) -> torch.Tensor:
    """`fn(*args)` with its activations recomputed in the backward: all of
    them, or under `policy` those it does not save."""
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if policy is not None and policy != "nothing_saveable":
        # a kept output may be written in place later (a dropout mask drawn
        # into a fresh tensor), which the recompute then reads as it was left
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy_fn(policy),
            allow_cache_entry_mutation=True)
    if generator is None:
        return checkpoint(fn, *args, **kw)
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

    return checkpoint(body, *args, **kw)
