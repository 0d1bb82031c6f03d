"""The `tensor` mesh axis by hand: what GSPMD derives for JAX from its rule
table (`aigv_assessor_tpu/parallel/sharding.py:37-66`), Megatron-style.

A split projection holds this rank's share of its weight (`split_linear`):

- column-parallel (`qkv`, `fc1`, `wqkv`, `w1`, `w3`): this rank's output
  rows. A fused qkv is split by heads, not contiguously: its output is
  [q | k | v] (the ViT's [3H, D] head-major view, the decoder's [hq | hkv |
  hkv] heads), so each rank keeps its q heads and the k and v heads of its
  own GQA groups, block by block (`SplitLeaf.blocks`). An adapter keeps
  `lora_a` whole and this rank's columns of `lora_b`, in the same order.
- row-parallel (`proj`, `fc2`, `wo`, `w2`): this rank's input columns (the
  heads of the attention before it, or the columns of the column-parallel
  projection before it). An adapter keeps this rank's rows of `lora_a` and
  `lora_b` whole; its partial product joins the base's partial in one
  all-reduce, and the bias is added once, after it.

The collectives are Megatron's pair of autograd operators: on a
column-parallel input identity forward, all-reduce backward
(`copy_to_split`); on a row-parallel output all-reduce forward, identity
backward (`reduce_from_split`), since every rank then holds the same hidden
state and computes the same loss. A parameter that stays whole but meets a
split activation (`lora_a` before a column split, `lora_b` after a row
split) goes through `copy_to_split` too, so its gradient is summed over the
ranks. A statistic over a split width (the QK-normalized ViT's RMSNorm over
all heads) is all-reduced both ways (`all_reduce_split`).

`TensorSplit(size, rank, group)`: `group` is the `tensor` axis' process
group, or None for the group-less form of one rank's shard, built and run
without a process group: every collective is then the identity, so a
row-parallel projection returns its partial sum before the bias, and
`sum_partials` sums the ranks' partials and adds the bias once. A statistic
over the split width cannot be summed afterwards, so the QK-normalized
attention raises in that form (`split_rms_norm`).

`split_leaves` gives, per parameter name, how it was split; `unsplit`
gathers a shard back into the unsplit layout (an all-gather over the
group) and `SplitLeaf.shard` cuts a whole tensor again, which the full state
dicts and the checkpoints use (`full_state_dict`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

COLUMN, ROW = "column", "row"


@dataclass(frozen=True)
class TensorSplit:
    """This rank's place on the `tensor` axis: `size` ranks, index `rank`,
    the axis' process group (None: the group-less form)."""

    size: int
    rank: int
    group: Any = None


@dataclass(frozen=True)
class SplitLeaf:
    """How a parameter is split: dim `dim` of the unsplit tensor is the
    concatenation of `blocks` (their unsplit sizes), each cut evenly over the
    ranks; a rank's shard is its piece of every block, in block order."""

    dim: int
    blocks: Tuple[int, ...]

    def shard(self, t: torch.Tensor, rank: int, size: int) -> torch.Tensor:
        """Rank `rank`'s shard of the whole tensor `t` (a copy)."""
        if t.shape[self.dim] != sum(self.blocks):
            raise ValueError(f"dim {self.dim} of {tuple(t.shape)} is not {sum(self.blocks)}")
        parts, off = [], 0
        for b in self.blocks:
            n = b // size
            parts.append(t.narrow(self.dim, off + rank * n, n))
            off += b
        return torch.cat(parts, self.dim).contiguous()

    def unshard(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole tensor from every rank's shard, in rank order."""
        size = len(shards)
        parts, off = [], 0
        for b in self.blocks:
            n = b // size
            parts.extend(s.narrow(self.dim, off, n) for s in shards)
            off += n
        return torch.cat(parts, self.dim)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _CopyToSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def copy_to_split(x: torch.Tensor, split: Optional[TensorSplit]) -> torch.Tensor:
    """Identity forward, gradient summed over the ranks."""
    if split is None or split.group is None:
        return x
    return _CopyToSplit.apply(x, split.group)


def reduce_from_split(x: torch.Tensor, split: Optional[TensorSplit]) -> torch.Tensor:
    """The ranks' partials summed forward, the gradient passed through."""
    if split is None or split.group is None:
        return x
    return _ReduceFromSplit.apply(x, split.group)


def all_reduce_split(x: torch.Tensor, split: Optional[TensorSplit]) -> torch.Tensor:
    """Summed over the ranks forward and backward."""
    if split is None or split.group is None:
        return x
    return _AllReduce.apply(x, split.group)


def split_forward(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                  split: TensorSplit, role: str, delta=None) -> torch.Tensor:
    """One split projection: column-parallel `F.linear(copy_to_split(x), W,
    b)`; row-parallel the partial product summed over the ranks, then the
    bias (in the group-less form the partial alone). `delta(x)`, where
    given, is an adapter's product on the same input, added to the base's
    before the one all-reduce."""
    row = role == ROW
    if not row:
        x = copy_to_split(x, split)
    y = F.linear(x, weight, None if row else bias)
    if delta is not None:
        y = y + delta(x)
    if row:
        y = reduce_from_split(y, split)
        if bias is not None and split.group is not None:
            y = y + bias
    return y


class SplitLinear(nn.Linear):
    """A plain float projection split over `tensor` (`split_linear`)."""

    split: TensorSplit
    split_role: str

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return split_forward(x, self.weight, self.bias, self.split, self.split_role)

    def extra_repr(self) -> str:
        return f"{super().extra_repr()}, {self.split_role} {self.split.rank}/{self.split.size}"


def _param(t: torch.Tensor, like: nn.Parameter) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=like.requires_grad)


def split_linear(module: nn.Module, role: str, split: TensorSplit,
                 blocks: Optional[Tuple[int, ...]] = None) -> nn.Module:
    """This rank's share of a float projection -> the module to hold in its
    place: an `nn.Linear` becomes a `SplitLinear`, a `LoRALinear` is cut in
    place. `blocks`: the output's blocks of a fused projection (column only;
    default one block). A quantized base raises: JAX's rules never split
    one (its `kernel_int8` / `kernel_int4` match no `kernel$` rule)."""
    from aigv_assessor_torch.models.lora import LoRALinear

    if role not in (COLUMN, ROW):
        raise ValueError(role)
    if not isinstance(module, (nn.Linear, LoRALinear)):
        raise ValueError(f"{type(module).__name__} is not split over tensor: only float "
                         "projections are")
    out_f, in_f = module.weight.shape
    if role == COLUMN:
        leaves = {"weight": SplitLeaf(0, blocks or (out_f,)), "bias": SplitLeaf(0, blocks or (out_f,)),
                  "lora_b": SplitLeaf(1, blocks or (out_f,))}
    else:
        leaves = {"weight": SplitLeaf(1, (in_f,)), "lora_a": SplitLeaf(0, (in_f,))}
    for leaf in leaves.values():
        if any(b % split.size for b in leaf.blocks):
            raise ValueError(f"blocks {leaf.blocks} do not split over {split.size} ranks")
    held = {k: v for k, v in leaves.items() if getattr(module, k, None) is not None}
    cut = {k: leaf.shard(getattr(module, k).detach(), split.rank, split.size)
           for k, leaf in held.items()}
    if isinstance(module, LoRALinear):
        for k, t in cut.items():
            setattr(module, k, _param(t, getattr(module, k)))
        if role == ROW:
            module.in_features = in_f // split.size
        elif module.heads:
            module.heads //= split.size
        out = module
    else:
        out = SplitLinear(cut["weight"].shape[1], cut["weight"].shape[0],
                          bias=module.bias is not None, device="meta")
        out.weight = _param(cut["weight"], module.weight)
        if module.bias is not None:  # a row-parallel bias stays whole
            out.bias = _param(cut["bias"], module.bias) if "bias" in cut else module.bias
        out.train(module.training)
    out.split, out.split_role, out.split_leaves = split, role, held
    return out


def split_norm_(norm: nn.Module, split: TensorSplit) -> None:
    """This rank's columns of a norm over a split width, in place."""
    leaf = SplitLeaf(0, (norm.weight.shape[0],))
    norm.weight = _param(leaf.shard(norm.weight.detach(), split.rank, split.size), norm.weight)
    norm.split_leaves = {"weight": leaf}


def split_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
                   split: TensorSplit) -> torch.Tensor:
    """`ops/norms.rms_norm` over the whole width of which `x` holds this
    rank's columns: the sum of squares is summed over the ranks, so the
    group-less form, whose partials are summed after the layer, raises."""
    if split.group is None:
        raise ValueError("a norm over a width split over tensor needs the tensor axis' "
                         "process group: the group-less form cannot sum its squares")
    xf = x.float()
    ss = all_reduce_split(xf.pow(2).sum(-1, keepdim=True), split)
    xf = xf * torch.rsqrt(ss / (x.shape[-1] * split.size) + eps)
    return weight.to(x.dtype) * xf.to(x.dtype)


def sum_partials(module: nn.Module, outs: Sequence[torch.Tensor]) -> torch.Tensor:
    """`module`'s whole output from its group-less shards' outputs (each a
    partial sum before the bias): their sum, then the bias of its
    row-parallel projection (`TENSOR_ROLES`) once."""
    row = [c for c, role in type(module).TENSOR_ROLES.items() if role == ROW][0]
    bias = getattr(module, row).bias
    out = sum(outs[1:], outs[0])
    return out if bias is None else out + bias


def split_leaves(model: nn.Module) -> Dict[str, SplitLeaf]:
    """{parameter name: how it is split} of every split parameter."""
    out = {}
    for name, m in model.named_modules():
        for leaf, how in getattr(m, "split_leaves", {}).items():
            out[f"{name}.{leaf}" if name else leaf] = how
    return out


def model_split(model: nn.Module) -> Optional[TensorSplit]:
    """The `TensorSplit` the model's projections were cut for, or None."""
    for m in model.modules():
        if isinstance(getattr(m, "split", None), TensorSplit):
            return m.split
    return None


def unsplit(t: torch.Tensor, leaf: SplitLeaf, split: TensorSplit) -> torch.Tensor:
    """The whole tensor of which `t` is this rank's shard: an all-gather over
    the `tensor` group, on every rank of it."""
    if split.group is None:
        raise ValueError("gathering the shards needs the tensor axis' process group")
    t = t.contiguous()
    shards = [torch.empty_like(t) for _ in range(split.size)]
    dist.all_gather(shards, t, group=split.group)
    return leaf.unshard(shards)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` with every split parameter gathered into its
    unsplit layout (a collective on every rank of the group)."""
    sd = model.state_dict()
    split, leaves = model_split(model), split_leaves(model)
    if split is None:
        return sd
    return {k: unsplit(v, leaves[k], split) if k in leaves else v for k, v in sd.items()}
