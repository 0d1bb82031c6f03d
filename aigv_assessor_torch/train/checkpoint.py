"""Checkpoints (`aigv_assessor_tpu/train/checkpoint.py`).

- `save_lora_weights` / `load_lora_weights`: the adapter leaves alone, as
  one safetensors file keyed by the JAX path names
  (`vision_model/layers/attn/qkv/lora_a`, ...), each holding the layers
  stacked on a leading axis as the JAX tree holds them. The JAX package
  writes the same arrays as flax msgpack, each key under `params/`
  (`utils/flax_msgpack.py` reads and writes that format).
- `save_trainable_weights`: any set of parameters (stage 1: `mlp1` and
  `motion_mlp`) the same way, in the JAX tree's layout (a dense kernel
  [in, out]).
- `CheckpointManager`: the trainer's whole state in the layout the JAX
  package's orbax `CheckpointManager` writes, so that a run resumes across
  the two packages either way. `<dir>/<step>/` holds `_CHECKPOINT_METADATA`
  and the item `default/` (`utils/orbax_format.py` over `utils/ocdbt.py`:
  JAX's `TrainState` as orbax flattens it, `params.params.<flax path>` for
  every parameter, frozen ones included, dense kernels [in, out], layers
  stacked; optax's `opt_state`; `step`); `<dir>/best/state/` the best
  slot; `trainer_extras.json` beside each item what the port needs and
  JAX's tree lacks (the dropout generator, `best_metric`). The newest
  `save_total_limit` steps are kept.

A model sharded over several ranks (`parallel/sharding.shard_params`)
saves what a one-card run saves: every rank calls `save_*` and
`CheckpointManager.save` (they gather the whole tensors, a collective: over
(data, fsdp), then the shards of a tower split over `tensor` into the
unsplit layout, `parallel/tensor.unsplit`), and the primary alone writes.
`restore` reads the same directory into a trainer of any layout, sharded
or not, split or not; `load_lora_weights` cuts each rank's share again.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from aigv_assessor_torch.core.dist import barrier, is_primary
from aigv_assessor_torch.models import loading
from aigv_assessor_torch.models.lora import is_lora_param
from aigv_assessor_torch.parallel.sharding import full_tensor
from aigv_assessor_torch.parallel.tensor import model_split, split_leaves, unsplit
from aigv_assessor_torch.utils import orbax_format

logger = logging.getLogger(__name__)


def _leaves(model: nn.Module, keep) -> Dict[str, List[tuple]]:
    """{JAX path: (name, parameter) of the port's parameters named by `keep`,
    of layers 0..L-1 in order, or the one parameter outside the layers}."""
    params = dict(model.named_parameters())
    by_path: Dict[str, Dict[int, tuple]] = {}
    for name, (path, layer) in loading.jax_paths(model).items():
        if name in params and keep(name):
            by_path.setdefault(path, {})[0 if layer is None else layer] = (name, params[name])
    return {path: [layers[i] for i in range(len(layers))] for path, layers in by_path.items()}


def _lora_leaves(model: nn.Module) -> Dict[str, List[tuple]]:
    return _leaves(model, is_lora_param)


def _whole(model: nn.Module, leaves: List[tuple]) -> List[torch.Tensor]:
    """The whole tensors of `leaves` on the CPU: gathered where sharded over
    (data, fsdp), and into the unsplit layout where split over `tensor`."""
    split = model_split(model)
    cut = split_leaves(model) if split is not None else {}
    out = []
    for name, p in leaves:
        t = full_tensor(p.detach())
        out.append((unsplit(t, cut[name], split) if name in cut else t).cpu())
    return out


def extract_lora(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Flat {JAX path: [L, ...] tensor on the CPU} of the adapter leaves
    (whole, gathered from every rank where they are sharded or split)."""
    return {path: torch.stack(_whole(model, leaves))
            for path, leaves in _lora_leaves(model).items()}


def extract_params(model: nn.Module, names) -> Dict[str, torch.Tensor]:
    """Flat {JAX path: tensor on the CPU} of the named parameters in the JAX
    tree's layout: a dense `kernel` [in, out], layers stacked on a leading
    axis."""
    wanted = set(names)
    paths = dict(loading.jax_paths(model).values())
    out = {}
    for path, leaves in _leaves(model, lambda n: n in wanted).items():
        ts = [loading.jax_layout(path, t) for t in _whole(model, leaves)]
        out[path] = torch.stack(ts).contiguous() if paths[path] is not None else ts[0].contiguous()
    return out


def save_trainable_weights(path: str, model: nn.Module, names) -> None:
    """The named parameters (`extract_params`) as one safetensors file."""
    from safetensors.torch import save_file

    tensors = extract_params(model, names)
    if is_primary():
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        save_file(tensors, path)
        logger.info("saved %d trainable tensors to %s", len(tensors), path)
    barrier()


def save_lora_weights(path: str, model: nn.Module) -> None:
    from safetensors.torch import save_file

    lora = extract_lora(model)
    if is_primary():
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        save_file(lora, path)
        logger.info("saved %d LoRA tensors to %s", len(lora), path)
    barrier()


@torch.no_grad()
def load_lora_weights(path: str, model: nn.Module) -> nn.Module:
    """Copy a LoRA-only artifact into the model's adapters, in place; a
    tower split over `tensor` takes this rank's share of each."""
    from safetensors.torch import load_file

    leaves = _lora_leaves(model)
    split = model_split(model)
    cut = split_leaves(model) if split is not None else {}
    for key, value in load_file(path).items():
        if key not in leaves:
            raise KeyError(f"LoRA tensor {key} not present in the model")
        if value.shape[0] != len(leaves[key]):
            raise ValueError(f"{key}: {value.shape[0]} layers, the model has {len(leaves[key])}")
        for (name, p), v in zip(leaves[key], value):
            p.copy_(cut[name].shard(v, split.rank, split.size) if name in cut else v)
    return model




# ------------------------------------------------- the trainer's state --

EXTRAS_FILE = "trainer_extras.json"
ITEM = "default"  # the CheckpointManager's one item
BEST_ITEM = os.path.join("best", "state")
_CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_D, _S = orbax_format.KEY_DICT, orbax_format.KEY_SEQUENCE


def _params_key(root: Tuple, path: str) -> orbax_format.Key:
    return root + tuple((k, _D) for k in path.split("/"))


def _optimizer_order(trainer) -> List[str]:
    """The trainable parameters' names in the optimizer's index order."""
    names = {id(p): n for n, p in trainer.trainable_parameters().items()}
    return [names[id(p)] for g in trainer.optimizer.param_groups for p in g["params"]]


def train_state_tree(trainer, state: Dict[str, Any]) -> List[Tuple[orbax_format.Key, Any]]:
    """The JAX `TrainState` of `trainer.state_dict()` as orbax flattens it,
    on the CPU: `params.params.<path>` (every parameter and buffer, in the
    JAX layout and dtype), `opt_state` (optax's chain: clip's EmptyState;
    AdamW's ScaleByAdamState(count, mu, nu), the decay mask's MaskedState
    and ScaleByScheduleState(count); the layer-decay EmptyState where the
    trainer has layer decay), `step`. Each leaf is laid out on the
    trainer's device."""
    model = trainer.model
    moments: Dict[str, Dict[str, torch.Tensor]] = {"exp_avg": {}, "exp_avg_sq": {}}
    params = state["params"]
    for i, n in enumerate(_optimizer_order(trainer)):
        st = state["optimizer"]["state"].get(i, {})
        for k, moment in moments.items():
            moment[n] = st[k] if k in st else torch.zeros_like(params[n])

    def leaves(root, tensors):
        flat = loading.jax_leaves(model, tensors, device=trainer.device, out="cpu")
        return sorted((_params_key(root, path), t) for path, t in flat.items())

    count = torch.tensor(state["step"], dtype=torch.int32)
    opt = (("opt_state", _D),)
    adam = opt + (("1", _S), ("0", _S))
    tree = leaves((("params", _D), ("params", _D)), params)
    tree.append((opt + (("0", _S),), None))
    tree.append((adam + (("count", _D),), count))
    for field, k in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        tree += leaves(adam + ((field, _D), ("params", _D)),
                       {n: t.float() for n, t in moments[k].items()})
    tree.append((opt + (("1", _S), ("1", _S), ("inner_state", _D)), None))
    tree.append((opt + (("1", _S), ("2", _S), ("count", _D)), count.clone()))
    if trainer.layer_decay:
        tree.append((opt + (("2", _S),), None))
    tree.append(((("step", _D),), count.clone()))
    return tree


def state_from_tree(trainer, tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of `train_state_tree`: {leaf name: tensor} of a JAX
    `TrainState`, written by either package, as `trainer.load_state_dict`
    takes it, on the CPU (no generator: the caller adds one)."""
    model = trainer.model

    def port_state(prefix: str, want) -> Dict[str, torch.Tensor]:
        leaves = {name[len(prefix):].replace(".", "/"): t for name, t in tree.items()
                  if name.startswith(prefix) and t is not None}
        try:
            got = loading.port_leaves(model, leaves, device=trainer.device, out="cpu")
        except KeyError as e:
            raise KeyError(f"the checkpoint's {prefix.rstrip('.')} does not match the "
                           f"trainer: {e}") from None
        if set(got) != set(want):
            raise KeyError(f"the checkpoint's {prefix.rstrip('.')} does not match the trainer: "
                           f"missing {sorted(set(want) - set(got))}, "
                           f"unused {sorted(set(got) - set(want))}")
        return got

    params = port_state("params.params.", set(model.state_dict()))
    trainable = trainer.trainable_parameters()
    mu = port_state("opt_state.1.0.mu.params.", trainable)
    nu = port_state("opt_state.1.0.nu.params.", trainable)
    step = int(tree["step"])
    count = torch.tensor(float(tree["opt_state.1.0.count"]), dtype=torch.float32)
    optimizer = {
        "state": {i: {"step": count.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                  for i, n in enumerate(_optimizer_order(trainer))},
        "param_groups": trainer.optimizer.state_dict()["param_groups"],
    }
    return {"params": params, "optimizer": optimizer, "step": step}


def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def _write_json(path: str, obj: Any) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def _checkpoint_metadata(start_ns: int, item_handlers: Any) -> Dict[str, Any]:
    return {"item_handlers": item_handlers, "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": start_ns, "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}}


class CheckpointManager:
    """The JAX package's `train/checkpoint.CheckpointManager`, on disk as
    orbax writes it, read and written here without orbax or tensorstore
    (`utils/orbax_format.py`, `utils/ocdbt.py`):

    - `save(step, trainer)` writes the whole `TrainState` (`train_state_tree`:
      every parameter, the frozen ones included, in the JAX layout and
      dtypes; AdamW's moments and counts as optax's; the step) as the
      `default` item of `<dir>/<step>/`, with `_CHECKPOINT_METADATA`, and
      keeps the newest `max(save_total_limit, 1)` steps; a step not newer
      than the newest saved one is skipped, as orbax's manager skips it.
      `best=True` also writes the same tree as `<dir>/best/state/`, as
      JAX's `StandardCheckpointer` does. What the port needs beside the
      tree, the dropout generator's state and `best_metric`, goes in
      `trainer_extras.json` beside the item (in `<dir>/<step>/`, in
      `<dir>/best/`); orbax's restore does not read it.
    - `restore(trainer)` reads the newest step, or the one slot of a
      directory that is itself one (`<dir>/<step>/`, `best/`, or an item),
      whichever package wrote it; `restore_best` reads `best/state/`. Every
      parameter and buffer is loaded, the frozen ones too, as JAX restores
      the whole tree; a tensor in another dtype than the trainer's is cast.
      A directory without the extras file (JAX's) restarts the generator
      from `seed + (data rank << 32) + step` and `best_metric` from -inf.

    A trainer sharded over (data, fsdp) or split over `tensor` gathers the
    whole tensors into the unsplit layout (`Trainer.state_dict`, a
    collective on every rank, one parameter at a time) and the primary
    alone writes; every rank
    reads the whole tree and takes its shards (`Trainer.load_state_dict`).
    """

    def __init__(self, directory: str, save_total_limit: int = 1):
        self.directory = os.path.abspath(directory)
        self.keep = max(save_total_limit, 1)
        os.makedirs(self.directory, exist_ok=True)
        # seconds of the last save (gather, layout, write) or restore (read,
        # layout, load)
        self.timings: Dict[str, float] = {}

    def _steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isdir(os.path.join(self.directory, d)))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, trainer, best: bool = False) -> None:
        marks = [time.perf_counter()]
        state = trainer.state_dict()
        marks.append(time.perf_counter())
        if is_primary():
            newest = self.latest_step()
            tree = train_state_tree(trainer, state)
            marks.append(time.perf_counter())
            extras = {"generator": base64.b64encode(state["generator"].numpy().tobytes()).decode(),
                      "generator_device": trainer.generator.device.type,
                      "best_metric": state["best_metric"]}
            item = None
            if newest is None or step > newest:
                item = self._write(str(step), ITEM, {ITEM: _HANDLER}, tree, extras)
            if best:  # the same tree: the step slot's files linked where there is one
                self._write("best", "state", _HANDLER, tree, extras, same_as=item)
            for old in self._steps()[: -self.keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
            marks.append(time.perf_counter())
            logger.info("saved checkpoint step %d%s", step, " (best)" if best else "")
        self.timings = dict(zip(("gather_s", "layout_s", "write_s"),
                                (b - a for a, b in zip(marks, marks[1:]))))
        barrier()

    def _write(self, slot: str, item: str, handlers, tree, extras: Dict[str, Any],
               same_as: Optional[str] = None) -> str:
        """`slot` written whole under a temporary name, then renamed over
        any earlier one -> the item's directory. `handlers`: a manager's
        {item: handler}, recorded in the slot, or a `StandardCheckpointer`'s
        handler, recorded in the item. `same_as`: an item written from the
        same tree, whose files are hard-linked (copied where the file
        system cannot link) in place of encoding the tree again."""
        start = time.time_ns()
        tmp = os.path.join(self.directory, f"{slot}.orbax-checkpoint-tmp-{start}")
        if same_as is None:
            orbax_format.write_tree(os.path.join(tmp, item), tree)
        else:
            shutil.copytree(same_as, os.path.join(tmp, item), copy_function=_link_or_copy)
        meta_dir = os.path.join(tmp, item) if isinstance(handlers, str) else tmp
        _write_json(os.path.join(meta_dir, _CHECKPOINT_METADATA),
                    _checkpoint_metadata(start, handlers))
        _write_json(os.path.join(tmp, EXTRAS_FILE), extras)
        final = os.path.join(self.directory, slot)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return os.path.join(final, item)

    def _item(self, step: Optional[int]) -> str:
        if step is not None:
            return os.path.join(self.directory, str(step), ITEM)
        for item in (ITEM, "state", ""):  # a step slot, a best slot, an item
            if os.path.exists(os.path.join(self.directory, item, "_METADATA")):
                return os.path.join(self.directory, item)
        newest = self.latest_step()
        if newest is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return os.path.join(self.directory, str(newest), ITEM)

    def restore(self, trainer, step: Optional[int] = None) -> None:
        """Load the state of `step` (default: the newest, or the directory's
        one slot) into `trainer`."""
        self._load(trainer, self._item(step))

    def restore_best(self, trainer) -> None:
        self._load(trainer, os.path.join(self.directory, BEST_ITEM))

    def _load(self, trainer, item: str) -> None:
        item = os.path.normpath(item)
        if not os.path.exists(os.path.join(item, "_METADATA")):
            raise FileNotFoundError(f"no checkpoint at {item}")
        marks = [time.perf_counter()]
        tree = {orbax_format.leaf_name(k): t for k, t in orbax_format.read_tree(item)}
        marks.append(time.perf_counter())
        state = state_from_tree(trainer, tree)
        marks.append(time.perf_counter())
        extras_path = os.path.join(os.path.dirname(item), EXTRAS_FILE)
        state["generator"], state["best_metric"] = None, float("-inf")
        if os.path.exists(extras_path):
            with open(extras_path) as f:
                extras = json.load(f)
            state["best_metric"] = float(extras["best_metric"])
            if extras.get("generator_device") == trainer.generator.device.type:
                raw = base64.b64decode(extras["generator"])
                state["generator"] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
            else:
                logger.info("%s: the generator state is for %s; restarting it from the seed",
                            extras_path, extras.get("generator_device"))
        trainer.load_state_dict(state)
        marks.append(time.perf_counter())
        self.timings = dict(zip(("read_s", "layout_s", "load_s"),
                                (b - a for a, b in zip(marks, marks[1:]))))
        logger.info("restored %s at step %d", item, trainer.step)
