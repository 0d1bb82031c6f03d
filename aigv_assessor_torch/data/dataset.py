"""JSONL video / image / text datasets and the meta registry: a jax-free
copy of `aigv_assessor_tpu/data/dataset.py` (`tests/test_torch_eval.py`
holds ids, labels, masks and pixels against it).

The meta JSON, as the reference's `shell/data/my.json`:

    {name: {root, annotation_train / annotation_test (train) or annotation
            (eval), repeat_time, data_augment, length}}

A JSONL line: {"video": path, "id": str, "mos": float, "conversations":
[{"from": "human", ...}, {"from": "gpt", ...}]}.

- `Sample`: one collate-ready example (numpy, host side).
- `parse_mos`: the `mos` key, else the `id` suffix after '->'.
- `VideoQualityDataset`: map-style; `video_get_item` decodes `num_segments`
  frames (GIFs at `gif_fps`), writes the `Frame{i}: <image>` lines and the
  motion slot into the prompt, and tokenizes through the template's masker;
  `get_text_item` / `get_pixel_item(_uint8)` split that for the fused
  multi-perspective eval. Failures raise unless `retry_on_error`.
- `WeightedConcatDataset`: deterministic concatenation (eval visits every
  sample once).
- `load_meta`, `build_datasets`: one dataset per meta entry.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np

from aigv_assessor_torch.core.config import AssessorConfig
from aigv_assessor_torch.data.preprocess import get_preprocess_function
from aigv_assessor_torch.data.tokenizer import AIGVTokenizer
from aigv_assessor_torch.data.video import (
    dynamic_preprocess,
    frames_to_uint8,
    load_video,
    transform_frames,
)

logger = logging.getLogger(__name__)


@dataclass
class Sample:
    """One collate-ready example (numpy; host side)."""

    video_name: str
    answer: str
    mos: float
    input_ids: np.ndarray  # [S]
    labels: np.ndarray  # [S]
    attention_mask: np.ndarray  # [S]
    pixel_values: np.ndarray  # [T, H, W, 3]
    image_flags: np.ndarray  # [T]
    length: int = 0


def parse_mos(item: Dict[str, Any]) -> float:
    """`mos` key, falling back to the `id` suffix after '->' that the bundled
    sample JSONLs use (`shell/data/mydata_mos1_train.jsonl`, SURVEY.md §0)."""
    if "mos" in item:
        return float(item["mos"])
    id_ = item.get("id", "")
    if "->" in id_:
        return float(id_.rsplit("->", 1)[1])
    raise KeyError(f"sample has no mos: id={id_!r}")


class VideoQualityDataset:
    """Lazy JSONL dataset; map-style (len / __getitem__)."""

    def __init__(
        self,
        annotation_path: str,
        tokenizer: AIGVTokenizer,
        config: AssessorConfig,
        root: str = "",
        is_train: bool = True,
        num_segments: int = 8,
        normalize_type: str = "imagenet",
        group_by_length: bool = False,
        repeat_time: float = 1.0,
        gif_fps: float = 10.0,
        mos_scale: float = 1.0,
        retry_on_error: bool = False,
        max_retries: int = 10,
        ds_name: Optional[str] = None,
        seed: int = 0,
    ):
        self.tokenizer = tokenizer
        self.config = config
        self.root = root
        self.is_train = is_train
        self.num_segments = num_segments
        self.normalize_type = normalize_type
        self.group_by_length = group_by_length
        self.gif_fps = gif_fps
        self.mos_scale = mos_scale
        self.retry_on_error = retry_on_error
        self.max_retries = max_retries
        self.ds_name = ds_name or os.path.basename(annotation_path)
        self._rng = np.random.default_rng(seed)

        with open(annotation_path) as f:
            self.raw_data = [json.loads(line) for line in f if line.strip()]
        # repeat_time semantics from build_datasets (`stage1_train.py:691-696`)
        if repeat_time < 1:
            self.raw_data = self.raw_data[: int(len(self.raw_data) * repeat_time)]
        elif repeat_time > 1:
            self.raw_data = self.raw_data * int(repeat_time)

        image_size = config.force_image_size or config.vision.image_size
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.raw_data)

    def _decode_out_size(self) -> Optional[int]:
        """Scaled native decode target for aug-free video paths: eval and
        scoring decode straight to image_size instead of native-size decode
        + PIL resize, which bounds a fused eval on the host. Training keeps
        native decode: the JPEG-degradation augmentation must see
        full-resolution pixels, and pad2square changes geometry."""
        if self.is_train or self.config.pad2square:
            return None
        return self.image_size

    # ------------------------------------------------------------- items ---

    def video_get_item(self, data_item: Dict[str, Any]) -> Sample:
        """Port of `video_get_item` (`stage1_train.py:541-597`)."""
        cfg = self.config
        conversations = [dict(c) for c in data_item["conversations"]]
        if "<video>" not in conversations[0]["value"]:
            conversations[0]["value"] = "<video>\n" + conversations[0]["value"]

        video_path = os.path.join(self.root, data_item["video"])
        frames = load_video(
            video_path, num_segments=self.num_segments, gif_fps=self.gif_fps,
            out_size=self._decode_out_size(),
        )

        # `Frame{i}: <image>` lines + motion slot (`stage1_train.py:559-563`)
        special_tokens = "\n".join(
            f"Frame{i + 1}: <image>" for i in range(len(frames))
        )
        special_tokens += "\nMotion Feature: <image>"
        conversations[0]["value"] = conversations[0]["value"].replace(
            "<video>\n", special_tokens
        )

        pixel_values = transform_frames(
            frames,
            input_size=self.image_size,
            is_train=self.is_train,
            normalize_type=self.normalize_type,
            pad2square=self.config.pad2square,
            rng=self._rng,
        )
        num_patches = len(frames) + 1  # + motion slot

        num_image_tokens = [cfg.num_image_token] * num_patches
        num_image_tokens[-1] = 1  # the motion slot is a single token
        preprocess_fn = get_preprocess_function(cfg.template)
        ret = preprocess_fn(
            cfg.template,
            [conversations],
            self.tokenizer,
            num_image_tokens,
            group_by_length=self.group_by_length,
            ds_name=self.ds_name,
        )[0]
        if ret.mismatch:
            logger.warning(
                "tokenization mismatch in %s (sample %s): labels fully masked",
                self.ds_name,
                data_item.get("id"),
            )

        mos = parse_mos(data_item) * self.mos_scale
        return Sample(
            video_name=data_item["video"],
            answer=data_item["conversations"][1]["value"],
            mos=mos,
            input_ids=ret.input_ids,
            labels=ret.labels,
            attention_mask=ret.attention_mask,
            pixel_values=pixel_values,
            image_flags=np.ones(len(frames), np.int32),
            length=int(ret.attention_mask.sum()),
        )

    def image_get_item(self, data_item: Dict[str, Any]) -> Sample:
        """Single-image path with dynamic tiling (reference `multi_modal_get_item`)."""
        cfg = self.config
        conversations = [dict(c) for c in data_item["conversations"]]
        if "<image>" not in conversations[0]["value"]:
            conversations[0]["value"] = "<image>\n" + conversations[0]["value"]
        from aigv_assessor_torch.data.storage import is_remote, open_image

        # s3://-style roots are PREPENDED like the reference
        # (`stage1_train.py:470-476`): remote prefixing concatenates
        if is_remote(self.root) or is_remote(data_item["image"]):
            image_path = self.root + data_item["image"]
        else:
            image_path = os.path.join(self.root, data_item["image"])
        image = open_image(image_path)
        tiles = dynamic_preprocess(
            image,
            min_num=cfg.min_dynamic_patch,
            max_num=cfg.max_dynamic_patch if cfg.dynamic_image_size else 1,
            image_size=self.image_size,
            use_thumbnail=cfg.use_thumbnail,
        )
        pixel_values = transform_frames(
            tiles,
            input_size=self.image_size,
            is_train=self.is_train,
            normalize_type=self.normalize_type,
            rng=self._rng,
        )
        num_patches = len(tiles)
        preprocess_fn = get_preprocess_function(cfg.template)
        ret = preprocess_fn(
            cfg.template,
            [conversations],
            self.tokenizer,
            [cfg.num_image_token * num_patches],
            group_by_length=self.group_by_length,
            ds_name=self.ds_name,
        )[0]
        mos = 0.0
        try:
            mos = parse_mos(data_item) * self.mos_scale
        except KeyError:
            pass
        return Sample(
            video_name=data_item.get("image", ""),
            answer=data_item["conversations"][1]["value"],
            mos=mos,
            input_ids=ret.input_ids,
            labels=ret.labels,
            attention_mask=ret.attention_mask,
            pixel_values=pixel_values,
            image_flags=np.ones(num_patches, np.int32),
            length=int(ret.attention_mask.sum()),
        )

    def pure_text_get_item(self, data_item: Dict[str, Any]) -> Sample:
        """Text-only path (reference `pure_text_get_item`): a blank image is
        still encoded so the graph shape stays static, but its flags are 0."""
        cfg = self.config
        ret = get_preprocess_function(cfg.template)(
            cfg.template,
            [data_item["conversations"]],
            self.tokenizer,
            [],
            text_only=True,
            group_by_length=self.group_by_length,
            ds_name=self.ds_name,
        )[0]
        blank = np.zeros((1, self.image_size, self.image_size, 3), np.float32)
        return Sample(
            video_name="",
            answer=data_item["conversations"][1]["value"],
            mos=0.0,
            input_ids=ret.input_ids,
            labels=ret.labels,
            attention_mask=ret.attention_mask,
            pixel_values=blank,
            image_flags=np.zeros(1, np.int32),
            length=int(ret.attention_mask.sum()),
        )

    def get_text_item(self, i: int) -> Sample:
        """Tokenize video sample i WITHOUT decoding the video: identical
        prompt construction to `video_get_item` (the token layout depends
        only on `num_segments`), with empty pixel_values. Feeds the fused
        multi-perspective evaluator, where the frames are decoded ONCE from
        one perspective's dataset and the P-1 siblings contribute prompts
        and MOS labels only."""
        cfg = self.config
        data_item = self.raw_data[i]
        if "video" not in data_item:
            raise ValueError(f"get_text_item is for video samples, not {data_item.get('id')!r}")
        conversations = [dict(c) for c in data_item["conversations"]]
        if "<video>" not in conversations[0]["value"]:
            conversations[0]["value"] = "<video>\n" + conversations[0]["value"]
        special_tokens = "\n".join(
            f"Frame{j + 1}: <image>" for j in range(self.num_segments)
        )
        special_tokens += "\nMotion Feature: <image>"
        conversations[0]["value"] = conversations[0]["value"].replace(
            "<video>\n", special_tokens
        )
        num_image_tokens = [cfg.num_image_token] * self.num_segments + [1]
        preprocess_fn = get_preprocess_function(cfg.template)
        ret = preprocess_fn(
            cfg.template,
            [conversations],
            self.tokenizer,
            num_image_tokens,
            group_by_length=self.group_by_length,
            ds_name=self.ds_name,
        )[0]
        mos = parse_mos(data_item) * self.mos_scale
        return Sample(
            video_name=data_item["video"],
            answer=data_item["conversations"][1]["value"],
            mos=mos,
            input_ids=ret.input_ids,
            labels=ret.labels,
            attention_mask=ret.attention_mask,
            pixel_values=np.zeros((0,), np.float32),
            image_flags=np.zeros((0,), np.int32),
            length=int(ret.attention_mask.sum()),
        )

    def get_pixel_item(self, i: int) -> np.ndarray:
        """Decode + transform video sample i's frames WITHOUT tokenizing:
        the pixel-side complement of `get_text_item`. The fused evaluator
        already holds the tokens from `get_text_item`; running the full
        `__getitem__` just to reach `.pixel_values` would re-template and
        re-tokenize the conversation per video."""
        data_item = self.raw_data[i]
        if "video" not in data_item:
            raise ValueError(f"get_pixel_item is for video samples, not {data_item.get('id')!r}")
        frames = load_video(
            os.path.join(self.root, data_item["video"]),
            num_segments=self.num_segments,
            gif_fps=self.gif_fps,
            out_size=self._decode_out_size(),
        )
        return transform_frames(
            frames,
            input_size=self.image_size,
            is_train=self.is_train,
            normalize_type=self.normalize_type,
            pad2square=self.config.pad2square,
            rng=self._rng,
        )

    def supports_uint8_pixels(self) -> bool:
        """uint8 transport is semantics-safe only on aug-free geometry:
        no JPEG-degradation aug (train) and no pad2square (the mean-color
        canvas is baked in before normalization)."""
        return not self.is_train and not self.config.pad2square

    def get_pixel_item_uint8(self, i: int) -> np.ndarray:
        """Like `get_pixel_item` but returns [T, S, S, 3] uint8 with
        normalization DEFERRED to the device (see `frames_to_uint8`):
        1/4 the host->device bytes of the fp32 form. Callers normalize on
        the device with `ops/preprocess.resize_normalize(normalize_type=...)`."""
        if not self.supports_uint8_pixels():
            raise ValueError("uint8 pixels need an aug-free dataset without pad2square")
        data_item = self.raw_data[i]
        if "video" not in data_item:
            raise ValueError(f"get_pixel_item is for video samples, not {data_item.get('id')!r}")
        frames = load_video(
            os.path.join(self.root, data_item["video"]),
            num_segments=self.num_segments,
            gif_fps=self.gif_fps,
            out_size=self._decode_out_size(),
        )
        return frames_to_uint8(frames, input_size=self.image_size)

    def _get(self, i: int) -> Sample:
        data_item = self.raw_data[i]
        if "video" in data_item:
            return self.video_get_item(data_item)
        if "image" in data_item:
            return self.image_get_item(data_item)
        return self.pure_text_get_item(data_item)

    def __getitem__(self, i: int) -> Sample:
        if not self.retry_on_error:
            return self._get(i)
        last_err = None
        for _ in range(self.max_retries):
            try:
                return self._get(i)
            except Exception as e:  # noqa: BLE001 — mirrors reference retry
                logger.warning("sample %d failed (%s); retrying random index", i, e)
                last_err = e
                i = int(self._rng.integers(0, len(self)))
        raise RuntimeError(
            f"dataset failed {self.max_retries} consecutive samples"
        ) from last_err


class WeightedConcatDataset:
    """Concatenation of datasets (reference `WeightedConcatDataset`,
    `dataset.py:173-184`, a ConcatDataset whose WEIGHTS live in a separate
    train-time sampler).

    __getitem__ is DETERMINISTIC concat indexing: the reference's
    size-proportional-with-replacement sampling is marginally equivalent to
    a uniform shuffle over the concatenation (its weights are proportional
    to dataset size), which is exactly what the train ShardedBatchSampler
    does — and eval must visit every sample exactly once."""

    def __init__(self, datasets: Sequence[VideoQualityDataset], seed: int = 0):
        self.datasets = list(datasets)
        sizes = [len(d) for d in self.datasets]
        self.offsets = np.cumsum([0] + sizes)
        self.total = int(self.offsets[-1])

    def __len__(self) -> int:
        return self.total

    def __getitem__(self, i: int) -> Sample:
        if i < 0:
            i += self.total
        if not 0 <= i < self.total:
            raise IndexError(i)
        di = int(np.searchsorted(self.offsets, i, side="right") - 1)
        return self.datasets[di][int(i - self.offsets[di])]


@dataclass
class MetaEntry:
    root: str = ""
    annotation: Optional[str] = None
    annotation_train: Optional[str] = None
    annotation_test: Optional[str] = None
    repeat_time: float = 1.0
    data_augment: bool = False
    length: Optional[int] = None


def load_meta(path: str) -> Dict[str, MetaEntry]:
    """Parse the dataset meta JSON (`shell/data/my.json:1-10`)."""
    with open(path) as f:
        raw = json.load(f)
    out = {}
    for name, e in raw.items():
        out[name] = MetaEntry(
            root=e.get("root", ""),
            annotation=e.get("annotation"),
            annotation_train=e.get("annotation_train"),
            annotation_test=e.get("annotation_test"),
            repeat_time=float(e.get("repeat_time", 1.0)),
            data_augment=bool(e.get("data_augment", False)),
            length=e.get("length"),
        )
    return out


def build_datasets(
    meta_path: str,
    tokenizer: AIGVTokenizer,
    config: AssessorConfig,
    split: str = "train",  # 'train' | 'test' | 'eval'
    num_segments: int = 8,
    group_by_length: bool = False,
    mos_scale: float = 1.0,
    gif_fps: float = 10.0,
    retry_on_error: bool = False,
    seed: int = 0,
    normalize_type: str = "imagenet",
):
    """Reference `build_datasets` (`stage1_train.py:673-726`): one dataset per
    meta entry, weighted-concatenated."""
    metas = load_meta(meta_path)
    datasets = []
    for name, meta in metas.items():
        if split == "train":
            ann = meta.annotation_train or meta.annotation
        elif split == "test":
            ann = meta.annotation_test or meta.annotation
        else:
            ann = meta.annotation or meta.annotation_test
        if ann is None:
            raise ValueError(f"meta entry {name!r} has no annotation for {split}")
        datasets.append(
            VideoQualityDataset(
                ann,
                tokenizer,
                config,
                root=meta.root,
                is_train=(split == "train" and meta.data_augment),
                num_segments=num_segments,
                group_by_length=group_by_length,
                repeat_time=meta.repeat_time if split == "train" else 1.0,
                mos_scale=mos_scale,
                gif_fps=gif_fps,
                retry_on_error=retry_on_error,
                ds_name=name,
                seed=seed,
                normalize_type=normalize_type,
            )
        )
    if len(datasets) == 1:
        return datasets[0]
    return WeightedConcatDataset(datasets, seed=seed)
