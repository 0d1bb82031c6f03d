"""Video/image loading and preprocessing: a jax-free copy of
`aigv_assessor_tpu/data/video.py`, which the port cannot import (importing
anything under that package imports jax). `tests/test_torch_cli.py` holds it
frame for frame against the original.

Host-side decode + numpy preprocessing, replacing the reference's
decord/PIL/torchvision stack (`LazySupervisedDataset.load_video`,
`stage1_train.py:488-538`):

- frame index math is an exact port of `get_index` (`stage1_train.py:488-500`):
  uniform segment *middles*;
- decode order: the native C++ ffmpeg decoder (`data/native_decode.py`,
  replaces decord) when its library loads, else OpenCV VideoCapture; GIFs
  via PIL (the reference remaps `cogvideo` paths to .gif,
  `stage1_train.py:506-507`);
- transforms mirror `build_transform` (`dataset.py:250-284`): optional JPEG
  degradation augmentation (train), bicubic resize to input_size^2,
  normalize. Output layout is [T, H, W, 3] float32 (NHWC, the layout the
  port's models take).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from aigv_assessor_torch.data.constants import (
    CLIP_MEAN,
    CLIP_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
    SIGLIP_MEAN,
    SIGLIP_STD,
)

NORMALIZE = {
    "imagenet": (IMAGENET_MEAN, IMAGENET_STD),
    "clip": (CLIP_MEAN, CLIP_STD),
    "siglip": (SIGLIP_MEAN, SIGLIP_STD),
}


# ------------------------------------------------------------ frame index ---


def get_frame_indices(
    num_segments: int,
    fps: float,
    max_frame: int,
    first_idx: int = 0,
    bound: Optional[Tuple[float, float]] = None,
) -> np.ndarray:
    """Exact port of `get_index` (`stage1_train.py:488-500`): the middle frame
    of each of `num_segments` uniform segments."""
    if bound:
        start, end = bound[0], bound[1]
    else:
        start, end = -100000, 100000
    start_idx = max(first_idx, round(start * fps))
    end_idx = min(round(end * fps), max_frame)
    seg_size = float(end_idx - start_idx) / num_segments
    return np.array(
        [
            int(start_idx + (seg_size / 2) + np.round(seg_size * idx))
            for idx in range(num_segments)
        ]
    )


# ----------------------------------------------------------------- decode ---


def _read_frames_cv2(video_path: str, indices: Sequence[int]) -> List[Image.Image]:
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {video_path}")
    frames = []
    try:
        for idx in indices:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
            ok, frame = cap.read()
            if not ok:
                raise IOError(f"cannot read frame {idx} of {video_path}")
            frames.append(Image.fromarray(frame[:, :, ::-1]))  # BGR -> RGB
    finally:
        cap.release()
    return frames


def _video_meta_cv2(video_path: str) -> Tuple[int, float]:
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {video_path}")
    try:
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = float(cap.get(cv2.CAP_PROP_FPS)) or 30.0
    finally:
        cap.release()
    return n, fps


def read_video_frames(
    video_path: str,
    num_segments: int = 8,
    bound: Optional[Tuple[float, float]] = None,
    out_size: Optional[int] = None,
) -> List[Image.Image]:
    """Sample `num_segments` frames; decord-equivalent path
    (`stage1_train.py:524-538`). Prefers the native C++ decoder.

    out_size: decode straight to out_size x out_size (libswscale bicubic
    during decode, SIMD, GIL-free) instead of decoding at native resolution
    and resizing in PIL afterwards. Callers pass it only on aug-free paths
    (eval/score/serve ingest): the JPEG-degradation augmentation must see
    native-resolution pixels, and dynamic tiling needs the full frame. A
    decoder library that does not load counts as absent
    (`native_decode.available`): the frames then come from OpenCV."""
    from aigv_assessor_torch.data import native_decode

    if native_decode.available():
        arrs = native_decode.sample_frames(
            video_path, num_segments, bound=bound,
            out_size=(out_size, out_size) if out_size else None,
        )
        return [Image.fromarray(a) for a in arrs]
    n_frames, fps = _video_meta_cv2(video_path)
    indices = get_frame_indices(num_segments, fps, n_frames - 1, 0, bound)
    return _read_frames_cv2(video_path, indices)


def read_gif_frames(
    gif_path: str,
    num_segments: int = 8,
    fps: float = 10.0,
    bound: Optional[Tuple[float, float]] = None,
) -> List[Image.Image]:
    """GIF path with a fixed assumed fps (reference uses 10 for stage-1,
    1 for stage-2 — `stage1_train.py:515`, `stage2_train.py:546`)."""
    frames: List[Image.Image] = []
    with Image.open(gif_path) as img:
        for f in range(img.n_frames):
            img.seek(f)
            frames.append(img.copy().convert("RGB"))
    indices = get_frame_indices(num_segments, fps, len(frames) - 1, 0, bound)
    return [frames[i] for i in indices]


def read_frames_folder(
    folder: str, num_segments: int = 8
) -> List[Image.Image]:
    """Directory-of-frames reader (reference `read_frames_folder`,
    `dataset.py:143-170`)."""
    files = sorted(
        os.path.join(folder, f)
        for f in os.listdir(folder)
        if f.lower().endswith((".jpg", ".jpeg", ".png", ".webp"))
    )
    if not files:
        raise IOError(f"no frames in {folder}")
    indices = np.linspace(0, len(files) - 1, num_segments).astype(np.int64)
    return [Image.open(files[i]).convert("RGB") for i in indices]


def load_video(
    video_path: str,
    num_segments: int = 8,
    gif_fps: float = 10.0,
    bound: Optional[Tuple[float, float]] = None,
    out_size: Optional[int] = None,
) -> List[Image.Image]:
    """Dispatch like the reference `load_video` (`stage1_train.py:503-538`),
    including the cogvideo->.gif remap. out_size: scaled native decode for
    aug-free paths (see read_video_frames); GIF/folder readers ignore it
    (PIL resize happens downstream in transform_frames)."""
    if "cogvideo" in video_path:
        video_path = video_path.split(".mp4")[0] + ".gif"
    if video_path.lower().endswith(".gif"):
        return read_gif_frames(video_path, num_segments, fps=gif_fps, bound=bound)
    if os.path.isdir(video_path):
        return read_frames_folder(video_path, num_segments)
    return read_video_frames(
        video_path, num_segments, bound=bound, out_size=out_size
    )


# ------------------------------------------------------------- transforms ---


def jpeg_degrade(img: Image.Image, quality: int) -> Image.Image:
    """Train-time JPEG degradation augmentation (reference
    `simulate_jpeg_degradation`, `dataset.py:234-246`)."""
    import io

    with io.BytesIO() as buf:
        img.convert("RGB").save(buf, format="JPEG", quality=quality)
        buf.seek(0)
        return Image.open(buf).copy()


def expand2square(img: Image.Image, background_color) -> Image.Image:
    """Pad to square on a mean-colored canvas (reference `expand2square`,
    `dataset.py:220-231`, used when pad2square=True)."""
    width, height = img.size
    if width == height:
        return img
    side = max(width, height)
    result = Image.new(img.mode, (side, side), background_color)
    result.paste(img, ((side - width) // 2, (side - height) // 2))
    return result


def frames_to_uint8(
    frames: Sequence[Image.Image],
    input_size: int = 448,
) -> np.ndarray:
    """PIL frames -> [T, S, S, 3] uint8, resize-only (no normalization).

    Aug-free transport format for scoring ingest: normalization runs on the
    device (`ops/preprocess.resize_normalize`), so batches cross the
    host-to-device link at 1/4 the fp32 bytes. Frames already decoded at
    input_size (scaled native decode) skip the resize."""
    out = np.empty((len(frames), input_size, input_size, 3), np.uint8)
    for i, img in enumerate(frames):
        if img.mode != "RGB":
            img = img.convert("RGB")
        if img.size != (input_size, input_size):
            img = img.resize((input_size, input_size), Image.BICUBIC)
        out[i] = np.asarray(img, np.uint8)
    return out


def transform_frames(
    frames: Sequence[Image.Image],
    input_size: int = 448,
    is_train: bool = False,
    normalize_type: str = "imagenet",
    pad2square: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """PIL frames -> [T, H, W, 3] float32, bicubic resize + normalize
    (reference `build_transform`, `dataset.py:250-284`)."""
    mean, std = NORMALIZE[normalize_type]
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    bg = tuple(int(x * 255) for x in mean)
    out = np.empty((len(frames), input_size, input_size, 3), np.float32)
    for i, img in enumerate(frames):
        if img.mode != "RGB":
            img = img.convert("RGB")
        if is_train:
            rng = rng or np.random.default_rng()
            quality = int(rng.integers(75, 101))
            img = jpeg_degrade(img, quality)
        if pad2square:
            img = expand2square(img, bg)
        if img.size != (input_size, input_size):
            img = img.resize((input_size, input_size), Image.BICUBIC)
        arr = np.asarray(img, np.float32) / 255.0
        out[i] = (arr - mean) / std
    return out


# ------------------------------------------------- dynamic tiling (images) ---


def find_closest_aspect_ratio(aspect_ratio, target_ratios, width, height, image_size):
    """Reference `dataset.py:687-700`."""
    best_ratio_diff = float("inf")
    best_ratio = (1, 1)
    area = width * height
    for ratio in target_ratios:
        target_ar = ratio[0] / ratio[1]
        diff = abs(aspect_ratio - target_ar)
        if diff < best_ratio_diff:
            best_ratio_diff = diff
            best_ratio = ratio
        elif diff == best_ratio_diff:
            if area > 0.5 * image_size * image_size * ratio[0] * ratio[1]:
                best_ratio = ratio
    return best_ratio


def dynamic_preprocess(
    image: Image.Image,
    min_num: int = 1,
    max_num: int = 6,
    image_size: int = 448,
    use_thumbnail: bool = False,
) -> List[Image.Image]:
    """Aspect-ratio tiling for still images (reference `dynamic_preprocess`,
    `dataset.py:702-738`). Video frames use max_num=1 (no tiling,
    `stage1_train.py:522`)."""
    orig_width, orig_height = image.size
    aspect_ratio = orig_width / orig_height

    target_ratios = sorted(
        {
            (i, j)
            for n in range(min_num, max_num + 1)
            for i in range(1, n + 1)
            for j in range(1, n + 1)
            if min_num <= i * j <= max_num
        },
        key=lambda r: r[0] * r[1],
    )
    ratio = find_closest_aspect_ratio(
        aspect_ratio, target_ratios, orig_width, orig_height, image_size
    )
    target_width = image_size * ratio[0]
    target_height = image_size * ratio[1]
    blocks = ratio[0] * ratio[1]

    resized = image.resize((target_width, target_height))
    tiles = []
    cols = target_width // image_size
    for i in range(blocks):
        box = (
            (i % cols) * image_size,
            (i // cols) * image_size,
            ((i % cols) + 1) * image_size,
            ((i // cols) + 1) * image_size,
        )
        tiles.append(resized.crop(box))
    if use_thumbnail and len(tiles) != 1:
        tiles.append(image.resize((image_size, image_size)))
    return tiles
