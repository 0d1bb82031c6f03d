"""Parallel video frame extraction
(`aigv_assessor_tpu/tools/extract_video_frames.py`): sample N frames per
video through `data/video.load_video` (the native decoder, OpenCV or PIL)
and write them as `<video name>/<i:04d>.jpg` (quality 95), the videos on a
thread pool.

Usage:
  python -m aigv_assessor_torch.tools.extract_video_frames \\
      --video_dir videos/ --out_dir frames/ --num_frames 8 --workers 8
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

from aigv_assessor_torch.data.video import load_video

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".gif")


def extract_one(video_path: str, out_dir: str, num_frames: int) -> int:
    name = os.path.splitext(os.path.basename(video_path))[0]
    dst = os.path.join(out_dir, name)
    os.makedirs(dst, exist_ok=True)
    frames = load_video(video_path, num_segments=num_frames)
    for i, img in enumerate(frames):
        img.save(os.path.join(dst, f"{i:04d}.jpg"), quality=95)
    return len(frames)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--video_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--num_frames", type=int, default=8)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)
    videos = [os.path.join(args.video_dir, f) for f in sorted(os.listdir(args.video_dir))
              if f.lower().endswith(VIDEO_EXTS)]
    os.makedirs(args.out_dir, exist_ok=True)
    with ThreadPoolExecutor(args.workers) as pool:
        futures = [pool.submit(extract_one, v, args.out_dir, args.num_frames) for v in videos]
        done = sum(1 for f in futures if f.result())
    print(f"extracted frames for {done}/{len(videos)} videos into {args.out_dir}")


if __name__ == "__main__":
    main()
