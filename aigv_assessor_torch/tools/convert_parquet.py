"""OCR parquet -> JSONL (`aigv_assessor_tpu/tools/convert_parquet.py`): read
parquet shards of (image, question, answer) rows, write each image as
`<n:08d>.jpg` into `--image_dir` and one conversation per line into
`--output`.

It needs pandas (with pyarrow) and PIL, imported when it runs; a machine
without pandas cannot run it.
"""

from __future__ import annotations

import argparse
import io
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("inputs", nargs="+", help="parquet files")
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--image_key", default="image")
    ap.add_argument("--question_key", default="question")
    ap.add_argument("--answer_key", default="answer")
    args = ap.parse_args(argv)

    import pandas as pd
    from PIL import Image

    os.makedirs(args.image_dir, exist_ok=True)
    n = 0
    with open(args.output, "w") as fout:
        for path in args.inputs:
            for _, row in pd.read_parquet(path).iterrows():
                img_val = row[args.image_key]
                if isinstance(img_val, dict) and "bytes" in img_val:
                    img_val = img_val["bytes"]
                img = Image.open(io.BytesIO(img_val)).convert("RGB")
                img_name = f"{n:08d}.jpg"
                img.save(os.path.join(args.image_dir, img_name))
                item = {
                    "id": n,
                    "image": img_name,
                    "conversations": [
                        {"from": "human", "value": f"<image>\n{row[args.question_key]}"},
                        {"from": "gpt", "value": str(row[args.answer_key])},
                    ],
                }
                fout.write(json.dumps(item, ensure_ascii=False) + "\n")
                n += 1
    print(f"wrote {n} samples to {args.output}")


if __name__ == "__main__":
    main()
