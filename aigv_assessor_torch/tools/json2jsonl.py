"""Annotation JSON -> JSONL (`aigv_assessor_tpu/tools/json2jsonl.py`): read
a JSON list of samples, strip a leading system turn from `conversations`,
re-id sequentially (a string id is kept), write one JSON object per line.
"""

from __future__ import annotations

import argparse
import json


def convert(rows):
    out = []
    for i, item in enumerate(rows):
        convs = item.get("conversations", [])
        if convs and convs[0].get("from") == "system":
            convs = convs[1:]
        item = dict(item)
        item["conversations"] = convs
        item["id"] = item.get("id", i) if isinstance(item.get("id"), str) else i
        out.append(item)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    args = ap.parse_args(argv)
    with open(args.input) as f:
        rows = json.load(f)
    with open(args.output, "w") as f:
        for item in convert(rows):
            f.write(json.dumps(item, ensure_ascii=False) + "\n")
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
