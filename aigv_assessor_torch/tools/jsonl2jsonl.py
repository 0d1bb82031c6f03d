"""JSONL -> JSONL cleanup (`aigv_assessor_tpu/tools/jsonl2jsonl.py`): strip
a leading system turn and re-id by line number, line by line (blank lines
skipped, their numbers too).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    args = ap.parse_args(argv)
    with open(args.input) as fin, open(args.output, "w") as fout:
        for i, line in enumerate(fin):
            if not line.strip():
                continue
            item = json.loads(line)
            convs = item.get("conversations", [])
            if convs and convs[0].get("from") == "system":
                item["conversations"] = convs[1:]
            item["id"] = i
            fout.write(json.dumps(item, ensure_ascii=False) + "\n")
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
