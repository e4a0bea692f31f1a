"""Merge the per-segment JSON-lines train logs of a segmented run into one
stream (mirrors tools/merge_segment_logs.py of the JAX package).

``tools/train_chunked.py`` leaves one ``<timestamp>.log.json`` per segment
process, and a segment that died and was replayed leaves overlapping
iteration ranges. The files are read in the order of their timestamped
names; for records with an ``iter``, a later file's record replaces an
earlier one's (the last attempt at an iteration is the one whose state the
checkpoints carried on); a train record of iteration N comes before the
evaluation of iteration N. Records without ``iter`` (the env header) are
taken from the first file.

    python -m cmda_tpu_torch.tools.merge_segment_logs work_dirs/run out.log.json
"""
from __future__ import annotations

import glob
import json
import os
import sys


def merge(work_dir: str) -> list[dict]:
    files = sorted(glob.glob(os.path.join(work_dir, "*.log.json")))
    header = None
    by_iter = {}         # (iter, kind) -> record; kind: 'train' | 'eval'
    for path in files:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                if "iter" not in d:
                    if header is None:
                        header = d
                    continue
                kind = "eval" if "eval" in d else "train"
                by_iter[(d["iter"], kind)] = d
    out = [header] if header else []
    out += [by_iter[k] for k in sorted(by_iter,
                                       key=lambda k: (k[0], k[1] == "eval"))]
    return out


def main(argv=None) -> list[dict]:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        sys.exit("usage: merge_segment_logs WORK_DIR OUT.log.json")
    work_dir, out_path = argv
    records = merge(work_dir)
    with open(out_path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    evals = [r for r in records if "eval" in r]
    print(json.dumps({"records": len(records), "evals": [
        (r["iter"], round(r["eval"]["mIoU"] * 100, 2)) for r in evals]}))
    return records


if __name__ == "__main__":
    main()
