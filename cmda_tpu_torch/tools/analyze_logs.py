"""Read and plot the port's JSON-lines training logs (mirrors
tools/analyze_logs.py of the JAX package; reference tools/analyze_logs.py).

Each line of a ``<time>.log.json`` is the header ({"env": ...}), a train
record ({"loss": ..., "lr": ..., "iter": N, "time": ..., ...}) or an
evaluation ({"iter": N, "eval": {"mIoU": ..., ...}}).

    python -m cmda_tpu_torch.tools.analyze_logs cal_train_time run.log.json
    python -m cmda_tpu_torch.tools.analyze_logs plot_curve a.log.json \\
        [b.log.json ...] --keys loss mIoU --out curves.png

``plot_curve`` needs matplotlib, which it imports when called (the card's
machine has none); everything else needs only the standard library.
"""
from __future__ import annotations

import argparse
import json
import os


def load_log(path: str) -> list[dict]:
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def series(records: list[dict], key: str):
    """(iters, values) of a train metric, or of an evaluation's metric."""
    its, vals = [], []
    for r in records:
        if key in r and "iter" in r:
            its.append(r["iter"])
            vals.append(r[key])
        elif "eval" in r and key in r["eval"]:
            its.append(r["iter"])
            vals.append(r["eval"][key])
    return its, vals


def plot_curve(paths, keys, out=None, title=None):
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_curve needs matplotlib, which is not "
                          "installed; the rest of analyze_logs works "
                          "without it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for path in paths:
        records = load_log(path)
        base = os.path.basename(path)
        for key in keys:
            its, vals = series(records, key)
            if not its:
                print(f"[warn] {key} not found in {base}")
                continue
            marker = "o" if key in ("mIoU", "mAcc", "aAcc") else None
            ax.plot(its, vals, label=f"{base}:{key}", marker=marker,
                    linewidth=1.0)
    ax.set_xlabel("iter")
    ax.legend(fontsize=8)
    if title:
        ax.set_title(title)
    out = out or "log_curves.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(json.dumps({"saved": out}))
    return out


def cal_train_time(path: str) -> dict:
    """Iteration and data time statistics of a log; the first record,
    which holds the start-up, apart."""
    records = load_log(path)
    times = [r["time"] for r in records if "time" in r]
    data_times = [r["data_time"] for r in records if "data_time" in r]
    if not times:
        print(json.dumps({"error": "no time records"}))
        return {}
    stats = {
        "n_records": len(times),
        "mean_iter_time_s": sum(times[1:]) / max(len(times) - 1, 1),
        "first_iter_time_s": times[0],
        "mean_data_time_s": (sum(data_times) / len(data_times)
                             if data_times else None),
        "slowest_iter_s": max(times[1:]) if len(times) > 1 else times[0],
        "fastest_iter_s": min(times[1:]) if len(times) > 1 else times[0],
    }
    print(json.dumps(stats, indent=2))
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("plot_curve")
    p.add_argument("json_logs", nargs="+")
    p.add_argument("--keys", nargs="+", default=["loss"])
    p.add_argument("--out", default=None)
    p.add_argument("--title", default=None)
    p = sub.add_parser("cal_train_time")
    p.add_argument("json_log")
    args = ap.parse_args(argv)
    if args.cmd == "plot_curve":
        return plot_curve(args.json_logs, args.keys, args.out, args.title)
    return cal_train_time(args.json_log)


if __name__ == "__main__":
    main()
