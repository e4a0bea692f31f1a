"""Summarise a chrome trace: the top device ops by total time and the
device's busy share (mirrors tools/analyze_trace.py of the JAX package).

    python -m cmda_tpu_torch.tools.analyze_trace TRACE [--top 30]

``TRACE`` is a chrome trace file (``.json`` or ``.json.gz``) or a directory
holding them: ``utils/profiling.trace`` writes ``DIR/trace.json``
(``tools/profile_step.py --trace DIR``), and the JAX profiler's layout,
``DIR/plugins/profile/<run>/*.trace.json.gz``, is read as well. Device
events are the complete events of a ``torch.profiler`` trace in the
categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; in a trace
without categories, those of a process whose name names a device. They
are grouped by name, a trailing ``.N`` instance suffix stripped, and the
top ``--top`` printed by total ms with their count and share. The busy
share is the union of the device events' intervals over the traced window
(the first event's start to the last one's end). A trace with no device
events (a CPU run) is summarised over its CPU ops instead (``lane``
``host``). Prints the table, then one JSON line.
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op"})
DEVICE_PROCESS = re.compile(r"TPU|GPU|device|/device:", re.I)


def find_traces(path: str) -> list[str]:
    """The chrome trace files at ``path`` (a file, or a directory)."""
    if os.path.isfile(path):
        return [path]
    found = []
    for pattern in ("*.json", "*.json.gz",
                    os.path.join("plugins", "profile", "*", "*.trace.json.gz")):
        found += sorted(glob.glob(os.path.join(path, pattern)))
    if not found:
        raise FileNotFoundError(f"no chrome trace (.json, .json.gz) under "
                                f"{path}")
    return found


def load_chrome_events(path: str) -> list[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def _complete(events):
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def device_events(events):
    """(name, start us, duration us) of the device lanes' complete events."""
    proc = {e["pid"]: e.get("args", {}).get("name", "") for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    dev_pids = {p for p, n in proc.items() if DEVICE_PROCESS.search(str(n))}
    out = []
    for e in _complete(events):
        cat = e.get("cat")
        if (cat in DEVICE_CATS if cat is not None
                else e.get("pid") in dev_pids):
            out.append((e["name"], float(e.get("ts", 0.0)), float(e["dur"])))
    return out


def host_events(events):
    """(name, start us, duration us) of the CPU ops."""
    return [(e["name"], float(e.get("ts", 0.0)), float(e["dur"]))
            for e in _complete(events) if e.get("cat") in HOST_CATS]


def group(spans):
    """{name without .N: (total us, count)}, largest first."""
    total, count = collections.Counter(), collections.Counter()
    for name, _, dur in spans:
        key = re.sub(r"\.\d+$", "", name)
        total[key] += dur
        count[key] += 1
    return {k: (v, count[k]) for k, v in total.most_common()}


def busy_us(spans) -> float:
    """The length of the union of the spans' intervals."""
    busy, end = 0.0, None
    for _, ts, dur in sorted(spans, key=lambda s: s[1]):
        if end is None or ts >= end:
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    return busy


def summarize(events, top: int = 30) -> dict:
    """The top groups, the busy time and share over the traced window."""
    spans, lane = device_events(events), "device"
    if not spans:
        spans, lane = host_events(events), "host"
    complete = _complete(events)
    if not complete:
        raise ValueError("the trace holds no complete events")
    start = min(float(e.get("ts", 0.0)) for e in complete)
    stop = max(float(e.get("ts", 0.0)) + float(e["dur"]) for e in complete)
    groups = group(spans)
    grand = sum(t for t, _ in groups.values())
    busy = busy_us(spans)
    return {
        "lane": lane,
        "top": [{"name": k, "total_ms": t / 1e3, "count": n,
                 "avg_us": t / n, "share": t / grand if grand else 0.0}
                for k, (t, n) in list(groups.items())[:top]],
        "distinct_ops": len(groups),
        "total_ms": grand / 1e3,
        "window_ms": (stop - start) / 1e3,
        "busy_ms": busy / 1e3,
        "busy_share": busy / (stop - start) if stop > start else 0.0,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, allow_abbrev=False)
    ap.add_argument("trace")
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args(argv)
    events = []
    for path in find_traces(args.trace):
        events.extend(load_chrome_events(path))
    s = summarize(events, args.top)
    print(f"{'total_ms':>9} {'n':>5} {'avg_us':>9} {'%':>6}  op ({s['lane']})")
    for r in s["top"]:
        print(f"{r['total_ms']:9.2f} {r['count']:5d} {r['avg_us']:9.1f} "
              f"{100 * r['share']:6.2f}  {r['name'][:110]}")
    print(f"\n{s['lane']} total: {s['total_ms']:.1f} ms across "
          f"{s['distinct_ops']} distinct ops; busy {s['busy_ms']:.1f} of "
          f"{s['window_ms']:.1f} ms ({100 * s['busy_share']:.1f}%)")
    print(json.dumps(s), flush=True)
    return s


if __name__ == "__main__":
    main()
