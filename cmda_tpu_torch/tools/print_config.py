"""Print the fully resolved run config of the port's train CLI (mirrors
tools/print_config.py of the JAX package; reference tools/print_config.py).

Takes the train CLI's whole flag surface (the preset, every ablation flag,
the dotted ``--set`` overrides) and prints the resolved config tree as
JSON: what ``python -m cmda_tpu_torch.tools.train`` with the same flags
would train.

    python -m cmda_tpu_torch.tools.print_config --config cs2dsec --events_bins_5_avg_1
    python -m cmda_tpu_torch.tools.print_config --config cs2dz \\
        --set optim.lr=1e-4 --dump resolved.json
"""
from __future__ import annotations

import dataclasses
import json
import sys

from .train import build_config, parse_args


def resolved_config_dict(argv=None):
    """(the resolved config as a dict, the parsed train CLI arguments)."""
    args = parse_args(argv)
    return dataclasses.asdict(build_config(args)), args


def main(argv=None) -> str:
    argv = list(sys.argv[1:] if argv is None else argv)
    dump = None
    if "--dump" in argv:
        i = argv.index("--dump")
        dump = argv[i + 1]
        del argv[i:i + 2]
    cfg_dict, _ = resolved_config_dict(argv)
    text = json.dumps(cfg_dict, indent=2, default=str, sort_keys=True)
    print(text)
    if dump:
        with open(dump, "w") as f:
            f.write(text + "\n")
    return text


if __name__ == "__main__":
    main()
