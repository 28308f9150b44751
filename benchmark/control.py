"""The control of ``correct``: the reference in the nearest precision below
the program's, put in the program's place and held to the reference by
the cell's own numbers, at the cell's size: bfloat16 for the float32
search costs (the intra search and screen, the host motion search's RD
costs, K8's sums), float32 for rdoq's float64 costs. The program runs a
short window at the cell's own load first, so that the inter stages and
rdoq are recomputed from what the program gave them on the frames and
calls a run of that seed draws.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 20]

prints one JSON line a seed with each number's reading and its limit; a
sound control reads above a limit on every seed. The benchmark's runs do
not run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness import cli, spec  # noqa: E402


def control(cell: spec.Cell, seed: int, device: str, seconds: float,
            overrides: dict | None = None) -> dict:
    import torch
    out = cli.run_cell(cell, seed, seconds, False, device=device,
                       overrides=overrides, control=torch.bfloat16)
    return {"workload": cell.name, "seed": seed,
            "control_passes": out["correct"], "checks": out["checks"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    cell = spec.Cell(spec.benchmark(), args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(control(cell, int(s), "cuda", args.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
