"""The control's readings, from which each limit's upper end is set: the
plain reference computed in float32 with TF32 products, put in the
program's place, against the float64 reference at the cell's own size.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13

One JSON line a seed.  The program's own readings are the ``checks`` of the
benchmark's result lines.  Runs on the card (``--device cpu`` for a try).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(man, name: str, seed: int, device: str, traffic_overrides=None) -> dict:
    import torch

    from benchmark import reference as R

    traffic = dict(man.traffic(man.cell(name)["traffic"]), **(traffic_overrides or {}))
    job = man.entry(traffic["entry"]).Job(man.config(man.cell(name)["config"]), traffic,
                                          seed, device)
    with torch.inference_mode():
        ref = job.reference(0)
        return job.compare(job.reference(0, R.Arith("float32", tf32=True)), ref, 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path[0] = str(ROOT)
    from benchmark.manifest import Manifest

    man = Manifest()
    for s in args.seeds.split(","):
        row = {"workload": args.workload, "seed": int(s),
               "control": readings(man, args.workload, int(s), args.device)}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
