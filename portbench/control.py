"""The control of the correctness check: the plain reference put in the
program's place and computed one step below the configuration's precision
(its `control` entry: FLOAT / DOUBLE arithmetic in `float`, DECIMAL in
float64 units where `decimal_exact` is false).  Its readings must fail the
cell's limits; the limits were set between them and the program's.

    python3 -m portbench.control --workload <cell> --seeds 5 6 7 [--scale 1] [--device cuda]

For each seed: the cell's tables, then as many answers as a run compares
(`sample_per_template` draws of each template from the seed's client
streams), each computed by the reference in full precision and in the
control's, compared as a run compares the program's.  Prints one JSON line
per seed with the readings beside the limits.  The benchmark's own runs do
not run it.
"""

from __future__ import annotations

import argparse
import gc
import json

from portbench import params as P
from portbench.compare import Reading, compare
from portbench.harness import STREAM_CLIENT, reading_checks, rng
from portbench.spec import Cell


def readings(cell: Cell, seed: int, scale: float, device: str) -> dict:
    import torch

    from portbench.refkit import Ctx

    dev = torch.device(device)
    tables = cell.generator.make(cell.config, seed, scale, dev)
    ctl = cell.config["control"]
    truth = Ctx(dev)
    control = Ctx(dev, fdt=getattr(torch, ctl["float"]), exact=ctl["decimal_exact"])
    total = Reading()
    r = rng(seed, STREAM_CLIENT)
    for name, tpl in cell.templates.items():
        for _ in range(int(cell.mix["sample_per_template"])):
            p = P.draw(tpl.PARAMS, r)
            total.add(compare(tpl.reference(tables, p, control), tpl.reference(tables, p, truth),
                              getattr(tpl, "FLOAT", ()), getattr(tpl, "ORDERED", False)))
    del tables
    gc.collect()
    checks = reading_checks(cell, total)
    return {"workload": cell.name, "seed": seed, "values": total.values,
            "correct": all(c["value"] <= c["limit"] for c in checks.values()), "checks": checks}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.scale, args.device)), flush=True)


if __name__ == "__main__":
    main()
