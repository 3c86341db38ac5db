"""Run every template of a configuration once through the port and compare
it with the reference: the check that each template runs at the size of its
configuration, made before a template joins a mix.

    python3 -m portbench.checks.templates --config tpch_sf10 --seed 7 [--scale 1] [--draws 2]

Prints one JSON line per template and draw: its wall time, the error it
raised if any, and what the comparison found.  Needs a CUDA card unless
given --device cpu.
"""

import argparse
import glob
import json
import os
import time

from portbench import params as P
from portbench.compare import length, compare
from portbench.harness import load_tables, rng, run_query
from portbench.spec import PKG, ROOT, benchmark, load_json, load_module


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--draws", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--templates", nargs="*")
    args = ap.parse_args(argv)

    import torch

    import heavydb_tpu_torch as hdt
    from heavydb_tpu_torch.config import Config
    from portbench.refkit import Ctx

    entry = next(c for c in benchmark()["configs"] if c["name"] == args.config)
    cfg = load_json(os.path.join(ROOT, entry["file"]))
    gen = load_module(os.path.join(PKG, "configs", f"{args.config}.py"), "pb_cfg")
    names = args.templates or sorted(
        os.path.basename(f)[:-3] for f in glob.glob(os.path.join(PKG, "templates", args.config, "*.py"))
        if not f.endswith("__init__.py"))
    db = hdt.connect(device=args.device, config=Config(num_shards=int(cfg.get("shards", 1))))
    t0 = time.perf_counter()
    tables = gen.make(cfg, args.seed, args.scale, db.device)
    load_tables(db, tables)
    print(json.dumps({"made_and_loaded_s": time.perf_counter() - t0,
                      "rows": {n: int(next(iter(t["columns"].values())).shape[0])
                               for n, t in tables.items()}}), flush=True)
    r = rng(args.seed, 99)
    ctx = Ctx(db.device)
    for name in names:
        tpl = load_module(os.path.join(PKG, "templates", args.config, f"{name}.py"), f"pb_{name}")
        for _ in range(args.draws):
            p = P.draw(tpl.PARAMS, r)
            line = {"template": name, "params": p}
            t = time.perf_counter()
            try:
                cols, _, _ = run_query(db, tpl.SQL.format(**p), False)
                line["ms"] = (time.perf_counter() - t) * 1e3
                got = compare(cols, tpl.reference(tables, p, ctx), getattr(tpl, "FLOAT", ()),
                              getattr(tpl, "ORDERED", False))
                line.update(rows=length(cols[0]) if cols else 0, mismatched=got.mismatched,
                            rel_err=got.rel_err, values=got.values)
            except Exception as e:  # the check reports a template that fails
                line["error"] = f"{type(e).__name__}: {str(e)[:300]}"
            if args.device == "cuda":
                line["peak_bytes"] = torch.cuda.max_memory_allocated()
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
