"""The synthetic benchmark's table, made on the device from the seed.

A copy of `heavydb_tpu_torch/tools/synthetic.py` `load_bench`, split into
making the columns (here) and loading them (the harness): uniform INT
columns in [1, card], sparse BIGINT columns randint(1, card) * step, and
`v FLOAT` uniform in [0, 1).  `scale` multiplies the row count (tests).
"""

import torch


def make(cfg: dict, seed: int, scale: float, device) -> dict:
    n = max(int(cfg["rows"] * scale), 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    cols = {c: torch.randint(1, k + 1, (n,), dtype=torch.int32, device=device, generator=gen)
            for c, k in cfg["int_columns"].items()}
    for c, (k, step) in cfg["sparse_columns"].items():
        cols[c] = torch.randint(1, k + 1, (n,), dtype=torch.int64, device=device,
                                generator=gen) * step
    for c in cfg["float_columns"]:
        cols[c] = torch.rand(n, dtype=torch.float32, device=device, generator=gen)
    decl = ", ".join([f"{c} INT" for c in cfg["int_columns"]]
                     + [f"{c} BIGINT" for c in cfg["sparse_columns"]]
                     + [f"{c} FLOAT" for c in cfg["float_columns"]])
    frag = max(int(cfg["fragment_rows"] * scale), 1)
    return {cfg["table"]: {
        "ddl": f"CREATE TABLE {cfg['table']} ({decl}) WITH (fragment_size={frag})",
        "columns": cols}}
