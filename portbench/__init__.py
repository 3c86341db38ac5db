"""The benchmark of heavydb_tpu_torch: `python3 -m portbench.run --workload <cell>`.

See README.md.  Importing this package imports neither torch nor the port.
"""
