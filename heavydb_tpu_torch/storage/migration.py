"""Catalog migrations across on-disk versions (reference
MigrationMgr/MigrationMgr.h:31 — e.g. the 4.x date-in-days rebrand and
render-group drop ran exactly this way: detect version, apply stepwise
transforms, stamp the new version).

Every persisted catalog carries a `version`; on load the chain of
migrations from its version to CATALOG_VERSION runs in order, so a
database written by any older build opens cleanly.
"""

from __future__ import annotations

from typing import Callable, Dict

CATALOG_VERSION = 2


def _migrate_1_to_2(data: dict) -> dict:
    """v2 adds per-table SHARD KEY metadata (shard_key/shard_count)."""
    for tm in data.get("tables", []):
        tm.setdefault("shard_key", None)
        tm.setdefault("shard_count", 0)
    data["version"] = 2
    return data


_MIGRATIONS: Dict[int, Callable[[dict], dict]] = {
    1: _migrate_1_to_2,
}


def migrate_catalog(data: dict) -> dict:
    """Bring a loaded catalog payload to CATALOG_VERSION (idempotent)."""
    v = int(data.get("version", 1))
    if v > CATALOG_VERSION:
        raise RuntimeError(
            f"catalog version {v} is newer than this build "
            f"({CATALOG_VERSION}); refusing to downgrade"
        )
    while v < CATALOG_VERSION:
        step = _MIGRATIONS.get(v)
        if step is None:
            raise RuntimeError(f"no migration from catalog version {v}")
        data = step(data)
        nv = int(data["version"])
        assert nv > v, "migration must advance the version"
        v = nv
    return data
