"""Geo file import — the reference's GDAL import path
(ImportExport/Importer.cpp importGDALGeo / COPY ... WITH
(source_type='geo_file')).  This environment has no GDAL and no egress, so
the formats are parsed natively: GeoJSON (FeatureCollection / single
Feature / bare geometry array) covers the interchange role; geometries
convert to WKT and load through the engine's own geometry parser
(storage/table.py wkt handling), properties become typed columns.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.errors import StorageError

K = T.SQLTypeKind

_GEO_KIND = {
    "Point": K.GEO_POINT,
    "LineString": K.GEO_LINESTRING,
    "Polygon": K.GEO_POLYGON,
    "MultiPolygon": K.GEO_MULTIPOLYGON,
}


def _coords_wkt(c) -> str:
    return f"{c[0]} {c[1]}"


def _ring_wkt(ring) -> str:
    return "(" + ", ".join(_coords_wkt(c) for c in ring) + ")"


def geometry_to_wkt(geom: dict) -> Tuple[str, str]:
    """GeoJSON geometry object → (geojson_type, WKT)."""
    gt = geom.get("type")
    cs = geom.get("coordinates")
    if gt == "Point":
        return gt, f"POINT ({_coords_wkt(cs)})"
    if gt == "LineString":
        return gt, "LINESTRING " + _ring_wkt(cs)
    if gt == "Polygon":
        return gt, "POLYGON (" + ", ".join(_ring_wkt(r) for r in cs) + ")"
    if gt == "MultiPolygon":
        polys = [
            "(" + ", ".join(_ring_wkt(r) for r in poly) + ")" for poly in cs
        ]
        return gt, "MULTIPOLYGON (" + ", ".join(polys) + ")"
    raise StorageError(f"unsupported GeoJSON geometry type {gt!r}")


def _features(doc) -> List[dict]:
    if isinstance(doc, dict):
        t = doc.get("type")
        if t == "FeatureCollection":
            return doc.get("features", [])
        if t == "Feature":
            return [doc]
        if t in _GEO_KIND:
            return [{"type": "Feature", "geometry": doc, "properties": {}}]
    raise StorageError("not a GeoJSON FeatureCollection/Feature/geometry")


def _infer_prop_type(values) -> T.TypeInfo:
    kinds = set()
    for v in values:
        if v is None:
            continue
        if isinstance(v, bool):
            kinds.add("b")
        elif isinstance(v, int):
            kinds.add("i")
        elif isinstance(v, float):
            kinds.add("f")
        else:
            kinds.add("s")
    if kinds <= {"b"}:
        return T.boolean()
    if kinds <= {"i", "b"}:
        mx = max((abs(int(v)) for v in values if v is not None), default=0)
        return T.bigint() if mx >= 2**31 else T.integer()
    if kinds <= {"i", "f", "b"}:
        return T.double()
    return T.text_dict()


def read_geojson(path: str):
    """path → (schema [(name, TypeInfo)], columns {name: list}).  The
    geometry column is named 'geom' (reference GDAL importer default)."""
    with open(path) as fh:
        doc = json.load(fh)
    feats = _features(doc)
    # geometry type: promote mixed Polygon/MultiPolygon to MULTIPOLYGON
    gtypes = set()
    wkts: List[Optional[str]] = []
    for f in feats:
        g = f.get("geometry")
        if g is None:
            wkts.append(None)
            continue
        gt, wkt = geometry_to_wkt(g)
        gtypes.add(gt)
        wkts.append(wkt)
    if gtypes <= {"Polygon", "MultiPolygon"} and len(gtypes) > 1:
        kind = K.GEO_MULTIPOLYGON
        wkts = [
            ("MULTIPOLYGON (" + w[len("POLYGON "):] + ")")
            if w is not None and w.startswith("POLYGON ") else w
            for w in wkts
        ]
    elif len(gtypes) > 1:
        raise StorageError(
            f"mixed GeoJSON geometry types {sorted(gtypes)} need a single "
            "promotable family"
        )
    elif gtypes:
        kind = _GEO_KIND[next(iter(gtypes))]
    else:
        kind = K.GEO_POINT
    # properties: union of keys, order of first appearance
    prop_names: List[str] = []
    for f in feats:
        for k in (f.get("properties") or {}):
            if k not in prop_names:
                prop_names.append(k)
    cols: Dict[str, list] = {p: [] for p in prop_names}
    for f in feats:
        props = f.get("properties") or {}
        for p in prop_names:
            v = props.get(p)
            cols[p].append(
                str(v) if isinstance(v, (dict, list)) else v
            )
    schema = [(p, _infer_prop_type(cols[p])) for p in prop_names]
    # GeoJSON is WGS84 by spec → SRID 4326
    schema.append(("geom", T.geo(kind, srid=4326)))
    cols["geom"] = wkts
    return schema, cols


def import_geo(db, table_name: str, path: str, options: Dict) -> int:
    """COPY ... WITH (source_type='geo_file') — auto-creates the table when
    absent (schema from properties + geometry), else appends."""
    import numpy as np

    schema, cols = read_geojson(path)
    t = db.catalog.get_table_opt(table_name)
    if t is None:
        t = db.catalog.create_table(table_name, schema)
    arrays = {c: np.array(v, dtype=object) for c, v in cols.items()}
    n = len(next(iter(arrays.values()))) if arrays else 0
    if n:
        db._insert_columns(t, arrays)
    return n
