"""Geo columns and ST_* functions: heavydb_tpu_torch against the JAX
package.

The same statements run in heavydb_tpu.connect() and
heavydb_tpu_torch.connect(device="cpu"); every query gives the
reference's rows.  The cases are those of tests/test_geo.py,
tests/test_geoint.py and tests/test_geo_construct.py but persistence:
WKT storage and egress of points, linestrings, polygons with holes and
multipolygons, NULL geometries, GEOINT32-compressed and uncompressed
columns, ST_X / ST_Y, ST_Distance, ST_DWithin, ST_Contains (a row's own
point, a literal point, a literal polygon), ST_Within, ST_Intersects,
ST_Area / Perimeter / Length / NPoints / NRings, ST_Centroid, ST_SRID,
ST_XMin .. ST_YMax, ST_Transform, ST_AsText, and the constructors
ST_Buffer / ST_Intersection / ST_Difference / ST_Union (ops/
geo_construct.py, copied); and the codec and constructor modules
themselves against the reference's on seeded geometries.

Tolerances: integers and booleans exact; DOUBLE rtol 1e-9; a WKT string
equal, or equal in its words with every coordinate within 1e-7 (the
reference's GEOINT32 egress tolerance).
"""

import math
import re

import numpy as np
import pytest

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
from heavydb_tpu import types as JT
from heavydb_tpu.ops import geo_construct as JGC
from heavydb_tpu.storage import table as JTAB
from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.ops import geo_construct as GC
from heavydb_tpu_torch.storage import table as TAB

_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def _pair():
    return hdt.connect(), hdt_torch.connect(device="cpu")


def _both(dbs, *stmts):
    for db in dbs:
        for s in stmts:
            db.sql(s)


def _norm(v):
    return None if isinstance(v, float) and math.isnan(v) else v


def _close(a, b):
    if isinstance(b, float) and a is not None:
        return a == pytest.approx(b, rel=1e-9)
    if isinstance(a, str) and isinstance(b, str) and a != b:
        na, nb = _NUM.findall(a), _NUM.findall(b)
        return _NUM.sub("#", a) == _NUM.sub("#", b) and len(na) == len(nb) and all(
            abs(float(x) - float(y)) <= 1e-7 for x, y in zip(na, nb))
    return a == b


def check(dbs, sql, ordered=None):
    ref, port = dbs
    want = [tuple(_norm(v) for v in r) for r in ref.sql(sql).rows()]
    got = [tuple(_norm(v) for v in r) for r in port.sql(sql).rows()]
    if not ("ORDER BY" in sql.upper() if ordered is None else ordered):
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(_close(a, b) for a, b in zip(g, w)), (sql, g, w)
    return got


# ---------------------------------------------------------------------------
# tests/test_geo.py, tests/test_geoint.py
# ---------------------------------------------------------------------------

GEO_TABLES = [
    "CREATE TABLE geo (id INT, p POINT, zone GEOMETRY(POLYGON, 4326))",
    "INSERT INTO geo VALUES (1, 'POINT(1 1)', 'POLYGON((0 0, 4 0, 4 4, 0 4, 0 0))'), "
    "(2, 'POINT(10 10)', 'POLYGON((0 0, 2 0, 2 2, 0 2, 0 0))'), (3, NULL, NULL)",
    "CREATE TABLE pts (a POINT, b POINT)",
    "INSERT INTO pts VALUES ('POINT(0 0)', 'POINT(3 4)')",
    "CREATE TABLE ln (path LINESTRING)",
    "INSERT INTO ln VALUES ('LINESTRING(0 0, 3 4, 3 8)')",
    "CREATE TABLE mr (poly POLYGON, mp MULTIPOLYGON)",
    "INSERT INTO mr VALUES ('POLYGON((0 0, 10 0, 10 10, 0 10), (4 4, 6 4, 6 6, 4 6))', "
    "'MULTIPOLYGON(((0 0, 2 0, 2 2, 0 2)), ((5 5, 7 5, 7 7, 5 7)))')",
    "CREATE TABLE si (poly POLYGON, ln LINESTRING, p POINT)",
    "INSERT INTO si VALUES ('POLYGON((0 0, 4 0, 4 4, 0 4))', 'LINESTRING(-1 -1, 5 5)', "
    "'POINT(2 2)')",
    "INSERT INTO si VALUES ('POLYGON((10 10, 12 10, 12 12, 10 12))', "
    "'LINESTRING(20 20, 21 21)', 'POINT(30 30)')",
    "CREATE TABLE pz (id INT, z POLYGON)",
    "INSERT INTO pz VALUES (1, 'POLYGON((0 0, 4 0, 4 4, 0 4, 0 0),(1 1, 2 1, 2 2, 1 2, 1 1))'), "
    "(2, 'POLYGON((0 0, 1 0, 1 1, 0 1, 0 0))'), (3, NULL)",
    "CREATE TABLE cz (id INT, z POLYGON, p POINT)",
    "INSERT INTO cz VALUES (1, 'POLYGON((0 0, 4 0, 4 4, 0 4, 0 0))', 'POINT(3 7)'), "
    "(2, 'POLYGON((0 0, 2 0, 2 6, 0 6, 0 0))', 'POINT(1 1)'), (3, NULL, NULL)",
    "CREATE TABLE hz (z POLYGON)",
    "INSERT INTO hz VALUES ('POLYGON((0 0, 4 0, 4 4, 0 4, 0 0),(2 1, 3 1, 3 2, 2 2, 2 1))')",
    "CREATE TABLE g (a GEOMETRY(POINT, 4326), b GEOMETRY(POINT, 4326) ENCODING NONE, c POINT)",
    "INSERT INTO g VALUES ('POINT(1.5 2.5)', 'POINT(1.5 2.5)', 'POINT(1.5 2.5)'), "
    "('POINT(-122.4194 37.7749)', NULL, 'POINT(-73.9857 40.7484)')",
    "CREATE TABLE ge (p GEOMETRY(POINT, 4326) ENCODING COMPRESSED(32))",
    "INSERT INTO ge VALUES ('POINT(12.34 56.78)'), (NULL)",
    "CREATE TABLE gz (id INT, z GEOMETRY(POLYGON, 4326))",
    "INSERT INTO gz VALUES (1, 'POLYGON((0 0, 4 0, 4 4, 0 4, 0 0))'), (2, NULL)",
    "CREATE TABLE gb (id INT, z POLYGON, l LINESTRING)",
    "INSERT INTO gb VALUES (1, 'POLYGON((1 2, 5 2, 5 8, 1 8, 1 2))', "
    "'LINESTRING(0 0, 3 4, -2 1)'), (2, NULL, NULL)",
    "CREATE TABLE gt (p GEOMETRY(POINT, 4326))",
    "INSERT INTO gt VALUES ('POINT(-122.4194 37.7749)')",
    "CREATE TABLE gt2 (a GEOMETRY(POINT, 4326))",
    "INSERT INTO gt2 VALUES ('POINT(0 0)')",
]

GEO_QUERIES = [
    "SELECT id, p, zone FROM geo ORDER BY id",
    "SELECT ST_X(p), ST_Y(p) FROM geo ORDER BY id",
    "SELECT ST_Distance(p, 'POINT(0 0)') FROM geo ORDER BY id",
    "SELECT id FROM geo WHERE ST_DWithin(p, 'POINT(0 0)', 2.0)",
    "SELECT ST_Distance(a, b) FROM pts",
    "SELECT id, ST_Contains(zone, p) FROM geo ORDER BY id",
    "SELECT id FROM geo WHERE ST_Contains('POLYGON((0 0, 5 0, 5 5, 0 5, 0 0))', p)",
    "SELECT id, ST_Contains(zone, ST_GeomFromText('POINT(1 1)')) FROM geo ORDER BY id",
    "SELECT ST_Area(zone), ST_Perimeter(zone), ST_NPoints(zone) FROM geo ORDER BY id",
    "SELECT COUNT(*) FROM geo WHERE ST_Contains(zone, p)",
    "SELECT SUM(ST_Area(zone)) FROM geo",
    "SELECT ST_Length(path), ST_NPoints(path), path FROM ln",
    "SELECT ST_AREA(poly), ST_AREA(mp), ST_NPOINTS(poly), ST_NPOINTS(mp), "
    "ST_PERIMETER(poly), mp FROM mr",
    "SELECT count(*) FROM mr WHERE ST_CONTAINS(poly, 'POINT(5 5)')",
    "SELECT count(*) FROM mr WHERE ST_CONTAINS(poly, 'POINT(1 1)')",
    "SELECT count(*) FROM mr WHERE ST_CONTAINS(mp, 'POINT(6 6)')",
    "SELECT ST_INTERSECTS(poly, 'POLYGON((3 3, 6 3, 6 6, 3 6))') FROM si",
    "SELECT ST_INTERSECTS(poly, 'POINT(2 2)') FROM si",
    "SELECT ST_INTERSECTS(ln, 'POLYGON((0 0, 4 0, 4 4, 0 4))') FROM si",
    "SELECT ST_INTERSECTS(poly, 'POLYGON((1 1, 2 1, 2 2, 1 2))') FROM si",
    "SELECT ST_INTERSECTS(p, 'POLYGON((0 0, 4 0, 4 4, 0 4))') FROM si",
    "SELECT ST_INTERSECTS(poly, p), ST_INTERSECTS(p, poly) FROM si",
    "SELECT id FROM geo WHERE ST_Within(p, zone) ORDER BY id",
    "SELECT id FROM geo WHERE ST_Within('POINT(1 1)', zone) ORDER BY id",
    "SELECT ST_SRID(p), ST_SRID(zone) FROM geo ORDER BY id LIMIT 1",
    "SELECT id, ST_NRings(z) FROM pz ORDER BY id",
    "SELECT id, ST_X(ST_Centroid(z)), ST_Y(ST_Centroid(z)), ST_X(ST_Centroid(p)) "
    "FROM cz ORDER BY id",
    "SELECT id FROM cz WHERE ST_Distance(ST_Centroid(z), 'POINT(2 2)') < 0.01",
    "SELECT ST_X(ST_Centroid(z)), ST_Y(ST_Centroid(z)) FROM hz",
    "SELECT ST_X(a), ST_X(b), ST_X(c), ST_Y(a), a, b, c FROM g",
    "SELECT ST_X(p), ST_Y(p), p FROM ge",
    "SELECT ST_Area(z), ST_NPoints(z), ST_Contains(z, ST_GeomFromText('POINT(1 1)')), z "
    "FROM gz ORDER BY id",
    "SELECT ST_XMin(z), ST_XMax(z), ST_YMin(z), ST_YMax(z), ST_XMin(l), ST_YMax(l) "
    "FROM gb ORDER BY id",
    "SELECT ST_AsText(p) FROM ge",
    "SELECT ST_X(ST_Transform(p, 900913)), ST_Y(ST_Transform(p, 900913)) FROM gt",
    "SELECT ST_Distance(ST_Transform(a, 900913), ST_GeomFromText('POINT(111319.490778 0)')) "
    "FROM gt2",
    "SELECT COUNT(*) FROM g WHERE ST_DWithin(a, ST_GeomFromText('POINT(-73.9857 40.7484)', "
    "4326), 60.0)",
]


@pytest.fixture(scope="module")
def gdbs():
    dbs = _pair()
    _both(dbs, *GEO_TABLES)
    return dbs


@pytest.mark.parametrize("sql", GEO_QUERIES)
def test_geo_queries(gdbs, sql):
    check(gdbs, sql)


def test_default_compression_by_srid(gdbs):
    for db in gdbs:
        t = db.catalog.get_table("g")
        assert [c.type.is_geo_compressed for c in t.columns] == [True, False, False]
        frag = t.fragments[0]
        assert frag.chunks[t.columns[0].col_id][0].dtype == np.int32
        assert frag.chunks[t.columns[1].col_id][0].dtype == np.float64


def test_compressed_encoding_errors():
    dbs = _pair()
    names = []
    for db in dbs:
        with pytest.raises(Exception) as ei:
            db.sql("CREATE TABLE gbad (p POINT ENCODING COMPRESSED(32))")
        names.append(type(ei.value).__name__)
    assert names == ["BinderError", "BinderError"]


def test_geo_errors(gdbs):
    for sql in ("SELECT ST_Area(id) FROM geo",
                "SELECT ST_INTERSECTS(a, b) FROM pts"):
        names = []
        for db in gdbs:
            with pytest.raises(Exception) as ei:
                db.sql(sql)
            names.append(type(ei.value).__name__)
        assert names[0] == names[1], (sql, names)


def test_codec_matches_reference():
    """GEOINT32 compress / decompress, WKT parse and ring decode of the
    port's storage (copied) against the reference's, bit for bit, on
    seeded coordinates over the whole lon / lat range."""
    rng = np.random.default_rng(3)
    for kind in ("GEO_POINT", "GEO_LINESTRING", "GEO_POLYGON"):
        jk, k = getattr(JT.SQLTypeKind, kind), getattr(T.SQLTypeKind, kind)
        for _ in range(20):
            n = 1 if kind == "GEO_POINT" else int(rng.integers(3, 12))
            xs, ys = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
            pts = ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in zip(xs, ys))
            wkt = {"GEO_POINT": f"POINT({pts})", "GEO_LINESTRING": f"LINESTRING({pts})",
                   "GEO_POLYGON": f"POLYGON(({pts}))"}[kind]
            jc, c = JTAB.wkt_to_coords(wkt, jk), TAB.wkt_to_coords(wkt, k)
            assert np.array_equal(jc, c)
            jz, z = JTAB.geoint_compress(jc, jk), TAB.geoint_compress(c, k)
            assert jz.dtype == z.dtype == np.int32 and np.array_equal(jz, z)
            assert np.array_equal(JTAB.geoint_decompress(jz, jk), TAB.geoint_decompress(z, k))
            for (ja, jo), (a, o) in zip(JTAB.geo_rings(jz, jk), TAB.geo_rings(z, k)):
                assert jo == o and np.array_equal(ja, a)


# ---------------------------------------------------------------------------
# tests/test_geo_construct.py
# ---------------------------------------------------------------------------

CONSTRUCT_TABLES = [
    "CREATE TABLE cpts (g GEOMETRY(POINT))",
    "INSERT INTO cpts VALUES ('POINT (10 20)')",
    "CREATE TABLE ply (g GEOMETRY(POLYGON))",
    "INSERT INTO ply VALUES ('POLYGON ((0 0, 4 0, 4 4, 0 4))')",
    "CREATE TABLE th (g GEOMETRY(POLYGON))",
    "INSERT INTO th VALUES ('POLYGON ((0 0, 4 0, 4 4, 0 4), (1 1, 3 1, 3 3, 1 3))')",
    "CREATE TABLE tu (a GEOMETRY(POLYGON), b GEOMETRY(POLYGON))",
    "INSERT INTO tu VALUES ('POLYGON ((0 0, 1 0, 1 1, 0 1))', 'POLYGON ((5 5, 7 5, 7 7, 5 7))')",
    "CREATE TABLE tn (g GEOMETRY(POLYGON))",
    "INSERT INTO tn VALUES (NULL)",
    "CREATE TABLE tux (g GEOMETRY(POLYGON))",
    "INSERT INTO tux VALUES ('POLYGON ((0 0, 4 0, 4 4, 3 4, 3 1, 1 1, 1 4, 0 4))')",
]

CONSTRUCT_QUERIES = [
    "SELECT ST_AREA(ST_BUFFER(g, 2.0)), ST_ASTEXT(ST_BUFFER(g, 2.0)) FROM cpts",
    "SELECT ST_AREA(ST_BUFFER(g, 0)) FROM ply",
    "SELECT ST_AREA(ST_INTERSECTION(g, 'POLYGON ((3 1, 6 1, 6 3, 3 3))')) FROM ply",
    "SELECT ST_AREA(ST_INTERSECTION('POLYGON ((3 1, 6 1, 6 3, 3 3))', g)) FROM ply",
    "SELECT ST_AREA(ST_INTERSECTION(g, 'POLYGON ((0 0, 2 0, 2 4, 0 4))')) FROM th",
    "SELECT ST_AREA(ST_DIFFERENCE(g, 'POLYGON ((1 1, 2 1, 2 2, 1 2))')), "
    "ST_NRINGS(ST_DIFFERENCE(g, 'POLYGON ((1 1, 2 1, 2 2, 1 2))')) FROM ply",
    "SELECT ST_AREA(ST_DIFFERENCE(g, 'POLYGON ((3 1, 6 1, 6 3, 3 3))')) FROM ply",
    "SELECT ST_AREA(ST_UNION(a, b)), ST_ASTEXT(ST_UNION(a, b)) FROM tu",
    "SELECT ST_AREA(ST_UNION(a, 'POLYGON ((-1 -1, 2 -1, 2 2, -1 2))')) FROM tu",
    "SELECT ST_AREA(ST_INTERSECTION(g, 'POLYGON ((0 0, 1 0, 1 1, 0 1))')) FROM tn",
    "SELECT ST_AREA(ST_INTERSECTION(ST_BUFFER(g, 1.0), 'POLYGON ((0 -2, 2 -2, 2 2, 0 2))')) "
    "FROM cpts",
    "SELECT ST_ASTEXT(g), ST_ASTEXT(ST_BUFFER(g, 0)) FROM ply",
    "SELECT ST_XMIN(ST_BUFFER(g, 1.0)), ST_NPOINTS(ST_BUFFER(g, 1.0)), "
    "ST_CONTAINS(ST_BUFFER(g, 3.0), 'POINT(11 21)') FROM cpts",
]


@pytest.fixture(scope="module")
def cdbs():
    dbs = _pair()
    _both(dbs, *CONSTRUCT_TABLES)
    return dbs


@pytest.mark.parametrize("sql", CONSTRUCT_QUERIES)
def test_construct_queries(cdbs, sql):
    check(cdbs, sql)


def test_union_crossing_unsupported(cdbs):
    sql = ("SELECT ST_AREA(ST_UNION(g, 'POLYGON ((0 2, 5 2, 5 3, 4.5 3, 4.5 2.5, 0.5 2.5, "
           "0.5 3, 0 3))')) FROM tux")
    names = []
    for db in cdbs:
        with pytest.raises(Exception) as ei:
            db.sql(sql).rows()
        names.append(type(ei.value).__name__)
    assert names[0] == names[1] == "NotSupported"


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the two packages must fail alike
        return type(e).__name__


def test_geo_construct_module_matches_reference():
    """ops/geo_construct.py (copied) against the reference's on seeded
    rectangles: a buffer of 0, and each boolean op with a convex clip that
    crosses it, nests in it or misses it."""
    rng = np.random.default_rng(5)
    K, JK = T.SQLTypeKind.GEO_POLYGON, JT.SQLTypeKind.GEO_POLYGON
    for _ in range(12):
        cx, cy = rng.uniform(-5, 5, 2)
        w, h = rng.uniform(1, 4, 2)
        wkt = f"POLYGON(({cx} {cy}, {cx + w} {cy}, {cx + w} {cy + h}, {cx} {cy + h}))"
        jrow = np.empty(1, object)
        jrow[0] = JTAB.wkt_to_coords(wkt, JK)
        row = np.empty(1, object)
        row[0] = TAB.wkt_to_coords(wkt, K)
        dx, dy, s = rng.uniform(-1, 1.5, 3)
        clip = TAB.wkt_to_coords(
            f"POLYGON(({cx + dx * w} {cy + dy * h}, {cx + (dx + s) * w} {cy + dy * h}, "
            f"{cx + (dx + s) * w} {cy + (dy + s) * h}, {cx + dx * w} {cy + (dy + s) * h}))", K)
        spec = ("lit", "GEO_POLYGON", tuple(clip.tolist()))
        for step in (("BUFFER", 0.0), ("INTERSECTION", spec), ("DIFFERENCE", spec),
                     ("UNION", spec)):
            want = _outcome(lambda: JGC.apply_steps(jrow, JK, (step,), None))
            got = _outcome(lambda: GC.apply_steps(row, K, (step,), None))
            if isinstance(want, str):
                assert got == want
                continue
            assert (want[0] is None) == (got[0] is None)
            if want[0] is not None:
                assert np.array_equal(np.asarray(want[0]), np.asarray(got[0]))
        assert JGC.result_kind(JK, (("UNION", spec),)).name == \
            GC.result_kind(K, (("UNION", spec),)).name
