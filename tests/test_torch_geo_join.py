"""The grid-bucket spatial join: heavydb_tpu_torch against the JAX
package.

The cases of tests/test_geo_join.py (ST_DWithin / ST_Distance joins in
the WHERE and the ON forms, NULL points, exact pairs, extra conjuncts;
polygon-contains-point joins with the polygon as the build side and as
the probe side, ST_Intersects of a column pair, a grouped spatial join,
CONTAINS on one table) run in heavydb_tpu.connect() and
heavydb_tpu_torch.connect(device="cpu"); each gives the reference's rows,
which also equal a numpy brute force over every pair (the reference's
crossing rule).  Module level: `plan_geo_join` on the same bound
residuals in both packages; `_cellify` / `_pack_cells` at negative, huge
and clipped coordinates; and the CONTAINS_SEG ray cast on seeded points
that include polygon vertices, points on horizontal edges and on hole
boundaries, bit for bit against the reference's loop and its host
`point_in`.  Plus the port's join runs: the build form, the capacity
retry, a refused non-INNER geo join.

Tolerances: counts, ids and booleans exact; DOUBLE aggregates rtol 1e-9;
coordinates, cells and crossings bit for bit.
"""

import numpy as np
import pytest
import torch

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
from heavydb_tpu import types as JT
from heavydb_tpu.exec import compound_kernel as JCK
from heavydb_tpu.exec import geo_join as JGEO
from heavydb_tpu.plan.optimizer import optimize as joptimize
from heavydb_tpu.sql.parser import parse_many as jparse_many
from heavydb_tpu.storage.table import geo_rings, wkt_to_coords
from heavydb_tpu_torch.exec import compound_kernel as CK
from heavydb_tpu_torch.exec import expr_compiler as XC
from heavydb_tpu_torch.exec import geo_join as GEO
from heavydb_tpu_torch.plan.optimizer import optimize
from heavydb_tpu_torch.sql.parser import parse_many


def _point_in(px, py, rings):
    """The reference's host even-odd test (tests/test_geo_join.py)."""
    crossings = 0
    for c, _ in rings:
        if len(c) < 6:
            continue
        x, y = c[0::2], c[1::2]
        x2, y2 = np.roll(x, -1), np.roll(y, -1)
        cr = ((y > py) != (y2 > py)) & (
            px < (x2 - x) * (py - y) / np.where(y2 == y, 1e-300, y2 - y) + x)
        crossings += int(cr.sum())
    return crossings % 2 == 1


def _pair():
    return hdt.connect(), hdt_torch.connect(device="cpu")


def _both(dbs, *stmts):
    for db in dbs:
        for s in stmts:
            db.sql(s)


def check(dbs, sql, ordered=None):
    ref, port = dbs
    want = ref.sql(sql).rows()
    got = port.sql(sql).rows()
    if not ("ORDER BY" in sql.upper() if ordered is None else ordered):
        got, want = sorted(got), sorted(want)
    assert len(got) == len(want), (sql, got[:5], want[:5])
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(
            a == pytest.approx(b, rel=1e-9) if isinstance(b, float) else a == b
            for a, b in zip(g, w)), (sql, g, w)
    return got


def _load_points(dbs, name, xs, ys, nulls=()):
    rows = [f"({i}, NULL)" if i in nulls else f"({i}, 'POINT({x:.9f} {y:.9f})')"
            for i, (x, y) in enumerate(zip(xs, ys))]
    _both(dbs, f"INSERT INTO {name} VALUES {', '.join(rows)}")


# ---------------------------------------------------------------------------
# tests/test_geo_join.py: TestDWithinJoin
# ---------------------------------------------------------------------------

def _dwithin_setup(na=300, nb=250, seed=0, nulls=False):
    dbs = _pair()
    _both(dbs, "CREATE TABLE ga (id INTEGER, p POINT)", "CREATE TABLE gb (id INTEGER, p POINT)")
    rng = np.random.default_rng(seed)
    ax, ay = rng.uniform(0, 10, na), rng.uniform(0, 10, na)
    bx, by = rng.uniform(0, 10, nb), rng.uniform(0, 10, nb)
    an = {1, 7} if nulls else set()
    bn = {0, 5} if nulls else set()
    _load_points(dbs, "ga", ax, ay, an)
    _load_points(dbs, "gb", bx, by, bn)
    # the coordinates as stored (9 decimals in the WKT)
    ax, ay, bx, by = (np.array([float(f"{v:.9f}") for v in a]) for a in (ax, ay, bx, by))
    d = np.sqrt((ax[:, None] - bx[None, :]) ** 2 + (ay[:, None] - by[None, :]) ** 2)
    for i in an:
        d[i, :] = np.inf
    for j in bn:
        d[:, j] = np.inf
    return dbs, d


@pytest.fixture(scope="module")
def dw():
    return _dwithin_setup()


@pytest.mark.parametrize("sql,lim,op", [
    ("SELECT COUNT(*) FROM ga a, gb b WHERE ST_DWITHIN(a.p, b.p, 0.3)", 0.3, "le"),
    ("SELECT COUNT(*) FROM ga a JOIN gb b ON ST_DWITHIN(a.p, b.p, 0.5)", 0.5, "le"),
    ("SELECT COUNT(*) FROM ga a, gb b WHERE ST_DISTANCE(a.p, b.p) < 0.4", 0.4, "lt"),
    ("SELECT COUNT(*) FROM ga a, gb b WHERE 0.45 >= ST_DISTANCE(a.p, b.p)", 0.45, "le"),
])
def test_dwithin_counts(dw, sql, lim, op):
    dbs, d = dw
    expect = int((d <= lim).sum() if op == "le" else (d < lim).sum())
    assert check(dbs, sql) == [(expect,)]
    assert dbs[1].executor.join_runs[0].builds[0].startswith("geo dwithin x9")


def test_null_points_excluded():
    dbs, d = _dwithin_setup(nulls=True)
    expect = int((d <= 0.6).sum())
    assert check(dbs, "SELECT COUNT(*) FROM ga a, gb b WHERE ST_DWITHIN(a.p, b.p, 0.6)") \
        == [(expect,)]


def test_pairs_exact():
    dbs, d = _dwithin_setup(na=80, nb=60)
    want = sorted((i, j) for i in range(d.shape[0]) for j in range(d.shape[1])
                  if d[i, j] <= 0.8)
    got = check(dbs, "SELECT a.id, b.id FROM ga a, gb b WHERE ST_DWITHIN(a.p, b.p, 0.8) "
                     "ORDER BY a.id, b.id")
    assert got == want


def test_extra_filter_conjuncts(dw):
    dbs, d = dw
    expect = int((d[:100, :] <= 0.5).sum())
    assert check(dbs, "SELECT COUNT(*) FROM ga a, gb b "
                      "WHERE ST_DWITHIN(a.p, b.p, 0.5) AND a.id < 100") == [(expect,)]
    check(dbs, "SELECT b.id % 5 k, COUNT(*), AVG(ST_DISTANCE(a.p, b.p)) FROM ga a, gb b "
               "WHERE ST_DWITHIN(a.p, b.p, 0.7) AND b.id > 20 GROUP BY k ORDER BY k")


def test_capacity_retry(dw):
    """A wide radius overflows the first cap (4 x the larger side): the
    level reruns at the exact capacity, and still gives every pair."""
    dbs, d = dw
    expect = int((d <= 3.0).sum())
    assert check(dbs, "SELECT COUNT(*) FROM ga a, gb b WHERE ST_DWITHIN(a.p, b.p, 3.0)") \
        == [(expect,)]
    run = dbs[1].executor.join_runs[0]
    assert run.retries == 1 and run.caps[0] > 4 * 300


def test_non_inner_geo_join_refused(dw):
    dbs, _ = dw
    for db in dbs:
        with pytest.raises(Exception) as ei:
            db.sql("SELECT COUNT(*) FROM ga a LEFT JOIN gb b ON ST_DWITHIN(a.p, b.p, 0.3)")
        assert type(ei.value).__name__ == "NotSupported"


# ---------------------------------------------------------------------------
# tests/test_geo_join.py: TestPolygonJoin
# ---------------------------------------------------------------------------

def _zones(rng, nz):
    zones = []
    for i in range(nz):
        cx, cy = rng.uniform(0, 20, 2)
        w, h = rng.uniform(0.5, 3.0, 2)
        if i % 3 == 0:  # a square with a hole
            zones.append(
                f"POLYGON(({cx} {cy}, {cx+w} {cy}, {cx+w} {cy+h}, {cx} {cy+h}, {cx} {cy}),"
                f"({cx+w*0.4} {cy+h*0.4}, {cx+w*0.6} {cy+h*0.4}, {cx+w*0.6} {cy+h*0.6}, "
                f"{cx+w*0.4} {cy+h*0.6}, {cx+w*0.4} {cy+h*0.4}))")
        else:  # a triangle
            zones.append(f"POLYGON(({cx} {cy}, {cx+w} {cy}, {cx+w*0.5} {cy+h}, {cx} {cy}))")
    return zones


def _poly_setup(nz=40, np_=400, seed=1, zone_type="POLYGON"):
    dbs = _pair()
    _both(dbs, f"CREATE TABLE zones (zid INTEGER, zone {zone_type})",
          "CREATE TABLE pts (pid INTEGER, p POINT)")
    rng = np.random.default_rng(seed)
    zones = _zones(rng, nz)
    _both(dbs, "INSERT INTO zones VALUES " + ", ".join(f"({i}, '{w}')"
                                                        for i, w in enumerate(zones)))
    xs, ys = rng.uniform(0, 22, np_), rng.uniform(0, 22, np_)
    _load_points(dbs, "pts", xs, ys)
    xs, ys = (np.array([float(f"{v:.9f}") for v in a]) for a in (xs, ys))
    K = JT.SQLTypeKind.GEO_POLYGON
    rings = [geo_rings(wkt_to_coords(w, K), K) for w in zones]
    inside = np.array([[_point_in(xs[j], ys[j], rg) for j in range(np_)] for rg in rings])
    return dbs, inside


@pytest.fixture(scope="module")
def poly():
    return _poly_setup()


def test_contains_poly_build(poly):
    dbs, inside = poly
    assert check(dbs, "SELECT COUNT(*) FROM pts p, zones z WHERE ST_CONTAINS(z.zone, p.p)") \
        == [(int(inside.sum()),)]
    assert dbs[1].executor.join_runs[0].builds[0].startswith("geo poly_build x4")


def test_contains_poly_probe(poly):
    """The polygons as the probe side: the planner's runtime reorder makes
    the larger input the probe, so the probe side is the bigger zones
    table here."""
    dbs = _pair()
    _both(dbs, "CREATE TABLE zones (zid INTEGER, zone POLYGON)",
          "CREATE TABLE pts (pid INTEGER, p POINT)")
    rng = np.random.default_rng(4)
    zones = _zones(rng, 120)
    _both(dbs, "INSERT INTO zones VALUES " + ", ".join(f"({i}, '{w}')"
                                                        for i, w in enumerate(zones)))
    xs, ys = rng.uniform(0, 22, 60), rng.uniform(0, 22, 60)
    _load_points(dbs, "pts", xs, ys)
    xs, ys = (np.array([float(f"{v:.9f}") for v in a]) for a in (xs, ys))
    K = JT.SQLTypeKind.GEO_POLYGON
    want = sorted((i, j) for i, w in enumerate(zones)
                  for j in range(60) if _point_in(xs[j], ys[j], geo_rings(wkt_to_coords(w, K), K)))
    got = check(dbs, "SELECT z.zid, p.pid FROM zones z, pts p WHERE ST_CONTAINS(z.zone, p.p) "
                     "ORDER BY z.zid, p.pid")
    assert got == want
    assert dbs[1].executor.join_runs[0].builds[0].startswith("geo poly_probe x4")


def test_intersects_column_pair(poly):
    dbs, inside = poly
    assert check(dbs, "SELECT COUNT(*) FROM pts p JOIN zones z ON ST_INTERSECTS(p.p, z.zone)") \
        == [(int(inside.sum()),)]


def test_grouped_spatial_join(poly):
    dbs, inside = poly
    per = {z: int(c) for z, c in enumerate(inside.sum(axis=1)) if c}
    got = check(dbs, "SELECT z.zid, COUNT(*) FROM zones z, pts p "
                     "WHERE ST_CONTAINS(z.zone, p.p) GROUP BY z.zid ORDER BY z.zid")
    assert dict(got) == per
    check(dbs, "SELECT z.zid, COUNT(*), AVG(ST_X(p.p)), MAX(p.pid) FROM pts p JOIN zones z "
               "ON ST_CONTAINS(z.zone, p.p) WHERE p.pid > 50 GROUP BY z.zid")


def test_compressed_zone_join():
    """GEOINT32 polygons (SRID 4326) decode in the ray cast's segments."""
    dbs, _ = _poly_setup(nz=25, np_=300, seed=6, zone_type="GEOMETRY(POLYGON, 4326)")
    check(dbs, "SELECT z.zid, COUNT(*) FROM pts p, zones z WHERE ST_CONTAINS(z.zone, p.p) "
               "GROUP BY z.zid ORDER BY z.zid")


def test_contains_seg_as_filter_same_table():
    dbs = _pair()
    _both(dbs, "CREATE TABLE combo (id INTEGER, zone POLYGON, p POINT)",
          "INSERT INTO combo VALUES (1, 'POLYGON((0 0, 4 0, 4 4, 0 4, 0 0))', 'POINT(2 2)'), "
          "(2, 'POLYGON((0 0, 4 0, 4 4, 0 4, 0 0))', 'POINT(9 9)'), "
          "(3, 'POLYGON((0 0, 2 0, 1 3, 0 0))', 'POINT(1 1)'), (4, NULL, 'POINT(1 1)')")
    assert check(dbs, "SELECT id FROM combo WHERE ST_CONTAINS(zone, p) ORDER BY id") \
        == [(1,), (3,)]
    # ST_Intersects of a column pair on one table is the in-kernel ray cast
    check(dbs, "SELECT id, ST_INTERSECTS(zone, p) FROM combo ORDER BY id")


# ---------------------------------------------------------------------------
# module level
# ---------------------------------------------------------------------------

PLAN_QUERIES = [
    "SELECT COUNT(*) FROM ga a, gb b WHERE ST_DWITHIN(a.p, b.p, 0.3)",
    "SELECT COUNT(*) FROM ga a, gb b WHERE ST_DWITHIN(b.p, a.p, 0.3)",
    "SELECT COUNT(*) FROM ga a, gb b WHERE ST_DISTANCE(a.p, b.p) < 0.4",
    "SELECT COUNT(*) FROM ga a, gb b WHERE ST_DISTANCE(a.p, b.p) <= 2",
    "SELECT COUNT(*) FROM pts p, zones z WHERE ST_CONTAINS(z.zone, p.p)",
    "SELECT COUNT(*) FROM zones z, pts p WHERE ST_INTERSECTS(z.zone, p.p)",
    "SELECT COUNT(*) FROM pts p, zones z WHERE ST_X(p.p) < 3",
]


def _geo_level(db, sql, plan, opt, parse):
    root = opt(db._plan_select(parse(sql)[0]))
    nodes, seen = [root], set()
    while nodes:
        n = nodes.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        nodes.extend(n.inputs)
        for li, (_, cond) in enumerate(getattr(n, "join_levels", [])):
            if cond is None:
                continue
            lo = sum(i.arity for i in n.inputs[:li + 1])
            hi = lo + n.inputs[li + 1].arity
            conj = [cond]
            out = []
            while conj:
                c = conj.pop(0)
                if type(c).__name__ == "BinOp" and c.op.name == "AND":
                    conj[:0] = [c.left, c.right]
                else:
                    out.append(c)
            return plan(out, lo, hi)
    return "no join level"


@pytest.mark.parametrize("sql", PLAN_QUERIES)
def test_plan_geo_join_matches_reference(sql):
    dbs = _pair()
    _both(dbs, "CREATE TABLE ga (id INTEGER, p POINT)", "CREATE TABLE gb (id INTEGER, p POINT)",
          "CREATE TABLE zones (zid INTEGER, zone POLYGON)",
          "CREATE TABLE pts (pid INTEGER, p POINT)")
    want = _geo_level(dbs[0], sql, JGEO.plan_geo_join, joptimize, jparse_many)
    got = _geo_level(dbs[1], sql, GEO.plan_geo_join, optimize, parse_many)
    if want is None or isinstance(want, str):
        assert got == want
        return
    (jp, jb, js, ja), (pp, pb, ps, pa) = want, got
    assert [repr(e.key()) for e in pp] == [repr(e.key()) for e in jp]
    assert [repr(e.key()) for e in pb] == [repr(e.key()) for e in jb]
    assert (ps.kind, ps.cell, ps.bbox_key, ps.offsets) == (js.kind, js.cell, js.bbox_key,
                                                           js.offsets)
    assert repr(pa) == repr(ja)


def test_cellify_and_pack_cells_bit_for_bit():
    rng = np.random.default_rng(9)
    xs = np.concatenate([rng.uniform(-500, 500, 400), rng.normal(0, 1e-3, 100),
                         [-0.0, 0.0, -1e-300, 1e-300, -3.0, 3.0, 2.9999999999999996,
                          -2.0 ** 40, 2.0 ** 40, -1e300, 1e300, -np.inf, np.inf]])
    ys = rng.permutation(xs)
    for cell in (0.3, 1e-3, 7.25, 1e-12):
        ji, jj = JCK._cellify(xs, ys, cell)
        ti, tj = CK._cellify(torch.from_numpy(xs), torch.from_numpy(ys), cell)
        assert np.array_equal(np.asarray(ji), ti.numpy())
        assert np.array_equal(np.asarray(jj), tj.numpy())
        assert np.array_equal(np.asarray(JCK._pack_cells(ji, jj)),
                              CK._pack_cells(ti, tj).numpy())
        for di, dj in GEO.DWITHIN_OFFSETS:
            assert np.array_equal(np.asarray(JCK._pack_cells(ji + di, jj + dj)),
                                  CK._pack_cells(ti + di, tj + dj).numpy())
    assert GEO.DWITHIN_OFFSETS == JGEO.DWITHIN_OFFSETS
    assert GEO.POLY_BUILD_OFFSETS == JGEO.POLY_BUILD_OFFSETS
    assert GEO.POLY_PROBE_OFFSETS == JGEO.POLY_PROBE_OFFSETS


EDGE_ZONES = [
    # a square with a square hole, a concave shape with horizontal edges,
    # a multipolygon, a triangle with a horizontal base
    "POLYGON((0 0, 8 0, 8 8, 0 8, 0 0),(2 2, 5 2, 5 5, 2 5, 2 2))",
    "POLYGON((10 0, 16 0, 16 2, 12 2, 12 4, 16 4, 16 6, 10 6, 10 0))",
    "MULTIPOLYGON(((20 0, 22 0, 22 2, 20 2, 20 0)),((23 3, 25 3, 25 5, 23 5, 23 3)))",
    "POLYGON((0 10, 6 10, 3 14, 0 10))",
]


def _edge_points(rng):
    pts = set()
    K = JT.SQLTypeKind.GEO_MULTIPOLYGON
    for w in EDGE_ZONES:
        k = K if w.startswith("MULTI") else JT.SQLTypeKind.GEO_POLYGON
        for c, _ in geo_rings(wkt_to_coords(w, k), k):
            x, y = c[0::2], c[1::2]
            for i in range(len(x)):
                pts.add((float(x[i]), float(y[i])))  # vertices
                j = (i + 1) % len(x)
                if y[i] == y[j]:  # on a horizontal edge
                    pts.add((float((x[i] + x[j]) / 2), float(y[i])))
                pts.add((float((x[i] + x[j]) / 2), float((y[i] + y[j]) / 2)))
    pts |= {(float(a), float(b)) for a, b in zip(np.round(rng.uniform(-1, 26, 150), 1),
                                                np.round(rng.uniform(-1, 15, 150), 1))}
    return sorted(pts)


def test_contains_seg_edges_bit_for_bit():
    """Points on vertices, horizontal edges and hole boundaries: the
    join's pairs equal the reference's and the host point_in's."""
    rng = np.random.default_rng(12)
    pts = _edge_points(rng)
    dbs = _pair()
    _both(dbs, "CREATE TABLE ez (zid INTEGER, zone MULTIPOLYGON)",
          "CREATE TABLE ep (pid INTEGER, p POINT)",
          "INSERT INTO ez VALUES " + ", ".join(
              f"({i}, '{w if w.startswith('MULTI') else 'MULTIPOLYGON((' + w[8:-1] + '))'}')"
              for i, w in enumerate(EDGE_ZONES)),
          "INSERT INTO ep VALUES " + ", ".join(f"({i}, 'POINT({x!r} {y!r})')"
                                               for i, (x, y) in enumerate(pts)))
    K = JT.SQLTypeKind.GEO_MULTIPOLYGON
    rings = [geo_rings(wkt_to_coords(r[0], K), K)
             for r in dbs[0].sql("SELECT zone FROM ez ORDER BY zid").rows()]
    want = sorted((i, j) for i, rg in enumerate(rings)
                  for j, (x, y) in enumerate(pts) if _point_in(x, y, rg))
    got = check(dbs, "SELECT z.zid, p.pid FROM ep p, ez z WHERE ST_CONTAINS(z.zone, p.p) "
                     "ORDER BY z.zid, p.pid")
    assert got == want


def test_ray_cast_matches_reference_loop():
    """`ray_cast` against the reference's crossing expression in numpy,
    term for term, over seeded segments and points that hit their
    endpoints and horizontal segments."""
    rng = np.random.default_rng(21)
    nseg = 300
    x1, y1 = np.round(rng.uniform(0, 10, nseg), 1), np.round(rng.uniform(0, 10, nseg), 1)
    x2, y2 = np.round(rng.uniform(0, 10, nseg), 1), np.round(rng.uniform(0, 10, nseg), 1)
    y2[::5] = y1[::5]  # horizontal segments
    n = 2000
    cnt = rng.integers(0, 40, n).astype(np.int32)
    off = rng.integers(0, nseg - 40, n).astype(np.int32)
    px = np.round(rng.uniform(0, 10, n), 1)
    py = np.round(rng.uniform(0, 10, n), 1)
    px[::7], py[::7] = x1[off[::7]], y1[off[::7]]
    want = np.zeros(n, np.int64)
    for s in range(int(cnt.max())):
        j = np.clip(off + s, 0, nseg - 1)
        a1, b1, a2, b2 = x1[j], y1[j], x2[j], y2[j]
        cr = ((b1 > py) != (b2 > py)) & (
            px < (a2 - a1) * (py - b1) / np.where(b2 == b1, 1e-300, b2 - b1) + a1)
        want += (cr & (s < cnt))
    t = torch.from_numpy
    old = XC.RAY_CAST_CHUNK
    try:
        for chunk in (old, 333):  # one pass, and many chunks
            XC.RAY_CAST_CHUNK = chunk
            got = XC.ray_cast(t(off), t(cnt), t(px), t(py), (t(x1), t(y1), t(x2), t(y2)),
                              int(cnt.max()))
            assert np.array_equal(got.numpy(), want)
    finally:
        XC.RAY_CAST_CHUNK = old
