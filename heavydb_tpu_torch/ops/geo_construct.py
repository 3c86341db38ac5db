"""Geometry-valued constructors — the reference's GEOS-runtime role
(QueryEngine/RelAlgTranslatorGeo.cpp:332 ST_Intersection/Difference/
Union/Buffer, gated there behind ENABLE_GEOS and evaluated on the CPU by
libgeos).  This environment has no GEOS, so the constructors are
implemented natively on the even-odd ring-set representation the engine
already stores (storage/table.py ring-header payloads).

Supported exactly (no approximation):

- ``ST_Buffer(point, r)`` → a 32-segment circle polygon (GEOS default is
  8 segments per quadrant = the same 32).
- ``ST_Buffer(poly, 0)`` → identity (the common "fix validity" idiom).
- Boolean ops where the two boundaries do NOT cross (disjoint, nested,
  or in different holes): pure ring re-classification under even-odd
  fill — exact for arbitrary polygons with holes.
- Boolean ops with crossing boundaries when one operand is a CONVEX
  single ring: INTERSECTION by Sutherland–Hodgman clipping of every
  subject ring (exact under even-odd: A∩B = Δᵢ(aᵢ∩B) since intersection
  distributes over symmetric difference); DIFFERENCE via the identity
  A−B = A Δ (A∩B) for hole-free subjects.

Concave-vs-concave crossing unions/differences raise NotSupported with
an explicit message — the reference without GEOS raises the same way
(RelAlgTranslatorGeo.cpp:977 "geo constructor requires enabled GEOS").

Empty results return None (NULL geometry).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.errors import NotSupported

K = T.SQLTypeKind

BUFFER_SEGMENTS = 32

Ring = np.ndarray  # flat [x0,y0,x1,y1,...] float64, not closed
Part = Tuple[Ring, bool]  # (coords, is_outer)


# ---------------------------------------------------------------------------
# ring payload codec (matches storage/table.py ring-header layout)


def _decode(payload, kind) -> List[Part]:
    from heavydb_tpu_torch.storage.table import geo_rings

    return [(np.asarray(c, np.float64), o) for c, o in geo_rings(payload, kind)]


def _encode(parts: Sequence[Part]) -> Optional[np.ndarray]:
    if not parts:
        return None
    header = [float(len(parts))]
    flat: List[float] = []
    for coords, outer in parts:
        n = len(coords)
        header.append(float(n) if outer else -float(n))
        flat.extend(np.asarray(coords, np.float64).tolist())
    return np.array(header + flat, np.float64)


# ---------------------------------------------------------------------------
# geometry predicates on single rings


def _xy(c: Ring):
    return c[0::2], c[1::2]


def _signed_area(c: Ring) -> float:
    x, y = _xy(c)
    return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _point_in_ring(px: float, py: float, c: Ring) -> bool:
    """Even-odd ray cast, vectorized over the ring's edges."""
    x, y = _xy(c)
    x2, y2 = np.roll(x, -1), np.roll(y, -1)
    cond = (y > py) != (y2 > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x + (py - y) * (x2 - x) / np.where(y2 == y, np.inf, y2 - y)
    return bool(np.count_nonzero(cond & (px < xint)) & 1)


def _interior_point(c: Ring) -> Tuple[float, float]:
    """A point strictly inside a simple ring: first ear centroid that
    passes the even-odd test (rings here are small; O(n) typical)."""
    n = len(c) // 2
    if n < 3:
        return float(c[0]), float(c[1])
    for k in range(1, n - 1):
        cx = (c[0] + c[2 * k] + c[2 * k + 2]) / 3.0
        cy = (c[1] + c[2 * k + 1] + c[2 * k + 3]) / 3.0
        if _point_in_ring(cx, cy, c):
            return cx, cy
    # fallback: vertex mean
    x, y = _xy(c)
    return float(x.mean()), float(y.mean())


def _in_region(px: float, py: float, parts: Sequence[Part]) -> bool:
    """Even-odd membership across ALL rings (holes via parity)."""
    cnt = sum(1 for c, _ in parts if len(c) >= 6 and _point_in_ring(px, py, c))
    return bool(cnt & 1)


def _is_convex(c: Ring) -> bool:
    x, y = _xy(c)
    if len(x) < 3:
        return False
    dx, dy = np.diff(np.append(x, x[0])), np.diff(np.append(y, y[0]))
    cross = dx * np.roll(dy, -1) - dy * np.roll(dx, -1)
    return bool((cross >= -1e-12).all() or (cross <= 1e-12).all())


def _boundaries_cross(a: Sequence[Part], b: Sequence[Part]) -> bool:
    """Any PROPER segment crossing (or touch, conservatively) between the
    two ring sets — all edge pairs, vectorized."""
    def edges(parts):
        p1, p2 = [], []
        for c, _ in parts:
            x, y = _xy(c)
            p1.append(np.stack([x, y], 1))
            p2.append(np.stack([np.roll(x, -1), np.roll(y, -1)], 1))
        if not p1:
            return np.empty((0, 2)), np.empty((0, 2))
        return np.concatenate(p1), np.concatenate(p2)

    a1, a2 = edges(a)
    b1, b2 = edges(b)
    if not len(a1) or not len(b1):
        return False

    def orient(p, q, r):
        # (q-p) x (r-p) with broadcasting; p,q (Na,1,2), r (1,Nb,2)
        return ((q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1])
                - (q[..., 1] - p[..., 1]) * (r[..., 0] - p[..., 0]))

    A1, A2 = a1[:, None, :], a2[:, None, :]
    B1, B2 = b1[None, :, :], b2[None, :, :]
    d1 = orient(A1, A2, B1)
    d2 = orient(A1, A2, B2)
    d3 = orient(B1, B2, A1)
    d4 = orient(B1, B2, A2)
    eps = 1e-12
    proper = ((d1 > eps) != (d2 > eps)) & ((d1 < -eps) != (d2 < -eps)) \
        & ((d3 > eps) != (d4 > eps)) & ((d3 < -eps) != (d4 < -eps))
    if proper.any():
        return True

    # degenerate contact (a vertex of one ring ON an edge of the other):
    # conservatively counts as crossing — it routes to the exact convex
    # clip path instead of the disjoint/nested classification
    def vertex_on_edge(pts, s1, s2):
        P = pts[:, None, :]
        S1, S2 = s1[None, :, :], s2[None, :, :]
        d = S2 - S1
        v = P - S1
        cross = d[..., 0] * v[..., 1] - d[..., 1] * v[..., 0]
        dot = d[..., 0] * v[..., 0] + d[..., 1] * v[..., 1]
        ln2 = (d * d).sum(-1)
        scale = np.maximum(np.sqrt(ln2), 1e-30)
        on = (np.abs(cross) / scale < 1e-9) & (dot > eps) \
            & (dot < ln2 - eps)
        return bool(on.any())

    return vertex_on_edge(a1, b1, b2) or vertex_on_edge(b1, a1, a2)


def _sutherland_hodgman(subject: Ring, clip: Ring) -> Optional[Ring]:
    """Clip a simple ring against a CONVEX ring; exact for even-odd area
    semantics (concave subjects may gain degenerate boundary edges that
    cancel under even-odd — same as the classic algorithm)."""
    if _signed_area(clip) < 0:  # orient clip CCW so inside == left
        clip = clip.reshape(-1, 2)[::-1].ravel()
    cx, cy = _xy(clip)
    pts = list(subject.reshape(-1, 2))
    m = len(cx)
    for i in range(m):
        ex1, ey1 = cx[i], cy[i]
        ex2, ey2 = cx[(i + 1) % m], cy[(i + 1) % m]
        if not pts:
            return None
        out = []
        prev = pts[-1]
        pside = (ex2 - ex1) * (prev[1] - ey1) - (ey2 - ey1) * (prev[0] - ex1)
        for cur in pts:
            side = (ex2 - ex1) * (cur[1] - ey1) - (ey2 - ey1) * (cur[0] - ex1)
            if side >= 0:
                if pside < 0:
                    out.append(_isect(prev, cur, (ex1, ey1), (ex2, ey2)))
                out.append(cur)
            elif pside >= 0:
                out.append(_isect(prev, cur, (ex1, ey1), (ex2, ey2)))
            prev, pside = cur, side
        pts = out
    if len(pts) < 3:
        return None
    ring = np.asarray(pts, np.float64).ravel()
    if abs(_signed_area(ring)) < 1e-300:
        return None
    return ring


def _isect(p, q, e1, e2):
    x1, y1 = p
    x2, y2 = q
    x3, y3 = e1
    x4, y4 = e2
    den = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    if den == 0:
        return np.asarray(q, np.float64)
    t = ((x1 - x3) * (y3 - y4) - (y1 - y3) * (x3 - x4)) / den
    return np.array([x1 + t * (x2 - x1), y1 + t * (y2 - y1)], np.float64)


def _normalize(rings: List[Ring]) -> List[Part]:
    """Assign outer/hole flags by containment-depth parity and order each
    hole right after an outer that contains it (the payload layout's
    grouping contract for MULTIPOLYGON)."""
    rings = [r for r in rings if len(r) >= 6]
    n = len(rings)
    if not n:
        return []
    reps = [_interior_point(r) for r in rings]
    depth = [0] * n
    inside = [[False] * n for _ in range(n)]
    for i in range(n):
        for j in range(n):
            if i != j and _point_in_ring(reps[j][0], reps[j][1], rings[i]):
                inside[i][j] = True
                depth[j] += 1
    parts: List[Part] = []
    outers = [i for i in range(n) if depth[i] % 2 == 0]
    holes = [i for i in range(n) if depth[i] % 2 == 1]
    used = set()
    for o in outers:
        parts.append((rings[o], True))
        for h in holes:
            if h not in used and inside[o][h]:
                parts.append((rings[h], False))
                used.add(h)
    for h in holes:  # orphaned holes (shouldn't happen) keep parity honest
        if h not in used:
            parts.append((rings[h], False))
    return parts


# ---------------------------------------------------------------------------
# the operators


def _solid_convex(parts: Sequence[Part]) -> Optional[Ring]:
    """The single outer convex ring when the region is one solid convex
    polygon, else None."""
    if len(parts) == 1 and parts[0][1] and _is_convex(parts[0][0]):
        return parts[0][0]
    return None


def poly_bool(op: str, a: Sequence[Part], b: Sequence[Part]) -> List[Part]:
    a = [(c, o) for c, o in a if len(c) >= 6]
    b = [(c, o) for c, o in b if len(c) >= 6]
    if not a:
        return list(b) if op == "UNION" else []
    if not b:
        return [] if op == "INTERSECTION" else list(a)
    if not _boundaries_cross(a, b):
        in_b = [_in_region(*_interior_point(c), b) for c, _ in a]
        in_a = [_in_region(*_interior_point(c), a) for c, _ in b]
        if op == "INTERSECTION":
            keep = [c for (c, _), f in zip(a, in_b) if f] + \
                   [c for (c, _), f in zip(b, in_a) if f]
        elif op == "UNION":
            keep = [c for (c, _), f in zip(a, in_b) if not f] + \
                   [c for (c, _), f in zip(b, in_a) if not f]
        else:  # DIFFERENCE
            keep = [c for (c, _), f in zip(a, in_b) if not f] + \
                   [c for (c, _), f in zip(b, in_a) if f]
        return _normalize(keep)
    # crossing boundaries: need a convex solid operand
    ca, cb = _solid_convex(a), _solid_convex(b)
    if op == "INTERSECTION":
        if cb is not None:
            clipped = [(_sutherland_hodgman(c, cb), o) for c, o in a]
            return [(c, o) for c, o in clipped if c is not None]
        if ca is not None:
            clipped = [(_sutherland_hodgman(c, ca), o) for c, o in b]
            return [(c, o) for c, o in clipped if c is not None]
        raise NotSupported(
            "ST_INTERSECTION of two crossing concave polygons needs a "
            "convex operand (no GEOS in this build)")
    if op == "DIFFERENCE":
        if cb is None:
            raise NotSupported(
                "ST_DIFFERENCE with crossing boundaries needs a convex "
                "second operand (no GEOS in this build)")
        if any(not o for _, o in a):
            raise NotSupported(
                "ST_DIFFERENCE with crossing boundaries needs a hole-free "
                "first operand (no GEOS in this build)")
        # A − B = A Δ (A∩B): append the clipped pieces; parity flags via
        # normalize (each piece sits strictly inside its subject ring)
        rings = [c for c, _ in a]
        for c, _ in a:
            piece = _sutherland_hodgman(c, cb)
            if piece is not None:
                rings.append(piece)
        return _normalize(rings)
    raise NotSupported(
        "ST_UNION of polygons with crossing boundaries is not supported "
        "(no GEOS in this build); non-crossing unions work")


def buffer_payload(payload, kind, dist: float):
    """BUFFER of one row's payload → (parts, POLYGON|input kind)."""
    from heavydb_tpu_torch.storage.table import geo_rings

    if kind == K.GEO_POINT:
        c = geo_rings(payload, kind)[0][0]
        if len(c) < 2:
            return None
        ang = np.linspace(0.0, 2 * np.pi, BUFFER_SEGMENTS, endpoint=False)
        ring = np.empty(2 * BUFFER_SEGMENTS, np.float64)
        ring[0::2] = c[0] + dist * np.cos(ang)
        ring[1::2] = c[1] + dist * np.sin(ang)
        return [(ring, True)]
    if dist == 0.0 and kind in (K.GEO_POLYGON, K.GEO_MULTIPOLYGON):
        return _decode(payload, kind)
    raise NotSupported(
        "ST_BUFFER supports points (any radius) and polygons (radius 0) "
        "without GEOS")


# ---------------------------------------------------------------------------
# applying a transform chain (dict_ref third-slot steps)


def result_kind(kind: T.SQLTypeKind, steps) -> T.SQLTypeKind:
    for step in steps:
        if step[0] == "BUFFER":
            kind = K.GEO_POLYGON if kind == K.GEO_POINT \
                else K.GEO_MULTIPOLYGON
        else:
            kind = K.GEO_MULTIPOLYGON
    return kind


def apply_steps(rows, kind: T.SQLTypeKind, steps,
                resolve_col: Callable[[int, int], Sequence]) -> list:
    """Apply a transform chain to a whole column of payload rows.
    rows: sequence of per-row payloads (None = NULL).  Returns new rows;
    the resulting kind is `result_kind(kind, steps)`."""
    for step in steps:
        op = step[0]
        if op == "BUFFER":
            dist = float(step[1])
            out = []
            for r in rows:
                out.append(None if r is None
                           else _encode(buffer_payload(r, kind, dist)))
            rows = out
            kind = K.GEO_POLYGON if kind == K.GEO_POINT \
                else K.GEO_MULTIPOLYGON
            continue
        spec = step[1]
        if spec[0] == "lit":
            b_parts = _decode(np.asarray(spec[2], np.float64),
                              K[spec[1]])
            b_rows = None
        else:
            _, tid, cid, bkind = spec
            b_rows = resolve_col(tid, cid)
        out = []
        for i, r in enumerate(rows):
            if r is None:
                out.append(None)
                continue
            if b_rows is not None:
                br = b_rows[i]
                if br is None:
                    out.append(None)
                    continue
                bp = _decode(br, K[spec[3]])
            else:
                bp = b_parts
            out.append(_encode(poly_bool(op, _decode(r, kind), bp)))
        rows = out
        kind = K.GEO_MULTIPOLYGON
    return rows
