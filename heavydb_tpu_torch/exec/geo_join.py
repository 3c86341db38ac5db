"""Geo join planning — grid-bucket candidate generation for spatial joins.

The reference accelerates spatial joins with a hash table over a uniform
grid covering the build side's bounding boxes
(QueryEngine/JoinHashTable/BoundingBoxIntersectJoinHashTable.h: bucket
sizes per dimension, keys = overlapped cells, exact predicate re-checked
as a residual).  The TPU formulation keeps the same two-phase shape but
maps it onto the engine's existing equi-join kernels:

- Each build row registers under a SMALL STATIC number of grid cells
  (point within distance d → the 3x3 neighborhood of its own cell at
  cell size d; polygon bbox → the 2x2 block from its bbox min corner at
  cell size >= the largest bbox extent).  Registration is a static
  `len(offsets)`-fold replication of the build key array — no dynamic
  fan-out, so one compiled kernel serves every data distribution.
- The probe row computes ONE cell key and the ordinary sorted/hash join
  machinery produces candidate pairs.  Each (probe, build) candidate
  appears under exactly one cell (the probe's own cell), so no
  dedup pass is needed.
- The ORIGINAL geo predicate stays in the residual conjuncts and is
  evaluated exactly over the expanded pair domain (ST_DISTANCE scalar
  arithmetic; ST_CONTAINS/ST_INTERSECTS via the in-kernel segment
  ray-cast, expr_compiler CONTAINS_SEG) — the grid only prunes.

Cell ids pack as (ci << 32) | (cj & 0xFFFFFFFF) with ci/cj clipped to
±2^30: clipping can only merge far-out cells (more candidates, never
fewer), preserving correctness.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from heavydb_tpu_torch.plan import exprs as E

# build-side cell registration offsets
DWITHIN_OFFSETS = tuple(
    (di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)
)
POLY_BUILD_OFFSETS = ((0, 0), (0, 1), (1, 0), (1, 1))
POLY_PROBE_OFFSETS = ((0, 0), (0, -1), (-1, 0), (-1, -1))


@dataclasses.dataclass(frozen=True)
class GeoJoinSpec:
    """Static description of a geo join level (part of the kernel cache
    key — everything here is hashable and shape-stable)."""

    kind: str  # "dwithin" | "poly_build" | "poly_probe"
    cell: Optional[float] = None  # static cell size (dwithin); else aux
    bbox_key: Optional[tuple] = None  # aux key of ("geobbox", arr_ref)
    offsets: Tuple[Tuple[int, int], ...] = ()


def _const_value(e: E.Expr) -> Optional[float]:
    while isinstance(e, E.Cast):
        e = e.operand
    if isinstance(e, E.Constant) and e.value is not None:
        try:
            v = float(e.value)
        except (TypeError, ValueError):
            return None
        if e.type is not None and e.type.is_decimal:
            v = v / 10 ** e.type.scale
        return v
    return None


def _match_sq_dist(e: E.Expr):
    """Match (ax-bx)*(ax-bx) + (ay-by)*(ay-by) → (ax, bx, ay, by)."""
    if not (isinstance(e, E.BinOp) and e.op == E.BinOpKind.ADD):
        return None

    def sq(term):
        if not (isinstance(term, E.BinOp) and term.op == E.BinOpKind.MUL):
            return None
        l, r = term.left, term.right
        if l.key() != r.key():
            return None
        if not (isinstance(l, E.BinOp) and l.op == E.BinOpKind.SUB):
            return None
        return l.left, l.right

    a = sq(e.left)
    b = sq(e.right)
    if a is None or b is None:
        return None
    return a[0], a[1], b[0], b[1]


def match_dwithin(c: E.Expr):
    """Match the binder's ST_DWITHIN / ST_DISTANCE-vs-constant desugar
    (plan/builder.py _bind_geo_fn ST_DISTANCE):
      SQRT((ax-bx)^2 + (ay-by)^2) <= d      (also <, and flipped >= / >)
    Returns (ax, ay, bx, by, d) or None."""
    if not isinstance(c, E.BinOp):
        return None
    K = E.BinOpKind
    if c.op in (K.LE, K.LT):
        dist, lim = c.left, c.right
    elif c.op in (K.GE, K.GT):
        dist, lim = c.right, c.left
    else:
        return None
    d = _const_value(lim)
    if d is None or d < 0:
        return None
    if isinstance(dist, E.Cast):
        dist = dist.operand
    if not (isinstance(dist, E.FunctionOp) and dist.name == "SQRT"
            and len(dist.args) == 1):
        return None
    m = _match_sq_dist(dist.args[0])
    if m is None:
        return None
    ax, bx, ay, by = m
    return ax, ay, bx, by, d


def _side(exprs: List[E.Expr], lo: int, hi: int) -> Optional[str]:
    """'probe' if every field ref of every expr is < lo, 'build' if every
    ref is in [lo, hi); None for mixed/absent refs."""
    refs = []
    for e in exprs:
        refs.extend(E.collect_input_refs(e))
    if not refs:
        return None
    if all(r.field_idx < lo for r in refs):
        return "probe"
    if all(lo <= r.field_idx < hi for r in refs):
        return "build"
    return None


def plan_geo_join(residual: List[E.Expr], lo: int, hi: int):
    """Scan residual conjuncts of a join level for an accelerable geo
    predicate.  Returns (probe_keys, build_keys, GeoJoinSpec, extra_aux)
    or None.  extra_aux = [(aux_key, aux_spec), ...] for the planner to
    register.  The matched conjunct STAYS in the residual — it is the
    exact test; the grid only generates candidates."""
    for c in residual:
        m = match_dwithin(c)
        if m is not None:
            ax, ay, bx, by, d = m
            sa = _side([ax, ay], lo, hi)
            sb = _side([bx, by], lo, hi)
            if sa == "probe" and sb == "build":
                probe, build = [ax, ay], [bx, by]
            elif sa == "build" and sb == "probe":
                probe, build = [bx, by], [ax, ay]
            else:
                continue
            cell = max(float(d), 1e-12)
            spec = GeoJoinSpec(
                kind="dwithin", cell=cell, offsets=DWITHIN_OFFSETS
            )
            return probe, build, spec, []
        # ST_CONTAINS / ST_INTERSECTS polygon-vs-point across tables
        # (binder emits CONTAINS_SEG with point coord args)
        if isinstance(c, E.ArrayFn) and c.op == "CONTAINS_SEG":
            sp = _side([c.rowid], lo, hi)
            spt = _side(list(c.args), lo, hi)
            bbox_key = ("geobbox", c.arr_ref)
            aux = [(bbox_key, ("geobbox", c.arr_ref))]
            if sp == "build" and spt == "probe":
                spec = GeoJoinSpec(
                    kind="poly_build", bbox_key=bbox_key,
                    offsets=POLY_BUILD_OFFSETS,
                )
                return list(c.args), [c.rowid], spec, aux
            if sp == "probe" and spt == "build":
                spec = GeoJoinSpec(
                    kind="poly_probe", bbox_key=bbox_key,
                    offsets=POLY_PROBE_OFFSETS,
                )
                return [c.rowid], list(c.args), spec, aux
    return None
