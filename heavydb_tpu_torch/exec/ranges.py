"""Host-side expression range inference from chunk metadata.

The analogue of the reference's ExpressionRange (QueryEngine/
ExpressionRange.cpp): derives [min, max, has_nulls] for group-by keys and
join keys from per-chunk stats, deciding perfect-hash vs sort-based paths
(reference GroupByAndAggregate::getColRangeInfo:232) and dense-range join
builds (PerfectJoinHashTable)."""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.plan import exprs as E
from heavydb_tpu_torch.plan import rel_alg as R


@dataclass(frozen=True)
class IntRange:
    lo: int
    hi: int  # inclusive
    has_nulls: bool
    # minimum spacing between distinct values (reference ExpressionRange
    # bucket, set by DATE_TRUNC: month starts are ≥28 days apart, so the
    # perfect-hash key space divides by the bucket)
    bucket: int = 1

    @property
    def extent(self) -> int:
        return (self.hi - self.lo) // max(self.bucket, 1) + 1


def combined_input_schema(inputs: Sequence[R.RelNode]):
    """field_idx → (input_pos, local_field_idx) for a Compound's inputs."""
    mapping = []
    for pos, node in enumerate(inputs):
        for i in range(node.arity):
            mapping.append((pos, i))
    return mapping


def column_range(node: R.RelNode, field_idx: int) -> Optional[IntRange]:
    """Range of a field of a rel node, from metadata only."""
    if isinstance(node, R.Scan):
        if field_idx >= len(node.table.columns):
            # virtual rowid field: global positions [0, num_rows)
            return IntRange(0, max(node.table.num_rows - 1, 0), False)
        cd = node.table.columns[field_idx]
        ti = cd.type
        if ti.is_fp:
            return None
        if ti.is_dict_string:
            d = node.table.dicts[cd.col_id]
            mn, mx, has_nulls = node.table.column_range(cd.col_id)
            if node.table.num_rows == 0:
                return IntRange(0, 0, ti.nullable)
            if mn is None:
                return IntRange(0, max(d.size - 1, 0), True)
            return IntRange(int(mn), int(mx), has_nulls)
        if ti.is_integer or ti.is_time or ti.is_boolean or ti.is_decimal:
            mn, mx, has_nulls = node.table.column_range(cd.col_id)
            if mn is None:
                return IntRange(0, 0, ti.nullable) if node.table.num_rows == 0 else None
            return IntRange(int(mn), int(mx), has_nulls)
        return None
    if isinstance(node, R.TableData):
        # a sharded merge's partial rows carry the leaf keys' ranges
        fr = getattr(node, "field_ranges", None)
        return fr[field_idx] if fr is not None and field_idx < len(fr) else None
    if isinstance(node, (R.Filter, R.Sort)):
        return column_range(node.inputs[0], field_idx)
    if isinstance(node, R.Project):
        return expr_range(node.exprs[field_idx], node.inputs)
    if isinstance(node, R.Join):
        la = node.inputs[0].arity
        if field_idx < la:
            return column_range(node.inputs[0], field_idx)
        r = column_range(node.inputs[1], field_idx - la)
        if r is not None and node.kind == "LEFT":
            return IntRange(r.lo, r.hi, True)
        return r
    if isinstance(node, R.Aggregate):
        if field_idx < len(node.group_exprs):
            return expr_range(node.group_exprs[field_idx], node.inputs)
        return None
    if isinstance(node, R.Compound):
        src = node.group_exprs + node.target_exprs if node.group_exprs else node.target_exprs
        if field_idx < len(node.fields):
            # target exprs reference either input domain or agg-output domain;
            # only safe to recurse for the projection (non-agg) case
            if not node.group_exprs and not node.aggs:
                return expr_range(node.target_exprs[field_idx], node.inputs)
        return None
    if isinstance(node, R.Window):
        # pass-through fields keep the child's range; losing them here
        # forced GROUP BYs over window results onto the sort tier
        # (measured 1.8s vs 0.12s at 134M for a 20-group aggregate).
        # Rank-family outputs are bounded by the child row count when it
        # is statically known (reference getExpressionRange on
        # WindowFunction, ExpressionRange.cpp).
        base = node.inputs[0].arity
        if field_idx < base:
            return column_range(node.inputs[0], field_idx)
        w = node.wfuncs[field_idx - base]
        n = _static_row_count(node.inputs[0])
        if n is not None:
            K = E.WindowKind
            if w.kind in (K.ROW_NUMBER, K.RANK, K.DENSE_RANK):
                return IntRange(1, max(n, 1), False)
            if w.kind == K.NTILE:
                return IntRange(1, max(n, 1), False)
            if w.kind == K.COUNT:
                return IntRange(0, max(n, 0), False)
        return None
    return None


def _static_row_count(node: R.RelNode) -> Optional[int]:
    """Statically-known row count of a node, when derivable from table
    metadata alone (filters and joins make it unknown)."""
    if isinstance(node, R.Scan):
        return node.table.num_rows
    if isinstance(node, R.Window):
        return _static_row_count(node.inputs[0])
    if isinstance(node, R.Compound):
        if (len(node.inputs) == 1 and not node.is_aggregate
                and not node.aggs and node.filter_cond is None
                and not any(c is not None for _, c in node.join_levels)):
            return _static_row_count(node.inputs[0])
        return None
    return None


def _field_range(inputs: Sequence[R.RelNode], field_idx: int) -> Optional[IntRange]:
    mapping = combined_input_schema(inputs)
    if field_idx >= len(mapping):
        return None
    pos, local = mapping[field_idx]
    r = column_range(inputs[pos], local)
    return r


def expr_range(e: E.Expr, inputs: Sequence[R.RelNode]) -> Optional[IntRange]:
    if isinstance(e, E.InputRef):
        return _field_range(inputs, e.field_idx)
    if isinstance(e, E.Constant):
        if e.value is None:
            return IntRange(0, 0, True)
        if isinstance(e.value, bool):
            v = int(e.value)
            return IntRange(v, v, False)
        if isinstance(e.value, int):
            return IntRange(e.value, e.value, False)
        return None
    if isinstance(e, E.Cast):
        r = expr_range(e.operand, inputs)
        if r is None:
            return None
        src, dst = e.operand.type, e.type
        if src.is_decimal and dst.is_decimal:
            mult = 10 ** (dst.scale - src.scale)
            if mult >= 1:
                return IntRange(r.lo * mult, r.hi * mult, r.has_nulls)
            div = 10 ** (src.scale - dst.scale)
            return IntRange(r.lo // div, r.hi // div, r.has_nulls)
        if (src.is_integer or src.is_boolean) and (dst.is_integer or dst.kind == T.SQLTypeKind.BIGINT):
            return r
        if (src.is_integer or src.is_boolean) and dst.is_fp:
            # int→float cast keys stay perfect-hashable: the float values
            # are exact integers (reference: ExpressionRange propagates
            # through kCAST; GROUP BY CAST(x AS DOUBLE) is the BH001/PHS001
            # benchmark shape).  FLOAT only below 2^24 (exactness bound).
            if dst.kind == T.SQLTypeKind.FLOAT and not (
                -(1 << 24) <= r.lo and r.hi <= (1 << 24)
            ):
                return None
            return r
        if src.is_integer and dst.is_decimal:
            m = 10**dst.scale
            return IntRange(r.lo * m, r.hi * m, r.has_nulls)
        if src.kind == T.SQLTypeKind.DATE and dst.kind == T.SQLTypeKind.TIMESTAMP:
            m = 86400 * 10**dst.precision
            return IntRange(r.lo * m, r.hi * m, r.has_nulls)
        if src.kind == T.SQLTypeKind.TIMESTAMP and dst.kind == T.SQLTypeKind.DATE:
            m = 86400 * 10**src.precision
            return IntRange(r.lo // m, r.hi // m, r.has_nulls)
        return None
    if isinstance(e, E.BinOp):
        lr = expr_range(e.left, inputs)
        rr = expr_range(e.right, inputs)
        if lr is None or rr is None or not (e.type.is_integer or e.type.is_decimal
                                            or e.type.is_time or e.type.is_boolean):
            if e.type.is_boolean:
                return IntRange(0, 1, (lr.has_nulls if lr else True) or (rr.has_nulls if rr else True))
            return None
        nulls = lr.has_nulls or rr.has_nulls
        if e.op == E.BinOpKind.ADD:
            return IntRange(lr.lo + rr.lo, lr.hi + rr.hi, nulls)
        if e.op == E.BinOpKind.SUB:
            return IntRange(lr.lo - rr.hi, lr.hi - rr.lo, nulls)
        if e.op == E.BinOpKind.MUL:
            cands = [lr.lo * rr.lo, lr.lo * rr.hi, lr.hi * rr.lo, lr.hi * rr.hi]
            return IntRange(min(cands), max(cands), nulls)
        if e.op in E.COMPARISON_OPS or e.op in E.LOGIC_OPS:
            return IntRange(0, 1, nulls)
        return None
    if isinstance(e, E.UnOp):
        if e.op in (E.UnOpKind.ISNULL, E.UnOpKind.ISNOTNULL):
            return IntRange(0, 1, False)
        if e.op == E.UnOpKind.NOT:
            return IntRange(0, 1, True)
        r = expr_range(e.operand, inputs)
        if r is None or e.op != E.UnOpKind.NEG:
            return None
        return IntRange(-r.hi, -r.lo, r.has_nulls)
    if isinstance(e, (E.DictStrPredicate, E.InValues)):
        if e.type.is_boolean:
            return IntRange(0, 1, True)
        return None
    if isinstance(e, E.Extract):
        return _extract_range(e, inputs)
    if isinstance(e, E.DateTrunc):
        r = expr_range(e.operand, inputs)
        if r is None:
            return None
        ti = e.operand.type
        unit = 10**ti.precision if ti.kind == T.SQLTypeKind.TIMESTAMP else 1
        day = 1 if ti.kind == T.SQLTypeKind.DATE else 86400 * unit
        _BUCKET_DAYS = {
            E.ExtractField.SECOND: 0, E.ExtractField.MINUTE: 0,
            E.ExtractField.HOUR: 0, E.ExtractField.DAY: 1,
            E.ExtractField.WEEK: 7, E.ExtractField.MONTH: 28,
            E.ExtractField.QUARTER: 90, E.ExtractField.YEAR: 365,
            E.ExtractField.DECADE: 3652, E.ExtractField.CENTURY: 36524,
            E.ExtractField.MILLENNIUM: 365242,
        }
        days = _BUCKET_DAYS.get(e.field_)
        if days is None:
            return IntRange(r.lo, r.hi, r.has_nulls)
        if days == 0:
            sub = {"SECOND": 1, "MINUTE": 60, "HOUR": 3600}[e.field_.value]
            bucket = sub * unit if ti.kind == T.SQLTypeKind.TIMESTAMP else 1
        else:
            bucket = days * day
        return IntRange(r.lo, r.hi, r.has_nulls, bucket=max(bucket, 1))
    if isinstance(e, E.Case):
        rs = [expr_range(v, inputs) for _, v in e.whens]
        if e.else_ is not None:
            rs.append(expr_range(e.else_, inputs))
        else:
            rs.append(IntRange(0, 0, True))
        if any(r is None for r in rs):
            return None
        return IntRange(
            min(r.lo for r in rs), max(r.hi for r in rs),
            any(r.has_nulls for r in rs),
        )
    return None


_EXTRACT_BOUNDS = {
    E.ExtractField.MONTH: (1, 12),
    E.ExtractField.DAY: (1, 31),
    E.ExtractField.HOUR: (0, 23),
    E.ExtractField.MINUTE: (0, 59),
    E.ExtractField.SECOND: (0, 60),
    E.ExtractField.DOW: (0, 6),
    E.ExtractField.ISODOW: (1, 7),
    E.ExtractField.DOY: (1, 366),
    E.ExtractField.QUARTER: (1, 4),
    E.ExtractField.WEEK: (1, 53),
}


def _extract_range(e: E.Extract, inputs) -> Optional[IntRange]:
    b = _EXTRACT_BOUNDS.get(e.field_)
    opr = expr_range(e.operand, inputs)
    nulls = opr.has_nulls if opr is not None else True
    if b is not None:
        return IntRange(b[0], b[1], nulls)
    if opr is None:
        return None
    ti = e.operand.type
    # convert epoch bounds to the extracted unit on host
    def to_dt(v):
        if ti.kind == T.SQLTypeKind.DATE:
            return _dt.datetime(1970, 1, 1) + _dt.timedelta(days=int(v))
        secs = int(v) // (10**ti.precision)
        return _dt.datetime(1970, 1, 1) + _dt.timedelta(seconds=secs)

    try:
        lo_dt, hi_dt = to_dt(opr.lo), to_dt(opr.hi)
    except OverflowError:
        return None
    if e.field_ == E.ExtractField.YEAR:
        return IntRange(lo_dt.year, hi_dt.year, nulls)
    if e.field_ == E.ExtractField.EPOCH:
        if ti.kind == T.SQLTypeKind.DATE:
            return IntRange(opr.lo * 86400, opr.hi * 86400, nulls)
        m = 10**ti.precision
        return IntRange(opr.lo // m, opr.hi // m, nulls)
    if e.field_ == E.ExtractField.DECADE:
        return IntRange(lo_dt.year // 10, hi_dt.year // 10, nulls)
    return None
