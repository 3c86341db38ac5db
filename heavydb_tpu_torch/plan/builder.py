"""Binder: SQL AST → typed relational-algebra DAG.

Plays the role of Calcite's validator + HeavyDBParser + RelAlgDagBuilder in
the reference (java/calcite CalciteServerHandler.process → RA JSON →
QueryEngine/RelAlgDag.cpp): resolves table/column names, checks and coerces
types, splits aggregates from projections, and emits rel_alg nodes.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.errors import BinderError, NotSupported
from heavydb_tpu_torch.plan import exprs as E
from heavydb_tpu_torch.plan import rel_alg as R
from heavydb_tpu_torch.sql import ast as A
from heavydb_tpu_torch.storage.table import EPOCH

# ---------------------------------------------------------------------------
# DDL type-name resolution
# ---------------------------------------------------------------------------

_TYPE_ALIASES = {
    "INT": T.SQLTypeKind.INT,
    "INTEGER": T.SQLTypeKind.INT,
    "BIGINT": T.SQLTypeKind.BIGINT,
    "SMALLINT": T.SQLTypeKind.SMALLINT,
    "TINYINT": T.SQLTypeKind.TINYINT,
    "FLOAT": T.SQLTypeKind.FLOAT,
    "REAL": T.SQLTypeKind.FLOAT,
    "DOUBLE": T.SQLTypeKind.DOUBLE,
    "BOOLEAN": T.SQLTypeKind.BOOLEAN,
    "BOOL": T.SQLTypeKind.BOOLEAN,
    "TEXT": T.SQLTypeKind.TEXT,
    "VARCHAR": T.SQLTypeKind.TEXT,
    "CHAR": T.SQLTypeKind.TEXT,
    "STR": T.SQLTypeKind.TEXT,
    "DATE": T.SQLTypeKind.DATE,
    "TIME": T.SQLTypeKind.TIME,
    "TIMESTAMP": T.SQLTypeKind.TIMESTAMP,
    "DATETIME": T.SQLTypeKind.TIMESTAMP,
    "DECIMAL": T.SQLTypeKind.DECIMAL,
    "NUMERIC": T.SQLTypeKind.DECIMAL,
}


_GEO_TYPE_NAMES = {
    "POINT": T.SQLTypeKind.GEO_POINT,
    "LINESTRING": T.SQLTypeKind.GEO_LINESTRING,
    "POLYGON": T.SQLTypeKind.GEO_POLYGON,
    "MULTIPOLYGON": T.SQLTypeKind.GEO_MULTIPOLYGON,
}


def resolve_type_name(tn: A.TypeName) -> T.TypeInfo:
    gk = _GEO_TYPE_NAMES.get(tn.name)
    if gk is not None:
        srid = tn.params[0] if tn.params else 0
        # reference default: SRID-4326 geo compresses to GEOINT(32)
        # unless ENCODING NONE; ENCODING COMPRESSED(32) is explicit
        # (Geospatial/Compression.cpp, sqltypes kENCODING_GEOINT)
        if tn.encoding == "COMPRESSED":
            if tn.encoding_param not in (0, 32):
                raise BinderError("geo ENCODING COMPRESSED must be (32)")
            if srid != 4326:
                raise BinderError(
                    "ENCODING COMPRESSED(32) requires SRID 4326")
            compressed = True
        elif tn.encoding == "NONE":
            compressed = False
        else:
            compressed = None  # default by srid
        return T.geo(gk, srid, nullable=not tn.not_null,
                     compressed=compressed)
    kind = _TYPE_ALIASES.get(tn.name)
    if kind is None:
        raise BinderError(f"unknown type {tn.name}")
    if tn.is_array:
        base = resolve_type_name(A.TypeName(tn.name, tn.params,
                                            not_null=tn.not_null,
                                            encoding=tn.encoding))
        return base.as_array()
    nullable = not tn.not_null
    if tn.encoding == "FIXED":
        if kind not in (T.SQLTypeKind.BIGINT, T.SQLTypeKind.INT,
                        T.SQLTypeKind.SMALLINT,
                        T.SQLTypeKind.TIMESTAMP, T.SQLTypeKind.TIME):
            raise NotSupported(f"ENCODING FIXED on {tn.name}")
        if tn.encoding_param not in (8, 16, 32):
            raise BinderError("ENCODING FIXED width must be 8/16/32")
        return T.TypeInfo(kind, nullable, encoding=T.Encoding.FIXED,
                          comp_param=tn.encoding_param)
    if kind == T.SQLTypeKind.DECIMAL:
        p = tn.params[0] if tn.params else 10
        s = tn.params[1] if len(tn.params) > 1 else 0
        if p > 19:
            raise BinderError("DECIMAL precision > 19 unsupported")
        return T.decimal(p, s, nullable)
    if kind == T.SQLTypeKind.TIMESTAMP:
        prec = tn.params[0] if tn.params else 0
        if prec not in (0, 3, 6, 9):
            raise BinderError("TIMESTAMP precision must be 0/3/6/9")
        return T.timestamp(prec, nullable)
    if kind == T.SQLTypeKind.TEXT:
        # TEXT defaults to dictionary encoding (reference kENCODING_DICT)
        if tn.encoding == "NONE":
            return T.text_none(nullable=nullable)
        return T.text_dict(nullable=nullable)
    return T.TypeInfo(kind, nullable)


# ---------------------------------------------------------------------------
# Scope: name → field index in the current row schema
# ---------------------------------------------------------------------------


@dataclass
class FieldBinding:
    field_idx: int
    type: T.TypeInfo
    dict_ref: Optional[tuple] = None  # (table_id, col_id) for dict strings


class Scope:
    """Resolves (qualifier, name) to a field of the current relational row."""

    def __init__(self):
        self.by_alias: Dict[str, Dict[str, FieldBinding]] = {}
        self.order: List[Tuple[str, str, FieldBinding]] = []  # (alias, col, fb)

    def add_relation(self, alias: str, fields, types, dict_refs,
                     hidden_fields=()):
        """hidden_fields: trailing (name, TypeInfo) pseudo-columns that
        resolve by name but are excluded from `SELECT *` expansion
        (reference: virtual rowid is a hidden catalog column)."""
        cols = {}
        # recompute base from total fields so far
        base = sum(len(v) for v in self.by_alias.values())
        for i, (f, t) in enumerate(zip(fields, types)):
            fb = FieldBinding(base + i, t, dict_refs[i] if dict_refs else None)
            cols[f.lower()] = fb
            self.order.append((alias, f, fb))
        for j, (f, t) in enumerate(hidden_fields):
            name = f.lower()
            if name not in cols:  # a real column of that name wins
                cols[name] = FieldBinding(base + len(fields) + j, t, None)
        key = alias.lower()
        if key in self.by_alias:
            raise BinderError(f"duplicate table alias {alias!r}")
        self.by_alias[key] = cols

    def resolve(self, parts: Tuple[str, ...]) -> FieldBinding:
        if len(parts) == 1:
            name = parts[0].lower()
            hits = [
                cols[name] for cols in self.by_alias.values() if name in cols
            ]
            if not hits:
                raise BinderError(f"column {parts[0]!r} not found")
            if len(hits) > 1:
                raise BinderError(f"column {parts[0]!r} is ambiguous")
            return hits[0]
        if len(parts) == 2:
            qual, name = parts[0].lower(), parts[1].lower()
            cols = self.by_alias.get(qual)
            if cols is None:
                raise BinderError(f"unknown table alias {parts[0]!r}")
            fb = cols.get(name)
            if fb is None:
                raise BinderError(f"column {parts[1]!r} not found in {parts[0]!r}")
            return fb
        raise BinderError(f"cannot resolve {'.'.join(parts)}")

    def all_fields(self, qualifier: Optional[str] = None):
        out = []
        for alias, name, fb in self.order:
            if qualifier is None or alias.lower() == qualifier.lower():
                out.append((name, fb))
        if qualifier is not None and not out:
            raise BinderError(f"unknown table alias {qualifier!r}")
        return out


# ---------------------------------------------------------------------------
# Expression binding
# ---------------------------------------------------------------------------

_CMP = {"=", "<>", "<", "<=", ">", ">="}
_ARITH = {"+", "-", "*", "/", "%"}

_AGG_NAMES = {
    "COUNT": E.AggKind.COUNT,
    "SUM": E.AggKind.SUM,
    "AVG": E.AggKind.AVG,
    "MIN": E.AggKind.MIN,
    "MAX": E.AggKind.MAX,
    "SAMPLE": E.AggKind.SAMPLE,
    "ANY_VALUE": E.AggKind.SAMPLE,
    "SINGLE_VALUE": E.AggKind.SINGLE_VALUE,
    "APPROX_COUNT_DISTINCT": E.AggKind.APPROX_COUNT_DISTINCT,
    "APPROX_MEDIAN": E.AggKind.APPROX_QUANTILE,
    "APPROX_QUANTILE": E.AggKind.APPROX_QUANTILE,
    "APPROX_PERCENTILE": E.AggKind.APPROX_QUANTILE,
    "COUNT_IF": E.AggKind.COUNT_IF,
    "SUM_IF": E.AggKind.SUM_IF,
    "MODE": E.AggKind.MODE,
    "STDDEV": E.AggKind.STDDEV,
    "STDDEV_SAMP": E.AggKind.STDDEV,
    "VARIANCE": E.AggKind.VARIANCE,
    "VAR_SAMP": E.AggKind.VARIANCE,
}

# scalar function → (result type rule, arg count range)
_MATH_FNS = {
    "ABS", "CEIL", "CEILING", "FLOOR", "ROUND", "TRUNCATE", "SIGN", "MOD",
    "POWER", "POW", "SQRT", "EXP", "LN", "LOG", "LOG10", "SIN", "COS", "TAN",
    "ASIN", "ACOS", "ATAN", "ATAN2", "DEGREES", "RADIANS", "WIDTH_BUCKET",
}

# string kernels evaluated as dictionary translations (reference
# Shared/sqldefs.h SqlStringOpKind)
_STRING_FNS = {
    "UPPER", "UCASE", "LOWER", "LCASE", "INITCAP", "REVERSE", "TRIM",
    "LTRIM", "RTRIM", "SUBSTRING", "SUBSTR", "MID", "REPLACE", "LPAD",
    "RPAD",
    "REPEAT", "SPLIT_PART", "REGEXP_REPLACE", "BASE64_ENCODE",
    "BASE64_DECODE", "URL_ENCODE", "URL_DECODE", "OVERLAY", "JSON_VALUE",
    "REGEXP_SUBSTR", "LEFT", "RIGHT", "LLM_TRANSFORM",
}

# integer-valued string kernels → per-entry int lookup tables
_INT_STRING_FNS = {
    "INSTR": "POSITION",
    "STRPOS": "POSITION",
    "POSITION": "POSITION",
    "REGEXP_COUNT": "REGEXP_COUNT",
    "LEVENSHTEIN_DISTANCE": "LEVENSHTEIN",
    "LEVENSHTEIN": "LEVENSHTEIN",
    "JAROWINKLER_SIMILARITY": "JAROWINKLER",
    "HASH": "HASH",
}

_EXTRACT_MAP = {f.value: f for f in E.ExtractField}


class ExprBinder:
    def __init__(self, scope: Scope, db, allow_aggs: bool, outer_scope=None,
                 cte_env=None, alias_env=None):
        self.scope = scope
        self.db = db  # Database facade for subquery planning
        self.allow_aggs = allow_aggs
        self.aggs: List[E.Agg] = []
        # enclosing query's scope, for correlated subqueries (reference
        # Analyzer::Var with rte_idx pointing at the outer query)
        self.outer_scope = outer_scope
        # enclosing query's CTEs, visible to subqueries (SQL scoping)
        self.cte_env = cte_env
        # select-list alias fallback (HeavyDB/Calcite dialect: HAVING may
        # reference projection aliases, e.g. SUM(x) AS sx ... HAVING sx<1)
        self.alias_env = alias_env or {}
        self.used_outer = False

    # -- public --
    def bind(self, node: A.Expr) -> E.Expr:
        e = self._bind(node)
        return e

    def bind_condition(self, node: A.Expr) -> E.Expr:
        e = self._bind(node)
        if not (e.type.is_boolean or e.type.is_null_type):
            raise BinderError(f"condition must be BOOLEAN, got {e.type}")
        return e

    # -- dispatch --
    def _bind(self, node: A.Expr) -> E.Expr:
        m = getattr(self, "_bind_" + type(node).__name__, None)
        if m is None:
            raise NotSupported(f"expression {type(node).__name__} not supported")
        return m(node)

    def _bind_Literal(self, node: A.Literal) -> E.Expr:
        if node.kind == "null":
            return E.Constant(None, T.null_type())
        if node.kind == "bool":
            return E.Constant(1 if node.value else 0, T.boolean(nullable=False))
        if node.kind == "string":
            return E.Constant(node.value, T.TypeInfo(T.SQLTypeKind.TEXT, False))
        if node.kind == "num_int":
            return E.Constant(int(node.value), T.literal_type(int(node.value)))
        if node.kind == "num_decimal":
            # exact decimal literal: scale from text (reference treats 2.5 as DECIMAL)
            txt = node.text.lstrip("+-")
            if "." in txt:
                frac = txt.split(".")[1]
                scale = len(frac)
                digits = txt.replace(".", "").lstrip("0") or "0"
                prec = max(len(digits), scale + 1)
                if prec <= 19:
                    sval = int(round(float(node.value) * 10**scale))
                    neg = node.text.lstrip().startswith("-")
                    sval = int(txt.replace(".", "")) * (-1 if neg else 1)
                    return E.Constant(sval, T.decimal(prec, scale, False))
            return E.Constant(float(node.value), T.double(nullable=False))
        return E.Constant(float(node.value), T.double(nullable=False))

    def _bind_Identifier(self, node: A.Identifier) -> E.Expr:
        try:
            fb = self.scope.resolve(node.parts)
        except BinderError:
            if len(node.parts) == 1 \
                    and node.parts[0].lower() in self.alias_env:
                return self.alias_env[node.parts[0].lower()]
            if self.outer_scope is None:
                raise
            fb = self.outer_scope.resolve(node.parts)
            self.used_outer = True
            return E.OuterRef(fb.field_idx, fb.type, fb.dict_ref)
        return E.InputRef(0, fb.field_idx, fb.type, fb.dict_ref)

    def _bind_Unary(self, node: A.Unary) -> E.Expr:
        operand = self._bind(node.operand)
        if node.op == "NOT":
            if not operand.type.is_boolean and not operand.type.is_null_type:
                raise BinderError("NOT requires boolean")
            return E.UnOp(E.UnOpKind.NOT, operand, T.boolean(operand.type.nullable))
        if node.op == "-":
            if not operand.type.is_number:
                raise BinderError("unary minus requires numeric")
            return E.UnOp(E.UnOpKind.NEG, operand, operand.type)
        return operand

    def _bind_IsNull(self, node: A.IsNull) -> E.Expr:
        operand = self._bind(node.operand)
        kind = E.UnOpKind.ISNOTNULL if node.negated else E.UnOpKind.ISNULL
        if (operand.type.is_geo or operand.type.is_array) \
                and getattr(operand, "dict_ref", None) is not None:
            # geo/array columns compile to a rowid HANDLE (never null
            # itself); nullness lives in the aux lengths — probe it via
            # CARDINALITY, whose result is NULL exactly for null values
            operand = E.ArrayFn(
                op="CARDINALITY", arr_ref=operand.dict_ref, rowid=operand,
                elem=operand.type.elem_type(), type=T.integer(True),
            )
        return E.UnOp(kind, operand, T.boolean(nullable=False))

    def _bind_Binary(self, node: A.Binary) -> E.Expr:
        op = node.op
        if op in ("AND", "OR"):
            l = self.bind_condition(node.left)
            r = self.bind_condition(node.right)
            return E.BinOp(
                E.BinOpKind(op), l, r, T.boolean(l.type.nullable or r.type.nullable)
            )
        if op in ("+", "-") and isinstance(node.right, A.IntervalLit):
            # d ± INTERVAL 'n' unit → DATEADD_<unit>(d, ±n) with civil
            # month-end clamping (reference DateAdd.cpp semantics)
            l = self._bind(node.left)
            if not l.type.is_time:
                raise BinderError("INTERVAL arithmetic needs date/timestamp")
            iv = node.right
            amount = self._bind(iv.value)
            if op == "-":
                if isinstance(amount, E.Constant):
                    amount = E.Constant(-amount.value, amount.type)
                else:
                    amount = E.BinOp(
                        E.BinOpKind.SUB,
                        E.Constant(0, amount.type.with_nullable(False)),
                        amount, amount.type,
                    )
            unit = iv.unit.upper().rstrip("S")
            return E.FunctionOp(
                f"DATEADD_{unit}", (l, amount),
                l.type.with_nullable(l.type.nullable),
            )
        if op in ("+", "-") and isinstance(node.left, A.IntervalLit) \
                and op == "+":
            # INTERVAL + d (commutes)
            return self._bind_Binary(
                A.Binary("+", node.right, node.left)
            )
        l = self._bind(node.left)
        r = self._bind(node.right)
        if op == "||":
            if isinstance(l, E.Constant) and isinstance(r, E.Constant):
                return E.Constant(
                    str(l.value) + str(r.value),
                    T.TypeInfo(T.SQLTypeKind.TEXT, False),
                )
            if (l.type.is_dict_string or isinstance(l, E.StringTransform)) \
                    and isinstance(r, E.Constant) and r.type.is_string:
                return self._extend_transform(l, ("CONCAT", (str(r.value),)))
            if (r.type.is_dict_string or isinstance(r, E.StringTransform)) \
                    and isinstance(l, E.Constant) and l.type.is_string:
                return self._extend_transform(r, ("PRECONCAT", (str(l.value),)))
            if l.type.is_dict_string and r.type.is_dict_string:
                return self._bind_pair_concat(l, r)
            raise NotSupported("|| between two string columns")
        if op in _CMP:
            return self._bind_comparison(op, l, r)
        if op in _ARITH:
            return self._bind_arith(op, l, r, node)
        raise NotSupported(f"operator {op}")

    def _bind_comparison(self, op: str, l: E.Expr, r: E.Expr) -> E.Expr:
        if l.type.is_array and r.type.is_array and op in ("=", "<>"):
            # whole-array equality — evaluated host-side per table row
            # (reference Analyzer::BinOper over array operands)
            if l.type.elem_type().kind != r.type.elem_type().kind:
                raise BinderError(
                    "array comparison requires matching element types"
                )
            lref = getattr(l, "dict_ref", None)
            rref = getattr(r, "dict_ref", None)
            if lref is None or rref is None or lref[0] != rref[0]:
                raise NotSupported(
                    "array comparison requires two array columns of the "
                    "same table"
                )
            eq = E.ArrayFn(
                op="ARR_EQ", arr_ref=lref, rowid=l, args=(r,),
                elem=l.type.elem_type(),
                type=T.boolean(True),
            )
            if op == "<>":
                return E.UnOp(E.UnOpKind.NOT, eq, T.boolean(True))
            return eq
        if l.type.is_array or r.type.is_array:
            raise BinderError(
                "arrays cannot be compared directly (use = ANY / <> ALL)"
            )
        # dict-string vs string literal → launch-time dictionary predicate
        lt, rt = l.type, r.type
        if lt.is_dict_string or rt.is_dict_string:
            if isinstance(r, E.Constant) and rt.is_string and not rt.is_dict_string:
                return self._dict_cmp(l, op, r)
            if isinstance(l, E.Constant) and lt.is_string and not lt.is_dict_string:
                flipped = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
                return self._dict_cmp(r, flipped, l)
            if lt.is_dict_string and rt.is_dict_string:
                def side(e):
                    if isinstance(e, E.StringTransform):
                        return e.arg, e.ops, e.src_dict_ref
                    return e, (), getattr(e, "dict_ref", None)

                la, lops, lref = side(l)
                ra, rops, rref = side(r)
                nullable = lt.nullable or rt.nullable
                if (op in ("=", "<>") and not lops and not rops
                        and lref is not None and lref == rref):
                    # same dictionary → direct id compare
                    return E.BinOp(E.BinOpKind(op), l, r,
                                   T.boolean(nullable))
                # different dictionaries (or transform chains, or an
                # ordering op) → merged-rank tables: exact string
                # semantics, one int gather per side
                if lref is None or rref is None:
                    raise NotSupported(
                        "string comparison on computed strings")
                return E.DictPairCompare(
                    left=la, right=ra, op=op, left_ops=lops,
                    right_ops=rops, left_ref=lref, right_ref=rref,
                    type=T.boolean(nullable),
                )
            raise NotSupported(f"comparison {lt} {op} {rt}")
        if lt.is_string and rt.is_string:
            # two string literals — compare host-side
            res = _host_str_cmp(op, l.value, r.value)
            return E.Constant(1 if res else 0, T.boolean(False))
        # DATE/TIMESTAMP/TIME vs string literal: implicit literal parse
        # (reference: Calcite inserts the cast; Analyzer CastExpr)
        if lt.is_time and isinstance(r, E.Constant) and rt.is_string:
            r = E.Constant(_const_cast(r.value, rt, lt),
                           lt.with_nullable(r.value is None))
            rt = r.type
        elif rt.is_time and isinstance(l, E.Constant) and lt.is_string:
            l = E.Constant(_const_cast(l.value, lt, rt),
                           rt.with_nullable(l.value is None))
            lt = l.type
        if (lt.is_number or lt.is_time or lt.is_boolean) and (
            rt.is_number or rt.is_time or rt.is_boolean or rt.is_null_type
        ) or lt.is_null_type:
            l2, r2 = self._coerce_pair(l, r)
            nullable = l2.type.nullable or r2.type.nullable
            return E.BinOp(E.BinOpKind(op), l2, r2, T.boolean(nullable))
        raise BinderError(f"cannot compare {lt} and {rt}")

    def _dict_cmp(self, arg: E.Expr, op: str, lit: E.Constant) -> E.Expr:
        dict_ref = getattr(arg, "dict_ref", None)
        if dict_ref is None:
            raise NotSupported("string comparison on computed string expression")
        return E.DictStrPredicate(
            arg=arg,
            kind="CMP",
            cmp_op=op,
            pattern=str(lit.value),
            dict_ref=dict_ref,
            type=T.boolean(arg.type.nullable),
        )

    def _bind_arith(self, op: str, l: E.Expr, r: E.Expr, node) -> E.Expr:
        lt, rt = l.type, r.type
        # date/timestamp ± interval
        if lt.is_time and isinstance(node.right, A.IntervalLit):
            raise AssertionError  # handled in _bind_IntervalLit path
        if lt.is_time and rt.is_time and op == "-":
            # timestamp difference in seconds (coerce both to TIMESTAMP(0))
            l2 = self._cast_to(l, T.timestamp(0, lt.nullable))
            r2 = self._cast_to(r, T.timestamp(0, rt.nullable))
            return E.BinOp(
                E.BinOpKind.SUB, l2, r2, T.bigint(lt.nullable or rt.nullable)
            )
        if not (lt.is_number or lt.is_null_type) or not (rt.is_number or rt.is_null_type):
            raise BinderError(f"arithmetic on {lt} and {rt}")
        if op == "/" and (lt.is_integer and rt.is_integer):
            # SQL integer division semantics (truncating)
            l2, r2 = self._coerce_pair(l, r)
            return E.BinOp(E.BinOpKind.DIV, l2, r2, l2.type.with_nullable(
                lt.nullable or rt.nullable))
        l2, r2 = self._coerce_pair(l, r)
        out = T.common_numeric_type(l2.type, r2.type)
        if out.is_decimal and op == "*":
            # product scale = sum of scales, capped
            ls = l2.type.scale if l2.type.is_decimal else 0
            rs = r2.type.scale if r2.type.is_decimal else 0
            out = T.decimal(min(19, out.precision + min(ls, rs)), ls + rs,
                            out.nullable)
        if out.is_decimal and op == "/":
            out = T.double(out.nullable)
            l2 = self._cast_to(l2, T.double(l2.type.nullable))
            r2 = self._cast_to(r2, T.double(r2.type.nullable))
        if op == "%":
            if not (l2.type.is_integer and r2.type.is_integer):
                out = T.double(out.nullable)
        return E.BinOp(E.BinOpKind(op), l2, r2, out)

    def _coerce_pair(self, l: E.Expr, r: E.Expr):
        lt, rt = l.type, r.type
        if lt.is_null_type or rt.is_null_type:
            return l, r
        if lt.is_boolean and rt.is_boolean:
            return l, r
        if lt.is_time or rt.is_time:
            if lt.kind == rt.kind and lt.precision == rt.precision:
                return l, r
            if lt.is_time and rt.is_time:
                target = T.timestamp(max(lt.precision, rt.precision),
                                     lt.nullable or rt.nullable)
                return self._cast_to(l, target), self._cast_to(r, target)
            # time vs number (epoch compare) — cast number side
            if lt.is_time and rt.is_number:
                return l, self._cast_to(r, lt.with_nullable(rt.nullable))
            if rt.is_time and lt.is_number:
                return self._cast_to(l, rt.with_nullable(lt.nullable)), r
        common = T.common_numeric_type(lt, rt)
        return self._cast_to(l, common), self._cast_to(r, common)

    def _cast_to(self, e: E.Expr, target: T.TypeInfo) -> E.Expr:
        src = e.type
        if src.kind == target.kind and src.scale == target.scale and (
            src.precision == target.precision or not src.is_decimal
        ):
            return e
        if src.is_null_type:
            return E.Constant(None, target.with_nullable(True))
        t = target.with_nullable(src.nullable)
        if isinstance(e, E.Constant):
            return E.Constant(_const_cast(e.value, src, t), t)
        return E.Cast(e, t)

    def _bind_Between(self, node: A.Between) -> E.Expr:
        a = A.Binary(">=", node.operand, node.low)
        b = A.Binary("<=", node.operand, node.high)
        both = A.Binary("AND", a, b)
        e = self._bind(both)
        if node.negated:
            return E.UnOp(E.UnOpKind.NOT, e, e.type)
        return e

    def _bind_InList(self, node: A.InList) -> E.Expr:
        arg = self._bind(node.operand)
        vals = []
        item_types = []
        for it in node.items:
            c = self._bind(it)
            if not isinstance(c, E.Constant):
                # non-constant IN items → OR chain
                ors = None
                for it2 in node.items:
                    cmp_ = A.Binary("=", node.operand, it2)
                    ors = cmp_ if ors is None else A.Binary("OR", ors, cmp_)
                e = self._bind(ors)
                if node.negated:
                    return E.UnOp(E.UnOpKind.NOT, e, e.type)
                return e
            vals.append(c)
            item_types.append(c.type)
        if arg.type.is_dict_string:
            # IN over strings: launch-time union of EQ predicates → one table
            pats = tuple(str(v.value) for v in vals if v.value is not None)
            return E.DictStrPredicate(
                arg=arg, kind="IN", pattern="\x00".join(pats),
                negated=node.negated,
                dict_ref=getattr(arg, "dict_ref", None),
                type=T.boolean(arg.type.nullable),
            )
        # numeric/time IN: coerce constants to arg type
        phys = []
        for c in vals:
            if c.value is None:
                continue
            phys.append(_const_cast(c.value, c.type, arg.type))
        return E.InValues(
            arg=arg, values=tuple(phys), negated=node.negated,
            type=T.boolean(arg.type.nullable),
        )

    def _bind_Like(self, node: A.Like) -> E.Expr:
        arg = self._bind(node.operand)
        if not arg.type.is_dict_string:
            raise NotSupported("LIKE on non-dictionary strings")
        pat = self._bind(node.pattern)
        if not isinstance(pat, E.Constant):
            raise NotSupported("non-constant LIKE pattern")
        escape = None
        if node.escape is not None:
            esc = self._bind(node.escape)
            escape = str(esc.value)
        return E.DictStrPredicate(
            arg=arg,
            kind="ILIKE" if node.ilike else "LIKE",
            pattern=str(pat.value),
            escape=escape,
            negated=node.negated,
            dict_ref=getattr(arg, "dict_ref", None),
            type=T.boolean(arg.type.nullable),
        )

    def _bind_CaseWhen(self, node: A.CaseWhen) -> E.Expr:
        whens = [(self.bind_condition(c), self._bind(r)) for c, r in node.whens]
        else_ = self._bind(node.else_) if node.else_ is not None else None
        # unify result types
        res_types = [r.type for _, r in whens] + (
            [else_.type] if else_ is not None else []
        )
        target = res_types[0]
        for rt in res_types[1:]:
            if rt.is_null_type:
                target = target.with_nullable(True)
                continue
            if target.is_null_type:
                target = rt.with_nullable(True)
                continue
            if rt.is_dict_string and target.is_dict_string:
                continue
            target = T.common_numeric_type(target, rt)
        if else_ is None:
            target = target.with_nullable(True)
        if target.is_string or any(
            r.type.is_string for r in
            ([w for _, w in whens] + ([else_] if else_ is not None else []))
        ):
            return self._bind_string_case(whens, else_)
        whens2 = tuple((c, self._cast_to(r, target)) for c, r in whens)
        else2 = self._cast_to(else_, target) if else_ is not None else None
        return E.Case(whens2, else2, target)

    def _bind_string_case(self, whens, else_) -> E.Expr:
        """CASE yielding strings.  String literal results go into a per-query
        transient dictionary (reference StringDictionaryProxy transient ids,
        StringDictionaryProxy.h:39); all-dict-ref results must share one
        dictionary."""
        results = [r for _, r in whens] + ([else_] if else_ is not None else [])
        dict_refs = set()
        has_literal = False
        for r in results:
            if isinstance(r, E.Constant):
                if r.value is None:
                    continue
                if r.type.is_string and not r.type.is_dict_string:
                    has_literal = True
                    continue
                raise NotSupported("mixed string/non-string CASE")
            ref = getattr(r, "dict_ref", None)
            if ref is None:
                raise NotSupported("CASE over computed strings")
            dict_refs.add(ref)
        if len(dict_refs) > 1:
            raise NotSupported("CASE over columns of different dictionaries")
        if dict_refs:
            ref = next(iter(dict_refs))
            target = T.text_dict(nullable=True)
            if has_literal:
                # intern literals into the column's dictionary (role of the
                # reference's transient proxy ids)
                d = self.db.dict_by_ref(ref)

                def fix(r):
                    if isinstance(r, E.Constant) and r.value is not None and \
                            r.type.is_string and not r.type.is_dict_string:
                        return E.Constant(d.get_or_add(str(r.value)), target)
                    if isinstance(r, E.Constant) and r.value is None:
                        return E.Constant(None, target)
                    return r

                whens = tuple((c, fix(r)) for c, r in whens)
                else_ = fix(else_) if else_ is not None else None
            return E.Case(tuple(whens), else_, target, dict_ref=ref)
        # all literals → transient dictionary
        ref, tdict = self.db.register_transient_dict()
        target = T.text_dict(nullable=True)

        def to_id(r):
            if r is None:
                return None
            if isinstance(r, E.Constant) and r.value is None:
                return E.Constant(None, target)
            return E.Constant(tdict.get_or_add(str(r.value)), target)

        whens2 = tuple((c, to_id(r)) for c, r in whens)
        else2 = to_id(else_)
        return E.Case(whens2, else2, target, dict_ref=ref)

    def _bind_Cast(self, node: A.Cast) -> E.Expr:
        operand = self._bind(node.operand)
        target = resolve_type_name(node.type_name)
        if getattr(node, "try_", False) and operand.type.is_dict_string \
                and (target.is_number or target.kind in (
                    T.SQLTypeKind.DATE, T.SQLTypeKind.TIMESTAMP,
                    T.SQLTypeKind.TIME)):
            # TRY_CAST(text AS numeric): per-dictionary-entry parse table
            # (reference TRY_CAST string op); unparsable → NULL
            import json as _json

            return E.DictStrPredicate(
                arg=operand, kind="TRYCAST",
                pattern=_json.dumps([target.kind.value, target.scale]),
                dict_ref=getattr(operand, "dict_ref", None),
                type=target.with_nullable(True),
            )
        if target.is_dict_string:
            if operand.type.is_dict_string:
                return operand
            raise NotSupported("CAST to TEXT")
        if operand.type.is_string and isinstance(operand, E.Constant):
            return E.Constant(
                _const_cast(operand.value, operand.type, target),
                target.with_nullable(False),
            )
        return self._cast_to(operand, target)

    def _bind_ExtractExpr(self, node: A.ExtractExpr) -> E.Expr:
        operand = self._bind(node.operand)
        if not operand.type.is_time:
            raise BinderError(f"EXTRACT from {operand.type}")
        fld = _EXTRACT_MAP.get(node.field_)
        if fld is None:
            raise NotSupported(f"EXTRACT field {node.field_}")
        return E.Extract(fld, operand, T.bigint(operand.type.nullable))

    def _bind_IntervalLit(self, node: A.IntervalLit):
        raise BinderError("INTERVAL literal only valid in +/- with a date/timestamp")

    def _plan_subquery(self, sub):
        """Plan a subquery with this binder's scope as the outer scope so
        correlated references bind to OuterRefs."""
        from heavydb_tpu_torch.plan.select_planner import SelectPlanner, plan_has_outer_refs

        planner = SelectPlanner(self.db, cte_env=self.cte_env,
                                outer_scope=self.scope)
        plan = planner.plan(sub)
        return plan, plan_has_outer_refs(plan)

    def _bind_ScalarSubquery(self, node: A.ScalarSubquery) -> E.Expr:
        plan, correlated = self._plan_subquery(node.subquery)
        if plan.arity != 1:
            raise BinderError("scalar subquery must return one column")
        # correlated scalar subqueries are decorrelated by the planner
        # (SelectPlanner._decorrelate_scalar → LEFT JOIN on the regrouped
        # aggregate); uncorrelated ones are materialized by the executor
        return E.SubqueryExpr(
            plan=plan, kind="scalar", correlated=correlated,
            type=plan.types[0].with_nullable(True),
        )

    def _bind_InSubquery(self, node: A.InSubquery) -> E.Expr:
        arg = self._bind(node.operand)
        plan, correlated = self._plan_subquery(node.subquery)
        if plan.arity != 1:
            raise BinderError("IN subquery must return one column")
        if correlated and node.negated:
            raise NotSupported(
                "correlated NOT IN (NULL semantics); use NOT EXISTS"
            )
        return E.SubqueryExpr(
            plan=plan, kind="in", arg=arg, negated=node.negated,
            correlated=correlated, type=T.boolean(arg.type.nullable),
        )

    def _bind_Exists(self, node: A.Exists) -> E.Expr:
        plan, correlated = self._plan_subquery(node.subquery)
        return E.SubqueryExpr(
            plan=plan, kind="exists", negated=node.negated,
            correlated=correlated, type=T.boolean(nullable=False),
        )

    # ---- arrays (reference QueryEngine/ArrayIR.cpp) ----
    def _array_base(self, ast_node) -> E.Expr:
        """Bind an expression that must be an ARRAY column reference."""
        base = self._bind(ast_node)
        if not base.type.is_array:
            raise BinderError("expected an ARRAY column")
        if getattr(base, "dict_ref", None) is None or not isinstance(
            base, E.InputRef
        ):
            raise NotSupported(
                "array operations on computed arrays (base-table array "
                "columns only)"
            )
        return base

    def _bind_Subscript(self, node: A.Subscript) -> E.Expr:
        base = self._array_base(node.base)
        idx = self._bind(node.index)
        if not idx.type.is_integer:
            raise BinderError("array subscript must be an integer")
        eti = base.type.elem_type()
        return E.ArrayFn(
            op="SUBSCRIPT", arr_ref=base.dict_ref, rowid=base, args=(idx,),
            elem=eti, type=eti.with_nullable(True),
            dict_ref=base.dict_ref if eti.is_dict_string else None,
        )

    def _bind_QuantCmp(self, node: A.QuantCmp) -> E.Expr:
        if isinstance(node.rhs, A.ScalarSubquery):
            return self._bind_quant_subquery(node)
        base = self._array_base(node.rhs)
        lhs = self._bind(node.lhs)
        if not isinstance(lhs, E.Constant):
            raise NotSupported(
                f"{node.quant} comparison with a non-constant left side"
            )
        return E.ArrayFn(
            op=node.quant, arr_ref=base.dict_ref, rowid=base, args=(lhs,),
            cmp_op=node.op, elem=base.type.elem_type(),
            type=T.boolean(True),
        )

    def _bind_quant_subquery(self, node: A.QuantCmp) -> E.Expr:
        """x <op> ANY/SOME/ALL (SELECT c ...) — expanded at the AST level
        (reference: Calcite SubQueryRemoveRule): = ANY → IN, <> ALL →
        NOT IN; ordered comparisons become guarded MIN/MAX scalar
        aggregates with COUNT(*)/COUNT(c) guards for empty-set and
        NULL-element semantics.  Correlated subqueries compose with
        scalar-subquery decorrelation."""
        import copy

        sub = node.rhs.subquery
        op, quant = node.op, node.quant
        if op == "=" and quant == "ANY":
            return self._bind(A.InSubquery(node.lhs, sub, False))
        if op == "<>" and quant == "ALL":
            return self._bind(A.InSubquery(node.lhs, sub, True))
        if not sub.projections or isinstance(sub.projections[0][0], A.Star):
            raise BinderError("quantified subquery must select one column")
        proj_ast = sub.projections[0][0]

        def agg_sq(fn=None, star=False):
            s = copy.deepcopy(sub)
            if star:
                s.projections = [(A.FuncCall("COUNT", [], star=True), None)]
            else:
                s.projections = [
                    (A.FuncCall(fn, [copy.deepcopy(proj_ast)]), None)
                ]
            s.order_by, s.limit, s.offset = [], None, None
            return A.ScalarSubquery(s)

        def x():
            return copy.deepcopy(node.lhs)

        mn, mx = agg_sq("MIN"), agg_sq("MAX")
        if op in ("=", "<>"):
            both = A.Binary("AND", A.Binary("=", x(), mn),
                            A.Binary("=", x(), mx))
            # = ALL: every non-null element equals x; <> ANY: some differs
            sat = both if (op, quant) == ("=", "ALL") else A.Unary("NOT", both)
        else:
            # monotone comparisons reduce to one extremum: the witness for
            # ANY / the universal bound for ALL
            ext = {
                (">", "ANY"): mn, (">=", "ANY"): mn,
                ("<", "ANY"): mx, ("<=", "ANY"): mx,
                (">", "ALL"): mx, (">=", "ALL"): mx,
                ("<", "ALL"): mn, ("<=", "ALL"): mn,
            }[(op, quant)]
            sat = A.Binary(op, x(), ext)
        cnt_all, cnt_nn = agg_sq(star=True), agg_sq("COUNT")
        null_l = A.Literal(None, "null")
        has_null = A.Binary("<", cnt_nn, copy.deepcopy(cnt_all))
        if quant == "ANY":
            out = A.CaseWhen(whens=[
                (A.Binary("=", cnt_all, A.Literal(0, "num_int")),
                 A.Literal(False, "bool")),
                (sat, A.Literal(True, "bool")),
                (has_null, null_l),
                (A.IsNull(x(), False), null_l),
            ], else_=A.Literal(False, "bool"))
        else:
            out = A.CaseWhen(whens=[
                (A.Binary("=", cnt_all, A.Literal(0, "num_int")),
                 A.Literal(True, "bool")),
                (A.Unary("NOT", sat), A.Literal(False, "bool")),
                (has_null, null_l),
                (A.IsNull(x(), False), null_l),
            ], else_=A.Literal(True, "bool"))
        return self._bind(out)

    def _bind_ArrayLiteral(self, node: A.ArrayLiteral) -> E.Expr:
        raise NotSupported(
            "array literals outside INSERT ... VALUES"
        )

    # ---- geospatial (reference QueryEngine/GeoIR.cpp + Geospatial/) ----
    def _geo_xy(self, ast_node) -> Tuple[E.Expr, E.Expr]:
        """A POINT-valued AST node → (x expr, y expr).  Columns become
        coordinate gathers (flat[off], flat[off+1]); WKT literals and
        ST_Point become scalar expressions."""
        from heavydb_tpu_torch.storage.table import wkt_to_coords

        if isinstance(ast_node, A.Literal) and ast_node.kind == "string":
            c = wkt_to_coords(ast_node.value, T.SQLTypeKind.GEO_POINT)
            return (E.Constant(float(c[0]), T.double(False)),
                    E.Constant(float(c[1]), T.double(False)))
        if isinstance(ast_node, A.FuncCall):
            if ast_node.name in ("ST_GEOMFROMTEXT", "ST_GEOGFROMTEXT"):
                return self._geo_xy(ast_node.args[0])
            if ast_node.name == "ST_TRANSFORM":
                # WGS84 → Web Mercator only, like the reference
                # (ExtensionFunctionsGeo.hpp conv_4326_900913)
                srid = self._bind(ast_node.args[1])
                if not isinstance(srid, E.Constant) \
                        or int(srid.value) != 900913:
                    raise NotSupported(
                        "ST_TRANSFORM supports target SRID 900913")
                x, y = self._geo_xy(ast_node.args[0])
                ti = T.double(x.type.nullable or y.type.nullable)

                def c(v):
                    return E.Constant(float(v), T.double(False))

                xs = E.BinOp(E.BinOpKind.MUL, x, c(111319.490778), ti)
                inner = E.BinOp(
                    E.BinOpKind.ADD,
                    E.BinOp(E.BinOpKind.MUL, y, c(0.00872664626), ti),
                    c(0.785398163397), ti,
                )
                ys = E.BinOp(
                    E.BinOpKind.MUL, c(6378136.99911),
                    E.FunctionOp(
                        "LN", (E.FunctionOp("TAN", (inner,), ti),), ti
                    ),
                    ti,
                )
                return xs, ys
            if ast_node.name == "ST_POINT":
                x = self._bind(ast_node.args[0])
                y = self._bind(ast_node.args[1])
                return (E.Cast(x, T.double(x.type.nullable)),
                        E.Cast(y, T.double(y.type.nullable)))
            if ast_node.name == "ST_CENTROID":
                # centroid as an (x, y) scalar pair — usable anywhere a
                # point is (ST_X/Y, ST_DISTANCE, ST_DWITHIN joins);
                # reference ST_Centroid (ExtensionFunctionsGeo.hpp):
                # area-weighted for polygons, vertex mean for lines
                base = self._array_base(ast_node.args[0])
                if not base.type.is_geo:
                    raise BinderError("ST_CENTROID expects a geometry")
                eti = base.type.elem_type()

                def cfn(op):
                    return E.ArrayFn(
                        op=op, arr_ref=base.dict_ref, rowid=base,
                        elem=eti, type=T.double(True),
                    )

                return cfn("CENTROID_X"), cfn("CENTROID_Y")
        base = self._array_base(ast_node)
        if base.type.kind != T.SQLTypeKind.GEO_POINT:
            raise BinderError("expected a POINT column or WKT literal")
        eti = base.type.elem_type()

        def coord(i):
            return E.ArrayFn(
                op="SUBSCRIPT", arr_ref=base.dict_ref, rowid=base,
                args=(E.Constant(i, T.integer(False)),), elem=eti,
                type=T.double(True),
            )

        return coord(1), coord(2)

    def _bind_geo_fn(self, node: A.FuncCall) -> Optional[E.Expr]:
        name = node.name
        K = T.SQLTypeKind
        if name in ("ST_X", "ST_Y") and len(node.args) == 1:
            x, y = self._geo_xy(node.args[0])
            return x if name == "ST_X" else y
        if name in ("ST_XMIN", "ST_XMAX", "ST_YMIN", "ST_YMAX") \
                and len(node.args) == 1:
            # bbox corner per geometry (reference ExtensionFunctionsGeo
            # ST_XMin/XMax/YMin/YMax over any geo type)
            base = self._array_base(node.args[0])
            if not base.type.is_geo:
                raise BinderError(f"{name} expects a geometry")
            return E.ArrayFn(
                op=name[3:], arr_ref=base.dict_ref, rowid=base,
                elem=base.type.elem_type(), type=T.double(True),
            )
        if name == "ST_WITHIN" and len(node.args) == 2:
            # ST_Within(a, b) == ST_Contains(b, a)
            # (reference ExtensionFunctionsGeo.hpp ST_Within → flipped
            # ST_Contains)
            return self._bind_geo_fn(A.FuncCall(
                "ST_CONTAINS", [node.args[1], node.args[0]]
            ))
        if name == "ST_SRID" and len(node.args) == 1:
            base = self._array_base(node.args[0])
            if not base.type.is_geo:
                raise BinderError("ST_SRID expects a geometry")
            return E.Constant(int(base.type.comp_param or 0),
                              T.integer(False))
        if name == "ST_NRINGS" and len(node.args) == 1:
            base = self._array_base(node.args[0])
            if base.type.kind not in (K.GEO_POLYGON, K.GEO_MULTIPOLYGON):
                raise BinderError("ST_NRINGS expects a POLYGON")
            return E.ArrayFn(
                op="NRINGS", arr_ref=base.dict_ref, rowid=base,
                elem=base.type.elem_type(), type=T.integer(True),
            )
        if name in ("ST_ASTEXT", "ST_ASWKT") and len(node.args) == 1:
            # geo projections already egress as WKT; AsText is identity
            base = self._array_base(node.args[0])
            if not base.type.is_geo:
                raise BinderError(f"{name} expects a geometry")
            return base
        if name == "ST_NPOINTS" and len(node.args) == 1:
            base = self._array_base(node.args[0])
            if base.type.kind in (K.GEO_POLYGON, K.GEO_MULTIPOLYGON):
                # ring-header payloads count points host-side
                return E.ArrayFn(
                    op="NPOINTS", arr_ref=base.dict_ref, rowid=base,
                    elem=base.type.elem_type(), type=T.integer(True),
                )
            card = E.ArrayFn(
                op="CARDINALITY", arr_ref=base.dict_ref, rowid=base,
                elem=base.type.elem_type(), type=T.integer(True),
            )
            return E.BinOp(E.BinOpKind.DIV, card,
                           E.Constant(2, T.integer(False)), T.integer(True))
        if name == "ST_INTERSECTS" and len(node.args) == 2:
            # column vs literal geometry (either argument order); exact
            # host-side test with bbox prefilter (reference
            # BoundingBoxIntersectJoinHashTable residual semantics)
            a_ast, b_ast = node.args

            def lit_wkt(ast):
                if isinstance(ast, A.Literal):
                    return str(ast.value)
                if isinstance(ast, A.FuncCall) and ast.name in (
                    "ST_GEOMFROMTEXT", "ST_GEOGFROMTEXT"
                ):
                    return str(ast.args[0].value)
                return None

            wa, wb = lit_wkt(a_ast), lit_wkt(b_ast)
            if wa is not None and wb is None:
                a_ast, b_ast, wa, wb = b_ast, a_ast, wb, wa
            if wb is None:
                # column-vs-column: polygon×point lowers to containment
                # (ray cast; boundary-touch counts as non-intersecting —
                # measure-zero deviation from OGC semantics)
                pa = self._array_base(a_ast)
                pb_ = self._array_base(b_ast)
                if pb_.type.kind in (K.GEO_POLYGON, K.GEO_MULTIPOLYGON) \
                        and pa.type.kind == K.GEO_POINT:
                    pa, pb_ = pb_, pa
                    a_ast, b_ast = b_ast, a_ast
                if pa.type.kind in (K.GEO_POLYGON, K.GEO_MULTIPOLYGON) \
                        and pb_.type.kind == K.GEO_POINT:
                    px, py = self._geo_xy(b_ast)
                    return E.ArrayFn(
                        op="CONTAINS_SEG", arr_ref=pa.dict_ref,
                        rowid=pa, args=(px, py),
                        elem=pa.type.elem_type(), type=T.boolean(True),
                    )
                raise NotSupported(
                    "ST_INTERSECTS between two columns needs a "
                    "polygon×point pair (or one literal geometry)"
                )
            base = self._array_base(a_ast)
            if not base.type.is_geo:
                raise BinderError("ST_INTERSECTS expects a geo column")
            return E.ArrayFn(
                op="INTERSECTS_LIT", arr_ref=base.dict_ref, rowid=base,
                args=(E.Constant(wb, T.text_dict(False)),),
                elem=base.type.elem_type(), type=T.boolean(True),
            )
        if name == "ST_DISTANCE" and len(node.args) == 2:
            ax, ay = self._geo_xy(node.args[0])
            bx, by = self._geo_xy(node.args[1])
            ti = T.double(True)

            def sub(a, b):
                return E.BinOp(E.BinOpKind.SUB, a, b, ti)

            def mul(a, b):
                return E.BinOp(E.BinOpKind.MUL, a, b, ti)

            dx, dy = sub(ax, bx), sub(ay, by)
            return E.FunctionOp(
                "SQRT",
                (E.BinOp(E.BinOpKind.ADD, mul(dx, dx), mul(dy, dy), ti),),
                ti,
            )
        if name == "ST_DWITHIN" and len(node.args) == 3:
            dist = self._bind_geo_fn(
                A.FuncCall("ST_DISTANCE", [node.args[0], node.args[1]])
            )
            r = self._bind(node.args[2])
            return E.BinOp(E.BinOpKind.LE, dist,
                           E.Cast(r, T.double(r.type.nullable)),
                           T.boolean(True))
        if name in ("ST_AREA", "ST_PERIMETER", "ST_LENGTH") \
                and len(node.args) == 1:
            base = self._array_base(node.args[0])
            if not base.type.is_geo:
                raise BinderError(f"{name} expects a geo column")
            return E.ArrayFn(
                op="AREA" if name == "ST_AREA" else "PERIMETER",
                arr_ref=base.dict_ref, rowid=base,
                elem=base.type.elem_type(), type=T.double(True),
            )  # ST_LENGTH == open-path perimeter (LINESTRING)
        if name == "ST_BUFFER" and len(node.args) == 2:
            # GEOS-runtime role (RelAlgTranslatorGeo.cpp:335): geometry-
            # valued transform applied host-side at aux/egress time; the
            # transform chain rides in dict_ref[2] past the device plan
            base = self._array_base(node.args[0])
            dist = self._bind(node.args[1])
            if not isinstance(dist, E.Constant) or dist.value is None:
                raise NotSupported("ST_BUFFER distance must be a constant")
            d = float(dist.value)
            if dist.type.is_decimal:
                d /= 10 ** dist.type.scale
            k0 = base.type.kind
            if k0 == K.GEO_POINT:
                nk = K.GEO_POLYGON
            elif k0 in (K.GEO_POLYGON, K.GEO_MULTIPOLYGON):
                if d != 0.0:
                    raise NotSupported(
                        "ST_BUFFER on polygons supports radius 0 only "
                        "(no GEOS in this build)")
                nk = k0
            else:
                raise NotSupported("ST_BUFFER on LINESTRING")
            return self._with_geo_step(base, ("BUFFER", d), nk)
        if name in ("ST_UNION", "ST_INTERSECTION", "ST_DIFFERENCE") \
                and len(node.args) == 2:
            op = name[3:]
            a_ast, b_ast = node.args
            if self._geo_literal_wkt(a_ast) is not None \
                    and op != "DIFFERENCE":
                a_ast, b_ast = b_ast, a_ast  # commutative: column first
            base = self._array_base(a_ast)
            if base.type.kind not in (K.GEO_POLYGON, K.GEO_MULTIPOLYGON):
                raise BinderError(f"{name} expects polygon arguments")
            spec = self._geo_operand_spec(b_ast, base)
            return self._with_geo_step(
                base, (op, spec), K.GEO_MULTIPOLYGON)
        if name == "ST_CONTAINS" and len(node.args) == 2:
            poly_ast, pt_ast = node.args
            # literal polygon + point column → test the point column
            if isinstance(poly_ast, A.Literal) or (
                isinstance(poly_ast, A.FuncCall)
                and poly_ast.name in ("ST_GEOMFROMTEXT", "ST_GEOGFROMTEXT")
            ):
                wkt = (
                    poly_ast.value if isinstance(poly_ast, A.Literal)
                    else poly_ast.args[0].value
                )
                base = self._array_base(pt_ast)
                if base.type.kind != K.GEO_POINT:
                    raise BinderError("ST_CONTAINS point argument")
                return E.ArrayFn(
                    op="CONTAINS_LITPOLY", arr_ref=base.dict_ref,
                    rowid=base,
                    args=(E.Constant(str(wkt), T.text_dict(False)),),
                    elem=base.type.elem_type(), type=T.boolean(True),
                )
            base = self._array_base(poly_ast)
            if base.type.kind not in (K.GEO_POLYGON, K.GEO_MULTIPOLYGON):
                raise BinderError("ST_CONTAINS expects a POLYGON first arg")
            if isinstance(pt_ast, A.Literal) or (
                isinstance(pt_ast, A.FuncCall)
                and pt_ast.name in ("ST_GEOMFROMTEXT", "ST_GEOGFROMTEXT")
            ):
                wkt = (
                    pt_ast.value if isinstance(pt_ast, A.Literal)
                    else pt_ast.args[0].value
                )
                arg = E.Constant(str(wkt), T.text_dict(False))
            else:
                arg = self._array_base(pt_ast)
                if arg.type.kind != K.GEO_POINT:
                    raise BinderError("ST_CONTAINS point argument")
                if arg.dict_ref[0] != base.dict_ref[0]:
                    # cross-table polygon∋point: in-kernel segment ray
                    # cast over the pair domain — the executor plans a
                    # grid-bucket candidate join around it (geo_join.py;
                    # reference BoundingBoxIntersectJoinHashTable)
                    px, py = self._geo_xy(pt_ast)
                    return E.ArrayFn(
                        op="CONTAINS_SEG", arr_ref=base.dict_ref,
                        rowid=base, args=(px, py),
                        elem=base.type.elem_type(), type=T.boolean(True),
                    )
            return E.ArrayFn(
                op="CONTAINS", arr_ref=base.dict_ref, rowid=base,
                args=(arg,), elem=base.type.elem_type(),
                type=T.boolean(True),
            )
        return None

    def _with_geo_step(self, base: E.InputRef, step, new_kind):
        """Clone a geo InputRef with one more host-side geometry-transform
        step in dict_ref[2] and the transformed static type."""
        import dataclasses

        ref = base.dict_ref
        steps = (ref[2] if len(ref) > 2 else ()) + (step,)
        srid = int(base.type.comp_param or 0)
        return dataclasses.replace(
            base,
            type=T.geo(new_kind, srid=srid, nullable=True,
                       compressed=False),
            dict_ref=(ref[0], ref[1], steps),
        )

    def _geo_literal_wkt(self, ast) -> Optional[str]:
        if isinstance(ast, A.Literal) and ast.kind == "string":
            return str(ast.value)
        if isinstance(ast, A.FuncCall) and ast.name in (
            "ST_GEOMFROMTEXT", "ST_GEOGFROMTEXT"
        ) and ast.args and isinstance(ast.args[0], A.Literal):
            return str(ast.args[0].value)
        return None

    def _geo_operand_spec(self, ast, base: E.InputRef):
        """Second operand of a polygon boolean op: a WKT literal (any
        table) or an untransformed polygon column of the SAME table
        (row-aligned)."""
        from heavydb_tpu_torch.storage.table import wkt_to_coords

        K = T.SQLTypeKind
        wkt = self._geo_literal_wkt(ast)
        if wkt is not None:
            tag = wkt.strip().split("(", 1)[0].strip().upper()
            kind = {"POLYGON": K.GEO_POLYGON,
                    "MULTIPOLYGON": K.GEO_MULTIPOLYGON}.get(tag)
            if kind is None:
                raise NotSupported(
                    "polygon boolean ops take POLYGON/MULTIPOLYGON "
                    "operands")
            payload = wkt_to_coords(wkt, kind)
            return ("lit", kind.name, tuple(payload.tolist()))
        other = self._array_base(ast)
        if other.type.kind not in (K.GEO_POLYGON, K.GEO_MULTIPOLYGON):
            raise BinderError("polygon boolean ops expect polygons")
        if len(other.dict_ref) > 2:
            raise NotSupported(
                "transformed geometry as the second boolean operand")
        if other.dict_ref[0] != base.dict_ref[0]:
            raise NotSupported(
                "polygon boolean second operand must be a literal or a "
                "column of the same table")
        return ("col", other.dict_ref[0], other.dict_ref[1],
                other.type.kind.name)

    def _bind_FuncCall(self, node: A.FuncCall) -> E.Expr:
        name = node.name
        if name.startswith("ST_"):
            out = self._bind_geo_fn(node)
            if out is not None:
                return out
            raise NotSupported(f"geo function {name}")
        if name in _AGG_NAMES or (name == "COUNT"):
            return self._bind_agg(node)
        if name == "SAMPLE_RATIO" and len(node.args) == 1:
            arg = self._bind(node.args[0])
            if not isinstance(arg, E.Constant) or arg.value is None:
                raise BinderError("SAMPLE_RATIO requires a literal ratio")
            ratio = float(arg.value)
            if arg.type.is_decimal:  # literals carry scaled-int values
                ratio /= 10 ** arg.type.scale
            # hash of the first FROM table's rowid (reference
            # RuntimeFunctions sample_ratio hashes the physical row
            # position) — stable across waves/skipping/join expansion
            pos = None
            for cols in self.scope.by_alias.values():
                fb = cols.get("rowid")
                if fb is not None:
                    pos = E.InputRef(0, fb.field_idx, fb.type, None)
                    break
            if pos is None:
                raise BinderError(
                    "SAMPLE_RATIO requires a physical table in FROM"
                )
            return E.SampleRatio(ratio=ratio, pos=pos,
                                 type=T.boolean(nullable=False))
        if name in ("NOW", "CURRENT_TIMESTAMP") and not node.args:
            import time as _time

            return E.Constant(int(_time.time()), T.timestamp(0, False))
        if name == "CURRENT_DATE" and not node.args:
            import time as _time

            return E.Constant(int(_time.time()) // 86400,
                              T.date(nullable=False))
        if name == "CURRENT_TIME" and not node.args:
            import time as _time

            return E.Constant(int(_time.time()) % 86400,
                              T.time_(nullable=False))
        if name in ("CARDINALITY", "ARRAY_LENGTH") and len(node.args) == 1:
            base = self._array_base(node.args[0])
            return E.ArrayFn(
                op="CARDINALITY", arr_ref=base.dict_ref, rowid=base,
                elem=base.type.elem_type(), type=T.integer(True),
            )
        if name == "UNNEST" and len(node.args) == 1:
            base = self._array_base(node.args[0])
            eti = base.type.elem_type()
            return E.ArrayFn(
                op="UNNEST", arr_ref=base.dict_ref, rowid=base, elem=eti,
                type=eti.with_nullable(True),
                dict_ref=base.dict_ref if eti.is_dict_string else None,
            )
        if name in ("COALESCE", "IFNULL", "NVL"):
            if len(node.args) < 2:
                raise BinderError(f"{name} needs ≥2 args")
            expr = node.args[-1]
            for a in reversed(node.args[:-1]):
                expr = A.CaseWhen([(A.IsNull(a, negated=True), a)], expr)
            return self._bind(expr)
        if name == "NULLIF":
            a, b = node.args
            return self._bind(
                A.CaseWhen([(A.Binary("=", a, b), A.Literal(None, "null"))], a)
            )
        if name == "DATE_PART" and len(node.args) == 2:
            fld = _lit_str(node.args[0]).upper()
            operand = self._bind(node.args[1])
            f = _EXTRACT_MAP.get(fld)
            if f is None:
                raise NotSupported(f"DATE_PART field {fld}")
            return E.Extract(f, operand,
                             T.bigint(operand.type.nullable))
        if name in ("DATE_TRUNC", "DATETRUNC"):
            fld_ast, arg_ast = node.args
            fld = _lit_str(fld_ast).upper()
            operand = self._bind(arg_ast)
            if not operand.type.is_time:
                raise BinderError("DATE_TRUNC on non-time")
            f = _EXTRACT_MAP.get(fld)
            if f is None:
                raise NotSupported(f"DATE_TRUNC field {fld}")
            return E.DateTrunc(f, operand, operand.type)
        if name in ("DATEADD", "TIMESTAMPADD", "DATE_ADD"):
            fld = _lit_str(node.args[0]).upper().rstrip("S")
            amount = self._bind(node.args[1])
            ts = self._bind(node.args[2])
            return E.FunctionOp(
                f"DATEADD_{fld}", (ts, amount), ts.type.with_nullable(
                    ts.type.nullable or amount.type.nullable)
            )
        if name in ("DATEDIFF", "TIMESTAMPDIFF"):
            fld = _lit_str(node.args[0]).upper().rstrip("S")
            a = self._bind(node.args[1])
            b = self._bind(node.args[2])
            return E.FunctionOp(
                f"DATEDIFF_{fld}", (a, b),
                T.bigint(a.type.nullable or b.type.nullable),
            )
        if name in ("LENGTH", "CHAR_LENGTH") and len(node.args) == 1:
            arg = self._bind(node.args[0])
            if arg.type.is_dict_string:
                return E.DictStrPredicate(
                    arg=arg, kind="LENGTH",
                    dict_ref=getattr(arg, "dict_ref", None),
                    type=T.integer(arg.type.nullable),
                )
            raise NotSupported("LENGTH on non-dict strings")
        if name in _MATH_FNS:
            args = tuple(self._bind(a) for a in node.args)
            out = self._math_result_type(name, args)
            return E.FunctionOp(name, args, out)
        if name in ("GREATEST", "LEAST") and node.args:
            args = [self._bind(a) for a in node.args]
            if any(a.type.is_dict_string for a in args):
                # string GREATEST/LEAST (reference SqlStringOpKind
                # GREATEST/LEAST): per-dictionary-entry max/min vs the
                # literal operands
                col = next(a for a in args if a.type.is_dict_string)
                lits = [a for a in args if a is not col]
                if any(a.type.is_dict_string for a in lits) or not all(
                    isinstance(a, E.Constant) and a.type.is_string
                    for a in lits
                ):
                    raise NotSupported(
                        f"{name} over multiple string columns")
                return self._extend_transform(
                    col, (name, tuple(str(a.value) for a in lits))
                )
            c = args[0]
            for a in args[1:]:
                c, _ = self._coerce_pair(c, a)
            ft = c.type.with_nullable(any(a.type.nullable for a in args))
            cast_args = tuple(self._cast_to(a, ft) for a in args)
            return E.FunctionOp(name, cast_args, ft)
        if name == "SPACE" and len(node.args) == 1:
            c = self._bind(node.args[0])
            if not isinstance(c, E.Constant):
                raise NotSupported("SPACE requires a constant argument")
            return E.Constant(
                " " * int(c.value), T.TypeInfo(T.SQLTypeKind.TEXT, False)
            )
        if name in ("STARTSWITH", "STARTS_WITH", "ENDSWITH", "ENDS_WITH",
                    "CONTAINS") and len(node.args) == 2:
            # desugar to anchored LIKE over the dictionary (reference
            # SqlStringOpKind STARTSWITH/ENDSWITH/CONTAINS)
            arg = self._bind(node.args[0])
            lit = self._bind(node.args[1])
            if not isinstance(lit, E.Constant):
                raise NotSupported(f"{name} requires a constant pattern")
            if not arg.type.is_dict_string:
                raise NotSupported(f"{name} on non-dictionary strings")
            pat = (str(lit.value).replace("\\", "\\\\")
                   .replace("%", "\\%").replace("_", "\\_"))
            if name.startswith("STARTS"):
                pat = pat + "%"
            elif name.startswith("ENDS"):
                pat = "%" + pat
            else:
                pat = "%" + pat + "%"
            return E.DictStrPredicate(
                arg=arg, kind="LIKE", pattern=pat, escape="\\",
                dict_ref=getattr(arg, "dict_ref", None),
                type=T.boolean(arg.type.nullable),
            )
        if name == "CONCAT" and len(node.args) >= 2:
            # n-ary CONCAT folds to nested || (columns and literals alike)
            expr_ast = node.args[0]
            for a in node.args[1:]:
                expr_ast = A.Binary("||", expr_ast, a)
            return self._bind(expr_ast)
        if name in _STRING_FNS:
            return self._bind_string_fn(name, node.args)
        if name in _INT_STRING_FNS:
            arg = self._bind(node.args[0])
            if not arg.type.is_dict_string:
                raise NotSupported(f"{name} on non-dictionary strings")
            import json as _json

            extra = []
            for a in node.args[1:]:
                c = self._bind(a)
                if not isinstance(c, E.Constant):
                    raise NotSupported(f"{name} requires constant arguments")
                extra.append(c.value)
            fn = _INT_STRING_FNS[name]
            # HASH/JAROWINKLER return BIGINT (reference kBIGINT) and can
            # yield NULL (empty-string inputs)
            out_t = (
                T.bigint(True) if fn in ("HASH", "JAROWINKLER")
                else T.integer(arg.type.nullable)
            )
            return E.DictStrPredicate(
                arg=arg, kind="INTFN", cmp_op=fn,
                pattern=_json.dumps(extra),
                dict_ref=getattr(arg, "dict_ref", None),
                type=out_t,
            )
        udf = getattr(self.db, "_udfs", {}).get(name)
        if udf is not None:
            fn, arg_types, ret_type = udf
            if len(node.args) != len(arg_types):
                raise BinderError(
                    f"UDF {name} expects {len(arg_types)} args"
                )
            args = []
            nullable = False
            for a_ast, ti in zip(node.args, arg_types):
                a = self._bind(a_ast)
                nullable = nullable or a.type.nullable
                args.append(self._cast_to(a, ti))
            return E.FunctionOp(
                f"UDF:{name}", tuple(args), ret_type.with_nullable(nullable)
            )
        raise NotSupported(f"function {name}")

    def _bind_pair_concat(self, l: E.Expr, r: E.Expr) -> E.Expr:
        """col || col between two dict-encoded sides → pairwise dense
        translation table (built at launch over the two dictionaries)."""

        def side(e):
            if isinstance(e, E.StringTransform):
                return e.arg, e.ops, e.src_dict_ref
            return e, (), getattr(e, "dict_ref", None)

        la, lops, lref = side(l)
        ra, rops, rref = side(r)
        if lref is None or rref is None:
            raise NotSupported("|| between computed string expressions")
        ref, _ = self.db.register_transient_dict(
            _transient_key("pair", (lref, rref), (lops, rops)))
        return E.StringPairConcat(
            left=la, right=ra, left_ops=lops, right_ops=rops,
            left_ref=lref, right_ref=rref, dict_ref=ref,
            type=T.text_dict(nullable=l.type.nullable or r.type.nullable),
        )

    def _bind_string_fn(self, name: str, arg_asts) -> E.Expr:
        """String kernels over dict columns → launch-time translation chains
        (reference StringOps/, ~45 kernels; dict-to-dict translation maps)."""
        arg = self._bind(arg_asts[0])
        if not arg.type.is_dict_string:
            raise NotSupported(f"{name} on non-dictionary strings")
        extra = []
        for a in arg_asts[1:]:
            c = self._bind(a)
            if not isinstance(c, E.Constant):
                raise NotSupported(f"{name} requires constant arguments")
            v = c.value
            if c.type.is_decimal:
                v = v / 10**c.type.scale
            extra.append(v)
        return self._extend_transform(arg, (name, tuple(extra)))

    def _extend_transform(self, arg: E.Expr, op: tuple) -> E.Expr:
        if isinstance(arg, E.StringTransform):
            ops = arg.ops + (op,)
            ref, _ = self.db.register_transient_dict(
                _transient_key("transform", (arg.src_dict_ref,), (ops,)))
            return E.StringTransform(
                arg=arg.arg, ops=ops,
                src_dict_ref=arg.src_dict_ref, dict_ref=ref,
                type=T.text_dict(nullable=arg.type.nullable),
            )
        src_ref = getattr(arg, "dict_ref", None)
        if src_ref is None:
            raise NotSupported("string function on computed string expression")
        ref, _ = self.db.register_transient_dict(
            _transient_key("transform", (src_ref,), ((op,),)))
        return E.StringTransform(
            arg=arg, ops=(op,), src_dict_ref=src_ref, dict_ref=ref,
            type=T.text_dict(nullable=arg.type.nullable),
        )

    def _math_result_type(self, name, args):
        nullable = any(a.type.nullable for a in args)
        if name in ("CEIL", "CEILING", "FLOOR", "ROUND", "TRUNCATE", "SIGN",
                    "ABS", "MOD"):
            t = args[0].type
            if t.is_null_type:
                return T.double(True)
            return t.with_nullable(nullable)
        if name == "WIDTH_BUCKET":
            return T.integer(nullable)
        return T.double(nullable)

    def _bind_agg(self, node: A.FuncCall) -> E.Expr:
        if not self.allow_aggs:
            raise BinderError(f"aggregate {node.name} not allowed here")
        kind = _AGG_NAMES[node.name]
        if node.star:
            if kind != E.AggKind.COUNT:
                raise BinderError(f"{node.name}(*) is invalid")
            agg = E.Agg(E.AggKind.COUNT, None, False, T.bigint(nullable=False))
            self.aggs.append(agg)
            return agg
        arg = self._bind(node.args[0]) if node.args else None
        arg2 = None
        if kind == E.AggKind.APPROX_QUANTILE:
            q = 0.5
            if len(node.args) > 1:
                c = self._bind(node.args[1])
                q = float(c.value) / (10 ** c.type.scale if c.type.is_decimal else 1)
            arg2 = E.Constant(q, T.double(False))
        if kind in (E.AggKind.SUM_IF,):
            arg2 = self.bind_condition(node.args[1])
        if kind == E.AggKind.COUNT_IF:
            arg2 = self.bind_condition(node.args[0])
            arg = None
        out_type = _agg_result_type(kind, arg, node.distinct)
        if node.distinct:
            if kind == E.AggKind.COUNT:
                kind = E.AggKind.COUNT_DISTINCT
            elif kind not in (E.AggKind.MIN, E.AggKind.MAX,
                              E.AggKind.SUM, E.AggKind.AVG):
                raise NotSupported(f"DISTINCT {node.name}")
        agg = E.Agg(kind, arg, node.distinct, out_type, arg2)
        self.aggs.append(agg)
        return agg

    def _bind_Star(self, node: A.Star):
        raise BinderError("* only allowed at top level of SELECT")

    _WINDOW_KINDS = {
        "ROW_NUMBER": E.WindowKind.ROW_NUMBER,
        "RANK": E.WindowKind.RANK,
        "DENSE_RANK": E.WindowKind.DENSE_RANK,
        "PERCENT_RANK": E.WindowKind.PERCENT_RANK,
        "CUME_DIST": E.WindowKind.CUME_DIST,
        "NTILE": E.WindowKind.NTILE,
        "LAG": E.WindowKind.LAG,
        "LEAD": E.WindowKind.LEAD,
        "FIRST_VALUE": E.WindowKind.FIRST_VALUE,
        "LAST_VALUE": E.WindowKind.LAST_VALUE,
        "NTH_VALUE": E.WindowKind.NTH_VALUE,
        "COUNT": E.WindowKind.COUNT,
        "SUM": E.WindowKind.SUM,
        "AVG": E.WindowKind.AVG,
        "MIN": E.WindowKind.MIN,
        "MAX": E.WindowKind.MAX,
    }

    def _bind_WindowFuncCall(self, node: A.WindowFuncCall) -> E.Expr:
        fc = node.func
        kind = self._WINDOW_KINDS.get(fc.name)
        if kind is None:
            raise NotSupported(f"window function {fc.name}")
        frame = None
        if node.spec.frame is not None:
            unit, b1, b2 = node.spec.frame
            if b1[0] == "UF" or b2[0] == "UP":
                raise BinderError("invalid window frame bounds")
            if unit == "RANGE" and (len(b1) > 1 or len(b2) > 1):
                raise NotSupported(
                    "RANGE frames with numeric offsets (use ROWS)"
                )
            frame = (unit, b1, b2)
        args = tuple(self._bind(a) for a in fc.args) if not fc.star else ()
        partition = tuple(self._bind(p) for p in node.spec.partition_by)
        order = tuple(
            (
                self._bind(oi.expr),
                oi.asc,
                oi.nulls_first if oi.nulls_first is not None else not oi.asc,
            )
            for oi in node.spec.order_by
        )
        K = E.WindowKind
        nullable_arg = args[0].type.nullable if args else True
        if kind in (K.ROW_NUMBER, K.RANK, K.DENSE_RANK, K.NTILE, K.COUNT):
            ti = T.bigint(nullable=False)
        elif kind in (K.PERCENT_RANK, K.CUME_DIST):
            ti = T.double(nullable=False)
        elif kind in (K.LAG, K.LEAD, K.FIRST_VALUE, K.LAST_VALUE, K.NTH_VALUE):
            if not args:
                raise BinderError(f"{fc.name} requires an argument")
            ti = args[0].type.with_nullable(True)
        elif kind in (K.SUM, K.AVG):
            if not args or not args[0].type.is_number:
                raise BinderError(f"{fc.name} window requires numeric arg")
            ti = (T.double(True) if kind == K.AVG or args[0].type.is_fp
                  else T.bigint(True))
            if args[0].type.is_decimal and kind == K.SUM:
                ti = T.decimal(19, args[0].type.scale, True)
            if args[0].type.is_fp:
                ti = T.double(True)
        else:  # MIN/MAX
            if not args:
                raise BinderError(f"{fc.name} window requires an argument")
            ti = args[0].type.with_nullable(True)
        if kind in (K.ROW_NUMBER, K.RANK, K.DENSE_RANK, K.PERCENT_RANK,
                    K.CUME_DIST, K.NTILE) and not order:
            # HeavyDB requires ORDER BY for ranking functions
            raise BinderError(f"{fc.name} requires a window ORDER BY")
        dref = getattr(args[0], "dict_ref", None) if args else None
        if kind in (K.SUM, K.AVG, K.MIN, K.MAX, K.COUNT,
                    K.FIRST_VALUE, K.LAST_VALUE, K.NTH_VALUE):
            # framed aggregates/navigation can see an empty frame → NULL
            if frame is not None:
                ti = ti.with_nullable(True)
        else:
            frame = None  # ranking functions ignore the frame clause
        ignore_nulls = bool(getattr(node, "ignore_nulls", False))
        if ignore_nulls and kind not in (
            K.LAG, K.LEAD, K.FIRST_VALUE, K.LAST_VALUE, K.NTH_VALUE
        ):
            raise BinderError("IGNORE NULLS applies to navigation functions")
        return E.WindowFunc(
            kind=kind, args=args, partition_by=partition, order_by=order,
            type=ti, dict_ref=dref, frame=frame, ignore_nulls=ignore_nulls,
        )


def _agg_result_type(kind: E.AggKind, arg, distinct: bool) -> T.TypeInfo:
    if kind in (E.AggKind.COUNT, E.AggKind.COUNT_IF, E.AggKind.COUNT_DISTINCT,
                E.AggKind.APPROX_COUNT_DISTINCT):
        return T.bigint(nullable=False)
    t = arg.type
    if kind in (E.AggKind.MIN, E.AggKind.MAX, E.AggKind.SAMPLE,
                E.AggKind.SINGLE_VALUE, E.AggKind.MODE):
        return t.with_nullable(True)
    if kind in (E.AggKind.AVG, E.AggKind.APPROX_QUANTILE, E.AggKind.STDDEV,
                E.AggKind.VARIANCE):
        return T.double(nullable=True)
    if kind in (E.AggKind.SUM, E.AggKind.SUM_IF):
        if not t.is_number and not t.is_null_type:
            raise BinderError(f"SUM of {t}")
        if t.is_fp:
            # SUM(FLOAT)→FLOAT like the reference (get_agg_type); also keeps
            # accumulation in f32 — f64 is emulated (slow) on TPU
            return t.with_nullable(True)
        if t.is_decimal:
            return T.decimal(19, t.scale, True)
        return T.bigint(nullable=True)
    raise BinderError(f"bad aggregate {kind}")


def _lit_str(node) -> str:
    if isinstance(node, A.Literal) and node.kind == "string":
        return node.value
    if isinstance(node, A.Identifier) and len(node.parts) == 1:
        return node.parts[0]
    raise BinderError("expected a string literal")


def _host_str_cmp(op, a, b):
    import operator

    return {
        "=": operator.eq, "<>": operator.ne, "<": operator.lt,
        "<=": operator.le, ">": operator.gt, ">=": operator.ge,
    }[op](a, b)


def _transient_key(kind: str, refs: tuple, chains: tuple):
    """The key of a transform's or pair concatenation's transient output
    dictionary: its source dictionaries and their op chains, whose strings
    are the same in every query.  None (a new dictionary each time) for a
    chain with LLM_TRANSFORM, whose registered backend may change between
    queries."""
    if any(name == "LLM_TRANSFORM" for ops in chains for name, _ in ops):
        return None
    return (kind, refs, chains)


def _const_cast(value, src: T.TypeInfo, dst: T.TypeInfo):
    """Host-side constant conversion to dst's physical representation."""
    if value is None:
        return None
    if src.is_string and not src.is_dict_string:
        s = str(value)
        if dst.kind == T.SQLTypeKind.DATE:
            s = s.strip()
            try:
                d = _dt.date.fromisoformat(s)
            except ValueError:
                # datetime string → truncate (reference dateTimeParse<kDATE>)
                d = _dt.datetime.fromisoformat(s).date()
            return (d - EPOCH).days
        if dst.kind == T.SQLTypeKind.TIMESTAMP:
            d = _dt.datetime.fromisoformat(s.strip())
            if d.tzinfo is None:
                d = d.replace(tzinfo=_dt.timezone.utc)
            return int(round(d.timestamp() * 10**dst.precision))
        if dst.kind == T.SQLTypeKind.TIME:
            t = _dt.time.fromisoformat(s.strip())
            return t.hour * 3600 + t.minute * 60 + t.second
        if dst.is_integer:
            return int(s)
        if dst.is_fp:
            return float(s)
        if dst.is_decimal:
            from decimal import Decimal

            return int(Decimal(s).scaleb(dst.scale).to_integral_value())
        if dst.is_boolean:
            return 1 if s.strip().lower() in ("t", "true", "1") else 0
        raise BinderError(f"cannot cast string to {dst}")
    # numeric conversions
    if src.is_decimal:
        real = value / 10**src.scale
    else:
        real = value
    if dst.is_decimal:
        from decimal import Decimal

        return int(Decimal(str(real)).scaleb(dst.scale).to_integral_value(
            rounding="ROUND_HALF_UP"))
    if dst.is_integer or dst.is_time:
        if src.kind == T.SQLTypeKind.DATE and dst.kind == T.SQLTypeKind.TIMESTAMP:
            return int(value) * 86400 * 10**dst.precision
        if src.kind == T.SQLTypeKind.TIMESTAMP and dst.kind == T.SQLTypeKind.DATE:
            return int(value // (86400 * 10**src.precision))
        return int(real)
    if dst.is_fp:
        return float(real)
    if dst.is_boolean:
        return 1 if real else 0
    return value
