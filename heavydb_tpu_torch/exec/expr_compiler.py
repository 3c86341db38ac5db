"""Expression compiler: typed expression tree -> torch ops.

Port of heavydb_tpu/exec/expr_compiler.py (the analogue of the reference's
CodeGenerator family: ArithmeticIR.cpp, CompareIR.cpp, LogicalIR.cpp,
CastIR.cpp, CaseIR.cpp, DateTimeIR.cpp).  Torch runs eagerly, so each
expression runs as it compiles.

Value representation: TV = (val, valid) where
  - val: a tensor over the row domain, or a 0-dim tensor
  - valid: a bool tensor, or None meaning "all valid"
Null storage is in-band sentinels; three-valued AND/OR matches SQL.

Dispatch is on `_c_<ExprType>`; a type without a method raises
NotSupported.  A scalar UDF (`FunctionOp` named `UDF:<name>`) calls the
torch function registered under its name on its arguments' values.

An array or geo column's device value is its row's int32 global rowid;
ArrayFn gathers the tables the executor builds over the column's host
payload (exec/executor.py `_array_aux`) through it, and CONTAINS_SEG runs
the even-odd ray cast of a point against a polygon's segments over the
domain (`ray_cast`).

Dictionary strings are int32 ids on the device.  Their predicates,
transforms, pairwise concatenations and pairwise comparisons read tables
the executor builds on the host over the dictionary entries (the `aux`
mapping, exec/executor.py `_aux_array`); here each is a clamped index into
its table.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.errors import NotSupported
from heavydb_tpu_torch.ops.groupby import torch_dtype
from heavydb_tpu_torch.plan import exprs as E
from heavydb_tpu_torch.utils.timer import NULL_TIMER

TV = Tuple[object, Optional[object]]  # (val, valid)

# a dictionary id that is NULL: a transform's NULL result, a missing pair
_I32_MIN = int(np.iinfo(np.int32).min)

# domain rows a pass of the ray cast takes: bounds its temporaries (each
# iteration holds ~8 domain-sized ones) on a join's pair domain
RAY_CAST_CHUNK = 1 << 24


def and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _broadcast1(x, n: int):
    return x.expand(n) if x.dim() == 0 else x


def ray_cast(off, cnt, px, py, segs, maxseg: int):
    """int32 crossings of the ray from each point (px, py), float64, to
    +x with the cnt[i] segments of its polygon that start at off[i] of
    the flat segment tables segs = (x1, y1, x2, y2): the reference's
    CONTAINS_SEG loop, `maxseg` passes of its crossing test term for term
    (one elementwise op each, so nothing fuses into a multiply-add), run
    over the domain in chunks of RAY_CAST_CHUNK rows, in the
    `contains_seg_ray_cast` scope."""
    n = px.shape[0]
    crossings = torch.zeros(n, dtype=torch.int32, device=px.device)
    if n == 0 or maxseg == 0:
        return crossings
    sx1, sy1, sx2, sy2 = segs
    last = sx1.shape[0] - 1
    with NULL_TIMER.scope("contains_seg_ray_cast"):
        for a in range(0, n, RAY_CAST_CHUNK):
            b = min(a + RAY_CAST_CHUNK, n)
            o, c, x, y = off[a:b].to(torch.int64), cnt[a:b], px[a:b], py[a:b]
            acc = crossings[a:b]
            for s in range(maxseg):
                # four 1-D gathers: one row gather of a [segments, 4]
                # table is many times slower on an H100 (chip_smoke.py
                # ray_cast_gathers, PERF.md §6)
                j = (o + s).clamp_(0, last)
                x1, y1, x2, y2 = sx1[j], sy1[j], sx2[j], sy2[j]
                den = torch.where(y2 == y1, 1e-300, y2 - y1)
                cr = ((y1 > y) != (y2 > y)) & (x < (x2 - x1) * (y - y1) / den + x1)
                acc += (cr & (c > s)).to(torch.int32)
    return crossings


def fdiv(a, b):
    """Floor division (jnp.floor_divide) of tensors or tensor and int."""
    return torch.div(a, b, rounding_mode="floor")


def _as(x, dt, device=None) -> torch.Tensor:
    """jnp.asarray(x, dt): a tensor of dtype dt (numpy or torch dtype)."""
    tdt = torch_dtype(dt)
    if torch.is_tensor(x):
        return x if x.dtype == tdt else x.to(tdt)
    return torch.tensor(x, dtype=tdt, device=device)


def _promote(a, b):
    """Both operands in their common dtype (JAX/numpy promotion, where a
    0-dim tensor counts like any other, unlike torch's scalar rule)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


class ExprCompiler:
    """Compiles expressions against a row-domain context.

    cols: field_idx -> (val, valid) — pre-derived column TVs over a domain
    of `domain_size` rows on `device`
    aux:  aux key -> device table (or a pair of tables) of the dictionary
    string expressions
    udfs: name -> (fn, arg_types, ret_type) of the scalar UDFs; fn takes
    and returns torch tensors
    """

    def __init__(self, cols: Dict[int, TV], aux=None, error_flags=None,
                 device="cpu", domain_size: int = 0, udfs=None):
        self.cols = cols
        # scalar UDFs: name -> (fn, arg_types, ret_type) (Database.register_udf)
        self.udfs = udfs if udfs is not None else {}
        self.aux = aux if aux is not None else {}
        # error flags: name -> bool tensor (div-by-zero etc.)
        self.error_flags = error_flags if error_flags is not None else {}
        self.device = torch.device(device)
        self.domain_size = domain_size

    def _t(self, x, dt) -> torch.Tensor:
        return _as(x, dt, self.device)

    # ---- public ----
    def compile(self, e: E.Expr) -> TV:
        m = getattr(self, "_c_" + type(e).__name__, None)
        if m is None:
            raise NotSupported(f"cannot compile {type(e).__name__}")
        return m(e)

    def compile_predicate(self, e: E.Expr):
        """Boolean expr -> single bool mask (null -> False), for filters."""
        val, valid = self.compile(e)
        val = self._t(val, torch.bool)
        if valid is None:
            return val
        return val & valid

    def _c_SampleRatio(self, e: E.SampleRatio):
        # hash of the row's global physical position (the scan's virtual
        # rowid field) -> uniform [0,1) < ratio.  The reference's uint32
        # arithmetic runs in int64 masked to 32 bits.
        pos, _ = self.compile(e.pos)
        m32 = 0xFFFFFFFF
        h = self._t(pos, torch.int64) & m32
        h = ((h ^ (h >> 16)) * 0x45D9F3B) & m32
        h = ((h ^ (h >> 16)) * 0x45D9F3B) & m32
        h = h ^ (h >> 16)
        u = h.to(torch.float64) / float(2**32)
        return u < e.ratio, None

    # ---- leaves ----
    def _c_InputRef(self, e: E.InputRef) -> TV:
        return self.cols[e.field_idx]

    def _c_Constant(self, e: E.Constant) -> TV:
        if e.value is None:
            # typed null: sentinel value, valid=False scalar
            dt = e.type.np_dtype() if not e.type.is_null_type else np.dtype(np.int32)
            return self._t(0, dt), self._t(False, torch.bool)
        if isinstance(e.value, str):
            raise NotSupported("string constants outside dictionary predicates")
        return self._t(e.value, e.type.np_dtype()), None

    def _c_ArrayFn(self, e: E.ArrayFn) -> TV:
        """Array and geo ops over the rowid handle: the aux tables of
        `_array_aux` gathered at the row (the reference's ArrayIR.cpp)."""
        if e.op == "UNNEST":
            raise NotSupported("UNNEST is only allowed in the SELECT list")
        rid, ridv = self.compile(e.rowid)
        aux = self.aux[e.key()]
        rid = self._t(rid, torch.int64)
        ridc = rid.clamp(0, aux[0].shape[0] - 1)
        okrid = and_valid(rid >= 0, ridv)
        if e.op == "CARDINALITY":
            ln = aux[0][ridc]
            return ln, okrid & (ln >= 0)
        if e.op == "CONTAINS_SEG":
            # the even-odd ray cast against a polygon column's segments,
            # over any domain: the exact test of a cross-table geo join
            seg_off, seg_cnt, sx1, sy1, sx2, sy2, maxseg = aux
            ridp = rid.clamp(0, seg_cnt.shape[0] - 1)
            px, pxv = self.compile(e.args[0])
            py, pyv = self.compile(e.args[1])
            n = max(t.numel() for t in (ridp, px, py))
            cnt = _broadcast1(seg_cnt[ridp], n)
            crossings = ray_cast(_broadcast1(seg_off[ridp], n), cnt,
                                 _broadcast1(self._t(px, torch.float64), n),
                                 _broadcast1(self._t(py, torch.float64), n),
                                 (sx1, sy1, sx2, sy2), maxseg)
            ok = and_valid(and_valid(okrid & (cnt >= 0), pxv), pyv)
            return (crossings % 2) == 1, ok
        if e.op in ("ANY", "ALL", "CONTAINS", "CONTAINS_LITPOLY", "INTERSECTS_LIT",
                    "ARR_EQ"):
            r = aux[0][ridc]
            return r == 1, okrid & (r != -1)
        if e.op in ("AREA", "PERIMETER", "XMIN", "XMAX", "YMIN", "YMAX",
                    "CENTROID_X", "CENTROID_Y"):
            v = aux[0][ridc]
            return v, okrid & ~torch.isnan(v)
        if e.op in ("NPOINTS", "NRINGS"):
            v = aux[0][ridc]
            return v, okrid & (v >= 0)
        # SUBSCRIPT: 1-based; out of range or a NULL element gives NULL
        lengths, offsets, flat = aux
        k, kvalid = self.compile(e.args[0])
        k = self._t(k, torch.int64)
        ln = lengths[ridc]
        pos = (offsets[ridc] + k - 1).clamp(0, flat.shape[0] - 1)
        v = flat[pos]
        ok = and_valid(okrid & (k >= 1) & (k <= ln.clamp(min=0)), kvalid)
        if e.elem.nullable:
            if v.is_floating_point():
                ok = ok & ~torch.isnan(v)
            else:
                ok = ok & (v != e.elem.null_sentinel())
        return v, ok

    # ---- operators ----
    def _c_BinOp(self, e: E.BinOp) -> TV:
        if e.op in E.LOGIC_OPS:
            return self._logic(e)
        lv, lvalid = self.compile(e.left)
        rv, rvalid = self.compile(e.right)
        valid = and_valid(lvalid, rvalid)
        op = e.op
        if op in E.COMPARISON_OPS:
            a, b = _promote(lv, rv)
            fn = {
                E.BinOpKind.EQ: torch.eq, E.BinOpKind.NE: torch.ne,
                E.BinOpKind.LT: torch.lt, E.BinOpKind.LE: torch.le,
                E.BinOpKind.GT: torch.gt, E.BinOpKind.GE: torch.ge,
            }[op]
            return fn(a, b), valid
        out_dt = e.type.np_dtype()
        lvc = self._t(lv, out_dt)
        rvc = self._t(rv, out_dt)
        if op == E.BinOpKind.ADD:
            return lvc + rvc, valid
        if op == E.BinOpKind.SUB:
            return lvc - rvc, valid
        if op == E.BinOpKind.MUL:
            return lvc * rvc, valid
        if op in (E.BinOpKind.DIV, E.BinOpKind.MOD):
            zero = rvc == 0
            self._flag_error("div_by_zero", zero, valid)
            safe = torch.where(zero, self._t(1, out_dt), rvc)
            if op == E.BinOpKind.MOD:
                # SQL MOD: sign follows dividend (C fmod)
                r = torch.remainder(lvc.abs(), safe.abs())
                if out_dt.kind != "f":
                    return torch.where(lvc < 0, -r, r), valid
                return torch.sign(lvc) * r, valid
            if e.type.is_decimal:
                # decimal/decimal with same scale handled at binder (->double)
                return fdiv(lvc, safe), valid
            if e.type.is_integer:
                # SQL integer division truncates toward zero
                q = torch.sign(lvc) * torch.sign(safe) * fdiv(lvc.abs(), safe.abs())
                return q.to(lvc.dtype), valid
            return lvc / safe, valid
        raise NotSupported(f"binop {op}")

    def _flag_error(self, name: str, cond_vec, valid):
        # store the per-row VECTOR (the kernel any()s it at the end): CASE
        # branches can then mask out rows their condition doesn't select
        active = cond_vec if valid is None else (cond_vec & valid)
        if name in self.error_flags:
            self.error_flags[name] = self.error_flags[name] | active
        else:
            self.error_flags[name] = active

    def _compile_guarded(self, e, mask):
        """Compile a CASE branch; error flags it raises only count where
        `mask` (the branch's effective condition) holds."""
        outer = self.error_flags
        self.error_flags = {}
        try:
            val, valid = self.compile(e)
            for name, vec in self.error_flags.items():
                masked = vec & mask
                if name in outer:
                    outer[name] = outer[name] | masked
                else:
                    outer[name] = masked
        finally:
            self.error_flags = outer
        return val, valid

    def _logic(self, e: E.BinOp) -> TV:
        lv, lvalid = self.compile(e.left)
        rv, rvalid = self.compile(e.right)
        lv = self._t(lv, torch.bool)
        rv = self._t(rv, torch.bool)
        if lvalid is None and rvalid is None:
            return (lv & rv if e.op == E.BinOpKind.AND else lv | rv), None
        true = self._t(True, torch.bool)
        lval = lvalid if lvalid is not None else true
        rval = rvalid if rvalid is not None else true
        if e.op == E.BinOpKind.AND:
            # null AND false = false; null AND true = null
            valid = (lval & rval) | (lval & ~lv) | (rval & ~rv)
            return lv & rv & lval & rval, valid
        valid = (lval & rval) | (lval & lv) | (rval & rv)
        # value when one side null: true if the valid side is true
        return (lv & lval) | (rv & rval), valid

    def _c_UnOp(self, e: E.UnOp) -> TV:
        val, valid = self.compile(e.operand)
        if e.op == E.UnOpKind.NOT:
            return ~self._t(val, torch.bool), valid
        if e.op == E.UnOpKind.NEG:
            return -self._t(val, e.type.np_dtype()), valid
        if e.op in (E.UnOpKind.ISNULL, E.UnOpKind.ISNOTNULL):
            is_null = e.op == E.UnOpKind.ISNULL
            if valid is None:
                v = torch.as_tensor(val)
                fill = torch.zeros_like if is_null else torch.ones_like
                return fill(v, dtype=torch.bool), None
            return (~valid if is_null else valid), None
        raise NotSupported(f"unop {e.op}")

    def _c_Cast(self, e: E.Cast) -> TV:
        val, valid = self.compile(e.operand)
        return cast_value(val, e.operand.type, e.type), valid

    def _c_Case(self, e: E.Case) -> TV:
        out_dt = e.type.np_dtype()
        # effective per-branch conditions (first matching WHEN wins)
        conds = [self.compile_predicate(ce) for ce, _ in e.whens]
        taken = None
        effs = []
        for c in conds:
            effs.append(c if taken is None else (c & ~taken))
            taken = c if taken is None else (taken | c)
        if e.else_ is not None:
            val, valid = self._compile_guarded(e.else_, ~taken)
            val = self._t(val, out_dt)
        else:
            null = e.type.null_sentinel() if out_dt.kind != "f" else np.nan
            val, valid = self._t(null, out_dt), self._t(False, torch.bool)
        true = self._t(True, torch.bool)
        for (_, res_e), c in zip(reversed(e.whens), reversed(effs)):
            rv, rvalid = self._compile_guarded(res_e, c)
            val = torch.where(c, self._t(rv, out_dt), val)
            if rvalid is None and valid is None:
                valid = None
            else:
                valid = torch.where(c, rvalid if rvalid is not None else true,
                                    valid if valid is not None else true)
        return val, valid

    def _c_InValues(self, e: E.InValues) -> TV:
        val, valid = self.compile(e.arg)
        vals = [v for v in e.values if v is not None]
        if not vals:
            res = torch.zeros_like(val, dtype=torch.bool)
        elif len(vals) <= 16:
            res = None
            for v in vals:
                c = val == self._t(v, val.dtype)
                res = c if res is None else (res | c)
        else:
            # membership in the sorted value table (reference InValuesBitmap)
            table = self._t(np.sort(np.asarray(vals)), val.dtype)
            res = torch.isin(val, table)
        if e.negated:
            res = ~res
        return res, valid

    # ---- dictionary strings: gathers from host-built tables (each holds
    # at least one entry, exec/batch.bucket) ----
    def _c_DictStrPredicate(self, e: E.DictStrPredicate) -> TV:
        ids, valid = self.compile(e.arg)
        aux = self.aux[e.key()]
        n = aux.shape[0]
        out = aux[ids.clamp(0, n - 1).to(torch.int64)]
        if e.kind == "LENGTH":
            return out, valid
        if e.kind == "INTFN":
            # a NULL result (HASH('') ...) is stored as the null sentinel
            return out, and_valid(valid, out != e.type.null_sentinel())
        if e.kind == "TRYCAST":
            if out.is_floating_point():
                ok = ~torch.isnan(out)
            else:
                ok = out != e.type.null_sentinel()
            return out, and_valid(valid, ok & (ids >= 0))
        # a bool match table a dictionary id; a NULL (negative) id is False
        res = out & (ids >= 0) & (ids < n)
        if e.negated:
            res = ~res
        return res, valid

    def _c_StringTransform(self, e: E.StringTransform) -> TV:
        ids, valid = self.compile(e.arg)
        tbl = self.aux[e.key()]  # id -> transformed dictionary id
        n = tbl.shape[0]
        safe = ids.clamp(0, n - 1).to(torch.int64)
        out = torch.where((ids >= 0) & (ids < n), tbl[safe], _I32_MIN)
        # an op may give NULL (SPLIT_PART out of range): the table's sentinel
        return out, and_valid(valid, out != _I32_MIN)

    def _c_StringPairConcat(self, e: E.StringPairConcat) -> TV:
        idl, vl = self.compile(e.left)
        idr, vr = self.compile(e.right)
        tbl = self.aux[e.key()]  # (L, R) pair table -> output dictionary ids
        nl, nr = tbl.shape
        sl = idl.clamp(0, nl - 1).to(torch.int64)
        sr = idr.clamp(0, nr - 1).to(torch.int64)
        ok = (idl >= 0) & (idl < nl) & (idr >= 0) & (idr < nr)
        out = torch.where(ok, tbl[sl, sr], _I32_MIN)
        return out, and_valid(and_valid(vl, vr), out != _I32_MIN)

    def _c_DictPairCompare(self, e: E.DictPairCompare) -> TV:
        idl, vl = self.compile(e.left)
        idr, vr = self.compile(e.right)
        rl_tbl, rr_tbl = self.aux[e.key()]  # id -> rank in the merged order
        rl = rl_tbl[idl.clamp(0, rl_tbl.shape[0] - 1).to(torch.int64)]
        rr = rr_tbl[idr.clamp(0, rr_tbl.shape[0] - 1).to(torch.int64)]
        ok = (idl >= 0) & (idr >= 0) & (rl != _I32_MIN) & (rr != _I32_MIN)
        fn = {"<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge,
              "=": torch.eq, "<>": torch.ne}[e.op]
        return fn(rl, rr), and_valid(and_valid(vl, vr), ok)

    def _c_Extract(self, e: E.Extract) -> TV:
        val, valid = self.compile(e.operand)
        ti = e.operand.type
        days, secs, frac = to_civil_parts(val, ti)
        return extract_field(e.field_, days, secs, frac, ti).to(torch.int64), valid

    def _c_DateTrunc(self, e: E.DateTrunc) -> TV:
        val, valid = self.compile(e.operand)
        return date_trunc(e.field_, val, e.operand.type), valid

    def _c_FunctionOp(self, e: E.FunctionOp) -> TV:
        name = e.name
        args = [self.compile(a) for a in e.args]
        valid = None
        for _, v in args:
            valid = and_valid(valid, v)
        vals = [torch.as_tensor(a) for a, _ in args]
        out_dt = e.type.np_dtype()
        if name.startswith("UDF:"):
            # the binder cast each argument to the UDF's declared type; a
            # NULL argument makes the result NULL, and fn may return its own
            # validity as (value, valid)
            fn, _, _ = self.udfs[name[4:]]
            res = fn(*vals)
            if isinstance(res, tuple):
                rval, rvalid = res
                return self._t(rval, out_dt), and_valid(valid, rvalid)
            return self._t(res, out_dt), valid
        f64 = torch.float64
        # real-valued functions see decimals as their real value
        if name in ("SQRT", "EXP", "LN", "LOG", "LOG10", "SIN", "COS", "TAN",
                    "ASIN", "ACOS", "ATAN", "ATAN2", "DEGREES", "RADIANS",
                    "POWER", "POW", "WIDTH_BUCKET"):
            vals = [
                v.to(f64) / (10**a.type.scale) if a.type.is_decimal else v
                for v, a in zip(vals, e.args)
            ]
        if name.startswith("DATEADD_"):
            return dateadd(name[8:], vals[0], vals[1], e.args[0].type), valid
        if name.startswith("DATEDIFF_"):
            return datediff(name[9:], vals[0], vals[1], e.args[0].type,
                            e.args[1].type), valid
        f1 = {
            "ABS": torch.abs, "SIGN": torch.sign,
            "SQRT": lambda x: torch.sqrt(x.to(f64)),
            "EXP": lambda x: torch.exp(x.to(f64)),
            "LN": lambda x: torch.log(x.to(f64)),
            "LOG": lambda x: torch.log(x.to(f64)),
            "LOG10": lambda x: torch.log10(x.to(f64)),
            "SIN": lambda x: torch.sin(x.to(f64)),
            "COS": lambda x: torch.cos(x.to(f64)),
            "TAN": lambda x: torch.tan(x.to(f64)),
            "ASIN": lambda x: torch.asin(x.to(f64)),
            "ACOS": lambda x: torch.acos(x.to(f64)),
            "ATAN": lambda x: torch.atan(x.to(f64)),
            "DEGREES": lambda x: torch.rad2deg(x.to(f64)),
            "RADIANS": lambda x: torch.deg2rad(x.to(f64)),
        }
        if name in f1:
            return self._t(f1[name](vals[0]), out_dt), valid
        if name in ("GREATEST", "LEAST"):
            # SQL n-ary max/min; NULL if any argument is NULL
            fn = torch.maximum if name == "GREATEST" else torch.minimum
            acc = self._t(vals[0], out_dt)
            for v in vals[1:]:
                acc = fn(acc, self._t(v, out_dt))
            return acc, valid
        if name in ("CEIL", "CEILING", "FLOOR"):
            ti = e.args[0].type
            up = name != "FLOOR"
            if ti.is_fp:
                return (torch.ceil if up else torch.floor)(vals[0]), valid
            if ti.is_decimal:
                m = 10**ti.scale
                if up:
                    return -fdiv(-vals[0], m) * m, valid
                return fdiv(vals[0], m) * m, valid
            return vals[0], valid
        if name in ("ROUND", "TRUNCATE"):
            ti = e.args[0].type
            if ti.is_fp:
                # scale, round and divide in float64, as the reference's
                # promotion does, then back to the result's type
                nd = vals[1].to(f64) if len(vals) > 1 else self._t(0.0, f64)
                m = torch.pow(self._t(10.0, f64), nd)
                x = vals[0].to(f64) * m
                x = (torch.round(x) if name == "ROUND" else torch.trunc(x)) / m
                return x.to(torch_dtype(e.type.np_dtype())), valid
            if ti.is_decimal:
                # zero out digits below 10^(scale-nd), half-up for ROUND
                ndig = e.args[1].value if len(e.args) > 1 and isinstance(
                    e.args[1], E.Constant) else 0
                shift = ti.scale - int(ndig)
                if shift <= 0:
                    return vals[0], valid
                m = 10**shift
                v = vals[0].to(torch.int64)
                if name == "ROUND":
                    v = v + torch.where(v >= 0, m // 2, -(m // 2))
                q = torch.sign(v) * fdiv(v.abs(), m)
                return q * m, valid
            return vals[0], valid
        if name in ("POWER", "POW"):
            return torch.pow(vals[0].to(f64), vals[1].to(f64)), valid
        if name == "ATAN2":
            return torch.atan2(vals[0].to(f64), vals[1].to(f64)), valid
        if name == "MOD":
            # SQL MOD: sign follows dividend (unlike numpy's %)
            a = self._t(vals[0], out_dt)
            b = self._t(vals[1], out_dt)
            r = torch.remainder(a.abs(), b.abs())
            return torch.where(a < 0, -r, r), valid
        if name == "WIDTH_BUCKET":
            x, lo, hi, n = [v.to(f64) for v in vals]
            b = torch.floor((x - lo) / (hi - lo) * n) + 1
            b = torch.where(x < lo, 0.0, b)
            b = torch.where(x >= hi, n + 1, b)
            return b.to(torch.int32), valid
        raise NotSupported(f"function {name}")

    def _c_Agg(self, e: E.Agg):
        raise NotSupported("aggregate outside Aggregate node")


# ---------------------------------------------------------------------------
# Casts
# ---------------------------------------------------------------------------


def cast_value(val: torch.Tensor, src: T.TypeInfo, dst: T.TypeInfo):
    """Physical cast (reference CastIR.cpp codegenCast)."""
    out_dt = torch_dtype(dst.np_dtype())
    i64 = torch.int64
    if src.is_null_type:
        return val.to(out_dt)
    if src.is_decimal and dst.is_decimal:
        if src.scale == dst.scale:
            return val.to(out_dt)
        if dst.scale > src.scale:
            return val.to(i64) * (10 ** (dst.scale - src.scale))
        return fdiv(val.to(i64), 10 ** (src.scale - dst.scale))
    if src.is_decimal:
        if dst.is_fp:
            return val.to(out_dt) / (10**src.scale)
        if dst.is_integer or dst.is_boolean:
            return fdiv(val.to(i64), 10**src.scale).to(out_dt)
    if dst.is_decimal:
        if src.is_fp:
            return torch.round(val.to(torch.float64) * (10**dst.scale)).to(i64)
        return val.to(i64) * (10**dst.scale)
    if src.is_time or dst.is_time:
        return _cast_time(val, src, dst)
    if src.is_fp and dst.is_integer:
        # trunc toward zero (LLVM fptosi semantics, matches sqlite CAST),
        # saturating at the target's range as XLA's convert does; NaN is 0
        return _saturating_trunc(val, out_dt)
    if src.is_fp and dst.is_boolean:
        return torch.trunc(val).to(out_dt)
    return val.to(out_dt)


def _saturating_trunc(val, out_dt):
    """trunc(val) converted to the integer dtype out_dt with every value
    past its range clamped to the range's end and NaN taken as 0: the same
    bits on the CPU and on CUDA, whose conversions differ out of range."""
    info = torch.iinfo(out_dt)
    t = torch.trunc(val.to(torch.float64))
    hi = t >= float(info.max)  # float(int64 max) is 2^63, itself out of range
    lo = t <= float(info.min)
    out = torch.where(hi | lo | torch.isnan(t), 0.0, t).to(out_dt)
    out = torch.where(hi, torch.tensor(info.max, dtype=out_dt, device=out.device), out)
    return torch.where(lo, torch.tensor(info.min, dtype=out_dt, device=out.device), out)


def _cast_time(val, src: T.TypeInfo, dst: T.TypeInfo):
    K = T.SQLTypeKind
    out_dt = torch_dtype(dst.np_dtype())
    v = val.to(torch.int64)
    if src.kind == K.DATE and dst.kind == K.TIMESTAMP:
        return (v * (86400 * 10**dst.precision)).to(out_dt)
    if src.kind == K.TIMESTAMP and dst.kind == K.DATE:
        return fdiv(v, 86400 * 10**src.precision).to(out_dt)
    if src.kind == K.TIMESTAMP and dst.kind == K.TIMESTAMP:
        if dst.precision >= src.precision:
            return v * (10 ** (dst.precision - src.precision))
        return fdiv(v, 10 ** (src.precision - dst.precision))
    if (src.is_time and (dst.is_integer or dst.is_fp)) or (
            src.is_integer and dst.is_time) or src.kind == dst.kind:
        return val.to(out_dt)
    raise NotSupported(f"cast {src} → {dst}")


# ---------------------------------------------------------------------------
# Date/time decomposition — vectorized civil-calendar arithmetic
# (reference QueryEngine/ExtractFromTime.cpp / DateTruncate.cpp)
# Algorithm: Howard Hinnant's days<->civil (public domain), int-vectorized.
# ---------------------------------------------------------------------------


def to_civil_parts(val, ti: T.TypeInfo):
    """-> (days_since_epoch, seconds_of_day, fractional_units) as int64."""
    K = T.SQLTypeKind
    v = torch.as_tensor(val).to(torch.int64)
    if ti.kind == K.DATE:
        return v, torch.zeros_like(v), torch.zeros_like(v)
    if ti.kind == K.TIME:
        return torch.zeros_like(v), v, torch.zeros_like(v)
    mult = 10**ti.precision
    epoch_s = fdiv(v, mult)
    frac = v - epoch_s * mult
    days = fdiv(epoch_s, 86400)
    secs = epoch_s - days * 86400
    return days, secs, frac


def civil_from_days(days):
    """days since 1970-01-01 -> (year, month, day) int64 tensors."""
    z = days + 719468
    era = fdiv(z, 146097)
    doe = z - era * 146097  # [0, 146096]
    yoe = fdiv(doe - fdiv(doe, 1460) + fdiv(doe, 36524) - fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + fdiv(yoe, 4) - fdiv(yoe, 100))
    mp = fdiv(5 * doy + 2, 153)
    d = doy - fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def days_from_civil(y, m, d):
    y = y - (m <= 2).to(torch.int64)
    era = fdiv(y, 400)
    yoe = y - era * 400
    mp = m + torch.where(m > 2, -3, 9)
    doy = fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + fdiv(yoe, 4) - fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def extract_field(field_: E.ExtractField, days, secs, frac, ti: T.TypeInfo):
    F = E.ExtractField
    if field_ == F.EPOCH:
        return days * 86400 + secs
    if field_ == F.HOUR:
        return fdiv(secs, 3600)
    if field_ == F.MINUTE:
        return fdiv(secs % 3600, 60)
    if field_ == F.SECOND:
        return secs % 60
    if field_ == F.MILLISECOND:
        mult = 10**ti.precision
        ms = fdiv(frac * 1000, mult) if mult else torch.zeros_like(frac)
        return (secs % 60) * 1000 + ms
    if field_ == F.DOW:
        # 0=Sunday..6=Saturday (HeavyDB ExtractFromTime.cpp:extract_dow)
        return (days + 4) % 7
    if field_ == F.ISODOW:
        return ((days + 3) % 7) + 1
    y, m, d = civil_from_days(days)
    if field_ == F.YEAR:
        return y
    if field_ == F.MONTH:
        return m
    if field_ == F.DAY:
        return d
    if field_ == F.QUARTER:
        return fdiv(m - 1, 3) + 1
    if field_ == F.DOY:
        jan1 = days_from_civil(y, torch.ones_like(m), torch.ones_like(d))
        return days - jan1 + 1
    if field_ == F.WEEK:
        # ISO week number
        dow = (days + 3) % 7  # 0=Mon
        thursday = days - dow + 3
        ty, _, _ = civil_from_days(thursday)
        jan1 = days_from_civil(ty, torch.ones_like(ty), torch.ones_like(ty))
        return fdiv(thursday - jan1, 7) + 1
    if field_ == F.DECADE:
        return fdiv(y, 10)
    if field_ == F.CENTURY:
        return fdiv(y + 99, 100)
    if field_ == F.MILLENNIUM:
        return fdiv(y + 999, 1000)
    raise NotSupported(f"EXTRACT {field_}")


def date_trunc(field_: E.ExtractField, val, ti: T.TypeInfo):
    F = E.ExtractField
    K = T.SQLTypeKind
    days, secs, frac = to_civil_parts(val, ti)
    mult = 10**ti.precision if ti.kind == K.TIMESTAMP else 1
    zero = torch.zeros_like(secs)

    def rebuild(days2, secs2):
        if ti.kind == K.DATE:
            return days2.to(torch.int32)
        return (days2 * 86400 + secs2) * mult

    if field_ == F.SECOND:
        return rebuild(days, secs)
    if field_ == F.MINUTE:
        return rebuild(days, fdiv(secs, 60) * 60)
    if field_ == F.HOUR:
        return rebuild(days, fdiv(secs, 3600) * 3600)
    if field_ == F.DAY:
        return rebuild(days, zero)
    if field_ == F.WEEK:
        return rebuild(days - (days + 3) % 7, zero)  # back to Monday
    y, m, d = civil_from_days(days)
    one = torch.ones_like(d)
    if field_ == F.MONTH:
        return rebuild(days_from_civil(y, m, one), zero)
    if field_ == F.QUARTER:
        return rebuild(days_from_civil(y, fdiv(m - 1, 3) * 3 + 1, one), zero)
    if field_ == F.YEAR:
        return rebuild(days_from_civil(y, one, one), zero)
    if field_ == F.DECADE:
        return rebuild(days_from_civil(fdiv(y, 10) * 10, one, one), zero)
    if field_ == F.CENTURY:
        return rebuild(days_from_civil(fdiv(y + 99, 100) * 100 - 99, one, one), zero)
    if field_ == F.MILLENNIUM:
        return rebuild(days_from_civil(fdiv(y + 999, 1000) * 1000 - 999, one, one),
                       zero)
    raise NotSupported(f"DATE_TRUNC {field_}")


def dateadd(unit: str, ts, amount, ti: T.TypeInfo):
    """reference QueryEngine/DateAdd.cpp semantics."""
    K = T.SQLTypeKind
    amount = torch.as_tensor(amount).to(torch.int64)
    ts = torch.as_tensor(ts)
    if ti.kind == K.DATE:
        days = ts.to(torch.int64)
        secs = torch.zeros_like(days)
        mult = 1
    else:
        days, secs, _ = to_civil_parts(ts, ti)
        mult = 10**ti.precision
    if unit in ("DAY", "WEEK"):
        k = 7 if unit == "WEEK" else 1
        days2, secs2 = days + k * amount, secs
    elif unit in ("HOUR", "MINUTE", "SECOND"):
        k = {"HOUR": 3600, "MINUTE": 60, "SECOND": 1}[unit]
        total = days * 86400 + secs + k * amount
        days2 = fdiv(total, 86400)
        secs2 = total - days2 * 86400
    elif unit in ("MONTH", "YEAR", "QUARTER"):
        y, m, d = civil_from_days(days)
        months = y * 12 + (m - 1) + amount * {"MONTH": 1, "QUARTER": 3, "YEAR": 12}[unit]
        y2 = fdiv(months, 12)
        m2 = months - y2 * 12 + 1
        # clamp day to target month length
        one = torch.ones_like(d)
        next_m = days_from_civil(y2 + (m2 == 12).to(torch.int64),
                                 torch.where(m2 == 12, 1, m2 + 1), one)
        maxd = next_m - days_from_civil(y2, m2, one)
        days2, secs2 = days_from_civil(y2, m2, torch.minimum(d, maxd)), secs
    else:
        raise NotSupported(f"DATEADD {unit}")
    if ti.kind == K.DATE:
        return days2.to(torch.int32)
    frac0 = ts.to(torch.int64) - (days * 86400 + secs) * mult
    return (days2 * 86400 + secs2) * mult + frac0


def datediff(unit: str, start, end, ti_a: T.TypeInfo, ti_b: T.TypeInfo):
    """DATEDIFF(unit, start, end) = end - start in units."""
    da, sa, _ = to_civil_parts(start, ti_a)
    db_, sb, _ = to_civil_parts(end, ti_b)
    if unit in ("DAY", "WEEK"):
        d = fdiv(db_ * 86400 + sb - da * 86400 - sa, 86400)
        return fdiv(d, 7) if unit == "WEEK" else d
    if unit in ("HOUR", "MINUTE", "SECOND"):
        k = {"HOUR": 3600, "MINUTE": 60, "SECOND": 1}[unit]
        return fdiv(db_ * 86400 + sb - da * 86400 - sa, k)
    ya, ma, _ = civil_from_days(da)
    yb, mb, _ = civil_from_days(db_)
    months = (yb * 12 + mb) - (ya * 12 + ma)
    if unit == "MONTH":
        return months
    if unit == "QUARTER":
        return fdiv(months, 3)
    if unit == "YEAR":
        return yb - ya
    raise NotSupported(f"DATEDIFF {unit}")
