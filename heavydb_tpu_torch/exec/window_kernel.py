"""Window node: every window column of a Window node, computed eagerly.

Port of heavydb_tpu/exec/window_kernel.py.  One sort per distinct
(partition, order) spec, then segmented scans in sorted order
(ops/window.py).  Torch runs eagerly, so there is no jit, no artifact
cache and no split into a sort program and a functions program.

The sort: when every key has a range from chunk stats (`_pack_plan`), one
`torch.sort` of a packed int64 key [~in_domain | partition fields |
order fields | row] (stable, without the row field, when the row bits do
not fit); otherwise (FLOAT keys, keys with no range) a stable
lexicographic sort of (null flag, canonical value) operands: the
partition keys through `ops/groupby._canonical_key`, the order keys
through `ops/sort._sortable_operands`.  Out-of-domain pad rows sort last
and form their own partition.  Dictionary-string ORDER BY keys are
ranked lexicographically through the id -> rank table the executor ships
(`rank_info`).

Egress modes, the reference's rule: "sorted" (one spec, at most 12
present columns) emits the batch in sorted order — the present columns
are gathered through the permutation once and the window arguments
compiled over them; "permsort" keeps the input row order — the argument
columns are gathered through each spec's permutation once, and each
output goes back with one scatter.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from heavydb_tpu_torch.errors import NotSupported
from heavydb_tpu_torch.exec.compound_kernel import _broadcast as _full
from heavydb_tpu_torch.exec.compound_kernel import derive_valid
from heavydb_tpu_torch.exec.expr_compiler import ExprCompiler
from heavydb_tpu_torch.ops import window as W
from heavydb_tpu_torch.ops.groupby import _canonical_key, _lex_sort_perm, torch_dtype
from heavydb_tpu_torch.ops.sort import _sortable_operands
from heavydb_tpu_torch.plan import exprs as E

# the most present columns the "sorted" egress gathers
SORTED_MODE_MAX_COLS = 12


def _spec_of(w: E.WindowFunc) -> tuple:
    return (tuple(p.key() for p in w.partition_by),
            tuple((e.key(), a, nf) for e, a, nf in w.order_by))


def run_window(node, inp, aux, rank_info=None, udfs=None, device="cpu"):
    """Returns (cols, wcols, runs): the (possibly reordered) input columns,
    the window outputs row-aligned with them, and one record a spec (its
    egress mode and whether its sort key was packed)."""
    padded = inp.padded
    present = [i for i, c in enumerate(inp.cols) if c is not None]
    wfuncs = node.wfuncs
    rank_info = rank_info or {}
    device = torch.device(device)

    # group the functions by (partition, order) spec: one sort a spec
    spec_groups: Dict[tuple, List[int]] = {}
    for i, w in enumerate(wfuncs):
        spec_groups.setdefault(_spec_of(w), []).append(i)
    mode = "sorted" if (len(spec_groups) == 1
                        and len(present) <= SORTED_MODE_MAX_COLS) else "permsort"

    in_domain = torch.arange(padded, device=device) < inp.nrows
    comp = _col_compiler(inp, present, inp.cols, aux, udfs, device)
    outs: List[torch.Tensor] = [None] * len(wfuncs)
    cols_out = list(inp.cols)
    runs = []
    for widxs in spec_groups.values():
        w0 = wfuncs[widxs[0]]
        pack = _pack_plan(node, w0, padded, rank_info)
        if pack is not None:
            s_rows, pstart, ostart = _packed_sort(pack, comp, in_domain, padded, aux)
        else:
            s_rows, pstart, ostart = _generic_sort(w0, comp, in_domain, padded, aux,
                                                   rank_info)
        runs.append(dict(mode=mode, sort="packed" if pack is not None else "generic",
                         functions=len(widxs)))
        if mode == "sorted":
            sorted_cols = [inp.cols[i][s_rows] for i in present]
            for ci, sc in zip(present, sorted_cols):
                cols_out[ci] = sc
            # the sorted domain is the output domain: arguments compile over
            # the sorted columns and nothing is reordered
            scomp = _col_compiler(inp, present, dict(zip(present, sorted_cols)), aux,
                                  udfs, device)
            for wi in widxs:
                val_s, valid_s = _compute_one(wfuncs[wi], scomp, None, pstart, ostart)
                outs[wi] = _finalize_sorted(wfuncs[wi], val_s, valid_s, padded)
            continue
        pay_sorted = _payload_sorted(comp, _payload_plan(wfuncs, widxs), s_rows, padded)
        for wi in widxs:
            val_s, valid_s = _compute_one(wfuncs[wi], comp, s_rows, pstart, ostart,
                                          pay_sorted)
            val = _finalize_sorted(wfuncs[wi], val_s, valid_s, padded)
            out = torch.empty_like(val)
            out[s_rows] = val
            outs[wi] = out
    return cols_out, outs, runs


def _pack_plan(node, w0, padded: int, rank_info=None):
    """Host-side plan to pack every (partition, order) key into one
    bounded non-negative int64, from the keys' chunk-stat ranges
    (exec/ranges.py).  None when a key has no range (floats, unbounded
    expressions): the generic operand sort takes those."""
    from heavydb_tpu_torch.exec import ranges as RG

    fields = []
    for p in w0.partition_by:
        r = RG.expr_range(p, node.inputs)
        if r is None or r.extent <= 0:
            return None
        fields.append({"expr": p, "order": False, "asc": True,
                       "nulls_first": True, "r": r})
    for e, asc, nf in w0.order_by:
        ri = (rank_info or {}).get(e.key())
        if ri is not None:
            # a rank-translated dictionary-string key lands in [0, dsize)
            ak, dsize = ri
            r = RG.IntRange(0, max(dsize - 1, 0), e.type.nullable)
            fields.append({"expr": e, "order": True, "asc": asc,
                           "nulls_first": nf, "r": r, "rank": ak})
            continue
        r = RG.expr_range(e, node.inputs)
        if r is None or r.extent <= 0:
            return None
        fields.append({"expr": e, "order": True, "asc": asc,
                       "nulls_first": nf, "r": r})
    order_bits = 0
    key_bits = 1  # the in-domain flag rides the top bit
    for f in fields:
        r = f["r"]
        extent = int(r.extent)
        field_extent = extent + (1 if r.has_nulls else 0)
        bits = max(field_extent - 1, 0).bit_length()
        f["extent"] = extent
        f["bits"] = bits
        key_bits += bits
        if f["order"]:
            order_bits += bits
    if key_bits > 62:
        return None
    rows_bits = max((padded - 1).bit_length(), 1)
    fuse_rows = key_bits + rows_bits <= 62
    return {"fields": fields, "key_bits": key_bits, "order_bits": order_bits,
            "rows_bits": rows_bits, "fuse_rows": fuse_rows}


def _rank_translate(val, aux, ak):
    """id -> lexicographic rank through the shipped table (a clamped
    gather: a NULL id lands on an arbitrary rank, masked by its valid)."""
    tbl = aux[ak]
    ids = torch.as_tensor(val).to(torch.int64).clamp(0, tbl.shape[0] - 1)
    return tbl[ids]


def _packed_sort(pack, comp, in_domain, padded, aux):
    """Build the packed key, sort it, and return (s_rows, pstart, ostart)
    in sorted order.  Key layout, high to low bits: [~in_domain |
    partition fields | order fields | row?].  pstart = a change in the
    partition prefix; ostart = a change in the whole key (every consumer
    reads pstart | ostart)."""
    acc = (~in_domain).to(torch.int64)
    for f in pack["fields"]:
        r = f["r"]
        extent = f["extent"]
        val, valid = comp.compile(f["expr"])
        if "rank" in f:
            val = _rank_translate(val, aux, f["rank"])
        v = _full(val, padded).to(torch.int64)
        bucket = max(r.bucket, 1)
        if f["order"] and not f["asc"]:
            base = torch.div(r.hi - v, bucket, rounding_mode="floor")
        else:
            base = torch.div(v - r.lo, bucket, rounding_mode="floor")
        # pad rows carry any values: clamp so that they cannot reach higher
        # fields (they sort last by the domain flag regardless)
        base = base.clamp(0, extent - 1)
        if r.has_nulls:
            ok = _full(valid, padded) if valid is not None else None
            if f["order"] and not f["nulls_first"]:
                field = base if ok is None else torch.where(ok, base, extent)
            else:
                field = base + 1 if ok is None else torch.where(ok, base + 1, 0)
        else:
            field = base
        acc = (acc << f["bits"]) | field
    rb = pack["rows_bits"]
    if pack["fuse_rows"]:
        # unique keys: the row index rides the low bits, no stable sort
        acc <<= rb
        acc |= torch.arange(padded, dtype=torch.int64, device=acc.device)
        acc_s = torch.sort(acc).values
        del acc
        s_rows = acc_s & ((1 << rb) - 1)
        kwr = acc_s >> rb
    else:
        kwr, s_rows = torch.sort(acc, stable=True)
    return s_rows, _changes(kwr >> pack["order_bits"]), _changes(kwr)


def _changes(x):
    """bool[n]: row 0, and every row whose value differs from the row
    before it."""
    return torch.cat([torch.ones(1, dtype=torch.bool, device=x.device), x[1:] != x[:-1]])


def _generic_sort(w0, comp, in_domain, padded, aux, rank_info):
    """A stable lexicographic sort of the keys' operands; pstart and
    ostart come from inequality of the sorted partition and order operands
    only (never the row index)."""
    operands = [(~in_domain).to(torch.int8)]
    for p in w0.partition_by:
        val, valid = comp.compile(p)
        nullf, v = _canonical_key(_full(val, padded),
                                  None if valid is None else _full(valid, padded))
        operands += [v] if nullf is None else [nullf, v]
    n_part = len(operands)
    for e, asc, nf in w0.order_by:
        val, valid = comp.compile(e)
        ri = rank_info.get(e.key())
        if ri is not None:
            val = _rank_translate(val, aux, ri[0])
        operands += list(_sortable_operands(
            _full(val, padded), None if valid is None else _full(valid, padded), asc, nf))
    s_rows = _lex_sort_perm(operands)
    pstart = torch.zeros(padded, dtype=torch.bool, device=s_rows.device)
    ostart = torch.zeros_like(pstart)
    for j, op in enumerate(operands):
        ch = _changes(op[s_rows])
        if j < n_part:
            pstart |= ch
        else:
            ostart |= ch
    pstart[0] = True
    return s_rows, pstart, ostart


def _payload_plan(wfuncs, widxs):
    """The distinct non-constant first arguments of a spec's functions:
    each is gathered through the spec's permutation once."""
    exprs: List[E.Expr] = []
    seen = set()
    for wi in widxs:
        w = wfuncs[wi]
        if w.args and not isinstance(w.args[0], E.Constant) \
                and w.kind != E.WindowKind.NTILE:
            k = w.args[0].key()
            if k not in seen:
                seen.add(k)
                exprs.append(w.args[0])
    return exprs


def _payload_sorted(comp, payload_exprs, s_rows, padded):
    """expr key -> (value, valid) in sorted order."""
    out = {}
    for e in payload_exprs:
        val, valid = comp.compile(e)
        sval = _full(val, padded)[s_rows]
        if valid is not None and torch.as_tensor(valid).dim():
            valid = valid[s_rows]
        out[e.key()] = (sval, valid)
    return out


def _col_compiler(inp, present, cols, aux, udfs, device):
    col_tvs = {}
    for ci in present:
        ti = inp.types[ci]
        val = cols[ci]
        col_tvs[ci] = (val, derive_valid(val, ti) if ti.nullable else None)
    return ExprCompiler(col_tvs, aux, {}, device, inp.padded, udfs)


def _finalize_sorted(w, val_s, valid_s, padded):
    """One window output in sorted order with its egress dtype and NULLs
    as the type's sentinel (NaN for floats)."""
    out_dt = torch_dtype(w.type.np_dtype())
    val = _full(val_s, padded).to(out_dt)
    if valid_s is None:
        return val
    null = float("nan") if val.is_floating_point() else w.type.null_sentinel()
    return torch.where(_full(valid_s, padded), val,
                       torch.full((), null, dtype=out_dt, device=val.device))


def _compute_one(w: E.WindowFunc, comp: ExprCompiler, s_rows, pstart, ostart,
                 pay_sorted=None):
    """One window function in SORTED order.  s_rows None: comp is built
    over the sorted columns already."""
    K = E.WindowKind
    n = pstart.shape[0]
    dev = pstart.device

    def arg_tv(i):
        hit = (pay_sorted or {}).get(w.args[i].key())
        if hit is not None:
            val, valid = hit
        else:
            val, valid = comp.compile(w.args[i])
            val = _full(val, n)
            if s_rows is not None:
                val = val[s_rows]
                if valid is not None and torch.as_tensor(valid).dim():
                    valid = valid[s_rows]
        if valid is not None:
            valid = _full(valid, n)
        return val, valid

    def const_arg(i, default):
        if len(w.args) > i and isinstance(w.args[i], E.Constant):
            v = w.args[i].value
            ti = w.args[i].type
            if ti.is_decimal and v is not None:
                v = v / 10**ti.scale
            return int(v) if v is not None else default
        return default

    if w.kind == K.ROW_NUMBER:
        return W.row_number(pstart), None
    if w.kind == K.RANK:
        return W.rank(pstart, ostart), None
    if w.kind == K.DENSE_RANK:
        return W.dense_rank(pstart, ostart), None
    if w.kind == K.PERCENT_RANK:
        return W.percent_rank(pstart, ostart), None
    if w.kind == K.CUME_DIST:
        return W.cume_dist(pstart, ostart), None
    if w.kind == K.NTILE:
        return W.ntile(pstart, const_arg(0, 1)), None
    if w.kind in (K.LAG, K.LEAD):
        val, valid = arg_tv(0)
        off = const_arg(1, 1)
        default_tv = None
        if len(w.args) > 2:
            dv, dvalid = comp.compile(w.args[2])
            if w.args[2].type.is_decimal:
                # decimals are scaled integers on the device; the output
                # column is a plain number, so the default is rescaled
                dv = torch.as_tensor(dv).to(torch.float64) / 10**w.args[2].type.scale
            default_tv = (dv, dvalid)
        if w.ignore_nulls:
            # the off-th non-null strictly before (LAG) / after (LEAD) the row
            compact, base, c, ok = W.nonnull_lookup(val, valid, pstart)
            if w.kind == K.LAG:
                ordinal = c - ok.to(torch.int64) - (off - 1)
            else:
                _, pe = W.segment_bounds(pstart)
                total = c[pe]
                ordinal = c + off
                ordinal = torch.where(ordinal <= total, ordinal, 0)
            hit = ordinal >= 1
            out = compact[(base + ordinal - 1).clamp(0, n - 1)]
            outv = hit
            if default_tv is not None:
                dv, dvalid = default_tv
                out = torch.where(hit, out, torch.as_tensor(dv).to(device=dev,
                                                                   dtype=out.dtype))
                dvv = torch.ones((), dtype=torch.bool, device=dev) if dvalid is None \
                    else dvalid
                outv = torch.where(hit, outv, dvv)
            return out, outv
        if w.kind == K.LEAD:
            off = -off
        return W.shift_in_partition(val, valid, pstart, off, default_tv)
    if w.kind in (K.FIRST_VALUE, K.LAST_VALUE, K.NTH_VALUE):
        val, valid = arg_tv(0)
        if w.ignore_nulls:
            compact, base, c, ok = W.nonnull_lookup(val, valid, pstart)
            if w.frame is not None:
                lo, hi = W.frame_bounds(pstart, ostart, w.frame)
            else:
                lo, _ = W.segment_bounds(pstart)
                _, hi = W.segment_bounds(pstart | ostart)
            loc = lo.clamp(0, n - 1)
            hic = hi.clamp(0, n - 1)
            cb_lo = c[loc] - ok[loc].to(torch.int64)
            c_hi = c[hic]
            if w.kind == K.FIRST_VALUE:
                ordinal = cb_lo + 1
            elif w.kind == K.LAST_VALUE:
                ordinal = c_hi
            else:
                ordinal = cb_lo + const_arg(1, 1)
            hit = (ordinal >= cb_lo + 1) & (ordinal <= c_hi) & (lo <= hi) & (ordinal >= 1)
            return compact[(base + ordinal - 1).clamp(0, n - 1)], hit
        if w.frame is not None:
            lo, hi = W.frame_bounds(pstart, ostart, w.frame)
            if w.kind == K.FIRST_VALUE:
                pos = lo
            elif w.kind == K.LAST_VALUE:
                pos = hi
            else:
                pos = lo + (const_arg(1, 1) - 1)
            in_frame = (pos >= lo) & (pos <= hi)
            pos_c = pos.clamp(0, n - 1)
            outv = in_frame if valid is None else valid[pos_c] & in_frame
            return val[pos_c], outv
        if w.kind == K.FIRST_VALUE:
            return W.first_value(val, valid, pstart)
        if w.kind == K.LAST_VALUE:
            return W.last_value_frame(val, valid, pstart, ostart)
        nth = const_arg(1, 1)
        _, start_idx = W.forward_fill_value(val, pstart)
        pos = start_idx + (nth - 1)
        ok = (nth >= 1) & ((nth - 1) < W.partition_counts(pstart))
        pos_c = pos.clamp(0, n - 1)
        return val[pos_c], (ok if valid is None else valid[pos_c] & ok)
    if w.kind in (K.SUM, K.AVG, K.MIN, K.MAX, K.COUNT):
        if w.args:
            val, valid = arg_tv(0)
            ati = w.args[0].type
        else:
            val = torch.ones(n, dtype=torch.int64, device=dev)
            valid = None
            ati = None
        kind = w.kind.value
        acc = w.type.np_dtype()
        if w.kind == K.AVG:
            acc = np.dtype(np.float64)
            if ati is not None and ati.is_decimal:
                val = val.to(torch.float64) / 10**ati.scale
        if w.frame is not None:
            unit, b1, b2 = w.frame
            lo, hi = W.frame_bounds(pstart, ostart, w.frame)
            lo_unb, hi_unb = b1[0] == "UP", b2[0] == "UF"
            group_starts = None
            rows_w = None
            rows_offsets = None
            if not lo_unb and not hi_unb:
                if unit == "RANGE":
                    group_starts = pstart | ostart
                else:
                    lo_off = -b1[1] if b1[0] == "P" else (b1[1] if b1[0] == "F" else 0)
                    hi_off = -b2[1] if b2[0] == "P" else (b2[1] if b2[0] == "F" else 0)
                    rows_w = max(hi_off - lo_off + 1, 1)
                    rows_offsets = (int(lo_off), int(hi_off))
            return W.framed_agg(val, valid, pstart, lo, hi, kind, acc, lo_unb, hi_unb,
                                rows_w, group_starts, rows_offsets=rows_offsets)
        if w.order_by:
            return W.running_agg(val, valid, pstart, ostart, kind, acc)
        return W.whole_partition_agg(val, valid, pstart, kind, acc)
    raise NotSupported(f"window function {w.kind}")
