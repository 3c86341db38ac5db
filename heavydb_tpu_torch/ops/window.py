"""Window-function building blocks.

Port of heavydb_tpu/ops/window.py, function for function.  One global
sort by (partition keys, order keys) turns every per-partition quantity
into a segmented scan over the sorted row order — positions, ranks,
prefix aggregates — which the caller scatters back to the row order
(exec/window_kernel.py).

All helpers below work in SORTED order and take:
  pstart: bool[n]  — row starts a new partition
  ostart: bool[n]  — row starts a new peer group (order-key change)

Index math is int64 and sums are native int64 / float64 `torch.cumsum`s:
the reference's blocked and double-single scans, its f32 pairs and its
int32 index math exist for the TPU and are not copied.  A running or
framed SUM keeps the reference's formula (a global prefix less a
propagated base), which sets its rounding.  Segmented propagation is a
prefix count of the flags, a scatter of the flagged rows' indices by
their ordinals and one gather (`torch.cummax` would do it in one call,
but scans one long row serially on CUDA: 310 ms for 10^8 rows on an
H100); a running MIN / MAX with resets is a running maximum of
(partition id, orderable code) for values of 32 bits or fewer, in blocks
(`_cummax`), else a doubling scan of ceil(log2 n) passes (the form of a
whole partition's float SUM too, which must stay inside its partition).
Both keep `minimum` / `maximum`'s NaN propagation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from heavydb_tpu_torch.ops.groupby import torch_dtype

TV = Tuple[torch.Tensor, Optional[torch.Tensor]]

# the rows a block of the blocked running maximum (_cummax) scans
_SCAN_BLOCK = 4096


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _flag_positions(flag):
    """(c, pos): c[i] = the flags at or before row i (int64); pos[k] = the
    row of the k-th flag, k < c[-1].  One scatter without collisions:
    each flagged row to its ordinal, every other row to a cell of its own
    past n."""
    n = flag.shape[0]
    c = torch.cumsum(flag, 0, dtype=torch.int64)
    i = _iota(n, flag.device)
    tgt = torch.where(flag, c - 1, n + i)
    pos = torch.empty(2 * n, dtype=torch.int64, device=flag.device)
    pos[tgt] = i
    return c, pos


def _flag_index(flag, reverse: bool = False) -> torch.Tensor:
    """Index of the nearest flagged row at or before each row (at or after
    it when reverse); row 0 (row n-1) where there is none, as the
    reference's scan leaves the first (last) row's value there."""
    n = flag.shape[0]
    c, pos = _flag_positions(flag)
    if not reverse:
        return torch.where(c > 0, pos[(c - 1).clamp(min=0)], 0)
    k = c - flag.to(torch.int64)  # flags before the row: the next one's ordinal
    return torch.where(k < c[-1], pos[k], n - 1)


def seg_propagate(flag, *vals, reverse: bool = False):
    """Propagate each value AT a flag position across its segment —
    forward (toward later rows) or backward."""
    idx = _flag_index(flag, reverse)
    out = tuple(v[idx] for v in vals)
    return out if len(vals) > 1 else out[0]


def forward_fill_value(x, pstart):
    """Broadcast the value at each partition start to the whole
    partition; also returns the start index of each row's partition."""
    idx = _flag_index(pstart)
    return x[idx], idx


def partition_ids(pstart):
    return torch.cumsum(pstart.to(torch.int64), 0) - 1


def row_number(pstart):
    idx = _iota(pstart.shape[0], pstart.device)
    return idx - _flag_index(pstart) + 1


def rank(pstart, ostart):
    return _flag_index(pstart | ostart) - _flag_index(pstart) + 1


def dense_rank(pstart, ostart):
    g = torch.cumsum((pstart | ostart).to(torch.int64), 0)
    base, _ = forward_fill_value(g - 1, pstart)
    return g - base


def _next_start_idx(starts):
    """For each row, the index of the next segment start AFTER it (n if
    none)."""
    c, pos = _flag_positions(starts)
    return torch.where(c < c[-1], pos[c], starts.shape[0])


def segment_bounds(starts):
    """(start_idx[i], end_idx[i]) of the segment containing each row.
    starts[0] must be True."""
    c, pos = _flag_positions(starts)
    start = torch.where(c > 0, pos[(c - 1).clamp(min=0)], 0)
    return start, torch.where(c < c[-1], pos[c], starts.shape[0]) - 1


def partition_counts(pstart):
    """Partition size broadcast to each row (sorted order)."""
    ps, pe = segment_bounds(pstart)
    return pe - ps + 1


def percent_rank(pstart, ostart):
    """(rank - 1) / (partition size - 1), divided in float32 as the
    reference's int32 division is (widened to DOUBLE at egress)."""
    r = rank(pstart, ostart)
    c = partition_counts(pstart)
    return torch.where(c > 1, (r - 1).float() / torch.clamp(c - 1, min=1).float(),
                       torch.zeros((), dtype=torch.float32, device=c.device))


def cume_dist(pstart, ostart):
    """# peers with order-key <= current / partition size, in float32 as
    percent_rank."""
    _, peer_end = segment_bounds(pstart | ostart)
    ps, pe = segment_bounds(pstart)
    return (peer_end - ps + 1).float() / (pe - ps + 1).float()


def ntile(pstart, n_buckets):
    rn = row_number(pstart) - 1
    c = partition_counts(pstart)
    nb = int(n_buckets)
    base = torch.div(c, nb, rounding_mode="floor")
    rem = c - base * nb
    # the first `rem` buckets get base+1 rows
    big = rem * (base + 1)
    t = torch.where(
        rn < big,
        torch.div(rn, torch.clamp(base + 1, min=1), rounding_mode="floor"),
        rem + torch.div(rn - big, torch.clamp(base, min=1), rounding_mode="floor"),
    )
    return t + 1


def nonnull_lookup(vals, valid, pstart):
    """IGNORE NULLS navigation: the non-null values compacted globally
    (a scatter into n + 1 cells, the last one dropped), and per row base[i]
    — the compact index of the partition's first non-null — and c[i] — the
    inclusive non-null count within the partition.  The j-th non-null of a
    partition is compact[base + j - 1]."""
    n = vals.shape[0]
    ok = valid if valid is not None else torch.ones(n, dtype=torch.bool, device=vals.device)
    oki = ok.to(torch.int64)
    cpre = torch.cumsum(oki, 0)
    compact = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    compact[torch.where(ok, cpre - 1, n)] = vals
    before_part, _ = forward_fill_value(cpre - oki, pstart)
    return compact[:n], before_part, cpre - before_part, ok


def _static_shift(x, offset: int, fill):
    """out[i] = x[i - offset] for a static offset: a slice and a pad."""
    n = x.shape[0]
    k = min(abs(int(offset)), n)
    if k == 0:
        return x
    pad = torch.full((k,), fill, dtype=x.dtype, device=x.device)
    if offset > 0:
        return torch.cat([pad, x[:n - k]])
    return torch.cat([x[k:], pad])


def shift_in_partition(vals, valid, pstart, offset: int, default_tv=None):
    """LAG (offset > 0) / LEAD (offset < 0) within partitions, sorted
    order: a static shift, and the row's partition id against the shifted
    one."""
    pid = partition_ids(pstart)
    same = _static_shift(pid, offset, -1) == pid
    out = _static_shift(vals, offset, 0)
    if valid is not None:
        outv = _static_shift(valid, offset, False) & same
    else:
        outv = same
    if default_tv is not None:
        dval, dvalid = default_tv
        out = torch.where(same, out, torch.as_tensor(dval).to(device=out.device,
                                                              dtype=out.dtype))
        dv = torch.ones((), dtype=torch.bool, device=out.device) if dvalid is None else dvalid
        outv = torch.where(same, outv, dv)
    return out, outv


def first_value(vals, valid, pstart):
    idx = _flag_index(pstart)
    return vals[idx], (None if valid is None else valid[idx])


def _end_flags(starts):
    """Row ends its segment iff the next row starts one."""
    return torch.cat([starts[1:], torch.ones(1, dtype=torch.bool, device=starts.device)])


def last_value_frame(vals, valid, pstart, ostart):
    """LAST_VALUE over the default frame (... AND CURRENT ROW with RANGE
    peers): the value at the last peer row."""
    idx = _flag_index(_end_flags(pstart | ostart), reverse=True)
    return vals[idx], (None if valid is None else valid[idx])


def _seg_running_sum(x, starts):
    """Segmented inclusive running sum: the global prefix less the prefix
    before the segment's start, propagated from the start."""
    pre = torch.cumsum(x, 0)
    return pre - seg_propagate(starts, pre - x)


def _minmax_ident(kind: str, acc_dtype):
    dt = np.dtype(acc_dtype)
    fp = dt.kind == "f"
    if kind == "MIN":
        return (np.inf if fp else int(np.iinfo(dt).max)), torch.minimum
    return (-np.inf if fp else int(np.iinfo(dt).min)), torch.maximum


def _orderable32(x):
    """Values of <= 32 bits -> int64 codes in [0, 2^32) whose order is
    theirs (floats by their sign-flipped bits)."""
    if x.dtype == torch.float32:
        b = x.view(torch.int32)
        return (b ^ ((b >> 31) & 0x7FFFFFFF)).to(torch.int64) + (1 << 31)
    return x.to(torch.int64) + (1 << 31)


def _from_orderable32(code, dtype):
    s = code - (1 << 31)
    if dtype == torch.float32:
        s = s.to(torch.int32)
        return (s ^ ((s >> 31) & 0x7FFFFFFF)).view(torch.float32)
    return s.to(dtype)


def _seg_running_op(x, starts, op):
    """Segmented inclusive running MIN (op = torch.minimum) or MAX
    (torch.maximum), reset at starts."""
    is_min = op is torch.minimum
    if x.element_size() <= 4 and x.dtype != torch.bool:
        # one running maximum of (partition id << 32) | code: a later partition's id
        # outranks every earlier code, so the maximum resets at each start
        fp = x.is_floating_point()
        nan = torch.isnan(x) if fp else None
        if fp:
            ident = np.inf if is_min else -np.inf
            x = torch.where(nan, torch.full((), ident, dtype=x.dtype, device=x.device), x)
        code = _orderable32(x)
        if is_min:
            code = ((1 << 32) - 1) - code
        pid = torch.cumsum(starts.to(torch.int64), 0)
        run = _cummax((pid << 32) | code) & ((1 << 32) - 1)
        if is_min:
            run = ((1 << 32) - 1) - run
        out = _from_orderable32(run, x.dtype)
        if fp:
            # minimum / maximum propagate NaN to the rest of the partition
            seen = _seg_running_sum(nan.to(torch.int64), starts) > 0
            out = torch.where(seen, torch.full((), float("nan"), dtype=x.dtype,
                                               device=x.device), out)
        return out
    return _doubling_scan(x, starts, op)


def _cummax(x):
    """Inclusive running maximum of a 1-D int64 tensor.  torch.cummax scans
    one long row serially on CUDA (310 ms for 10^8 rows on an H100, 2.9 in
    blocks), so the rows scan in
    blocks of _SCAN_BLOCK, one block a row, and each block then takes the
    running maximum of the blocks before it."""
    n = x.shape[0]
    if n <= _SCAN_BLOCK:
        return torch.cummax(x, 0).values
    nb = -(-n // _SCAN_BLOCK)
    pad = torch.full((nb * _SCAN_BLOCK - n,), torch.iinfo(torch.int64).min,
                     dtype=x.dtype, device=x.device)
    within = torch.cummax(torch.cat([x, pad]).view(nb, _SCAN_BLOCK), 1).values
    carry = torch.cummax(within[:, -1], 0).values
    within[1:] = torch.maximum(within[1:], carry[:-1, None])
    return within.view(-1)[:n]


def _doubling_scan(x, starts, op):
    """Segmented inclusive scan of an elementwise associative op, reset at
    starts: ceil(log2 n) passes, each combining a row with the row d
    before it while that row is in its segment."""
    n = x.shape[0]
    dist = _iota(n, x.device) - _flag_index(starts)  # rows since the start
    d = 1
    while d < n:
        x = torch.where(dist >= d, op(x, _static_shift(x, d, 0)), x)
        d *= 2
    return x


def running_agg(vals, valid, pstart, ostart, kind: str, acc_dtype):
    """SUM/COUNT/AVG/MIN/MAX over UNBOUNDED PRECEDING..CURRENT ROW with
    RANGE peer semantics (all peers share the value at their last peer)."""
    n = pstart.shape[0]
    dev = pstart.device
    ok = valid if valid is not None else torch.ones(n, dtype=torch.bool, device=dev)
    acc = torch_dtype(acc_dtype)
    if kind in ("SUM", "AVG", "COUNT"):
        if kind == "COUNT":
            contrib = ok.to(torch.int64)
        else:
            contrib = torch.where(ok, vals.to(acc), torch.zeros((), dtype=acc, device=dev))
        pre = torch.cumsum(contrib, 0)
        run = pre - seg_propagate(pstart, pre - contrib)
    elif kind in ("MIN", "MAX"):
        ident, op = _minmax_ident(kind, acc_dtype)
        x = torch.where(ok, vals.to(acc), torch.full((), ident, dtype=acc, device=dev))
        run = _seg_running_op(x, pstart, op)
    else:
        raise ValueError(kind)
    crun = _seg_running_sum(ok.to(torch.int64), pstart)
    # RANGE frame: every row sees the value at the END of its peer group
    idx = _flag_index(_end_flags(pstart | ostart), reverse=True)
    run, crun = run[idx], crun[idx]
    if kind == "COUNT":
        return run, None
    if kind == "AVG":
        return run / torch.clamp(crun, min=1), crun > 0
    return run, crun > 0


def whole_partition_agg(vals, valid, pstart, kind: str, acc_dtype):
    """Aggregate over the ENTIRE partition (no ORDER BY in the window): a
    forward segmented running aggregate whose partition-end value
    propagates backward to every row."""
    n = pstart.shape[0]
    dev = pstart.device
    ok = valid if valid is not None else torch.ones(n, dtype=torch.bool, device=dev)
    end_idx = _flag_index(_end_flags(pstart), reverse=True)
    cnt_run = _seg_running_sum(ok.to(torch.int64), pstart)
    cnt = cnt_run[end_idx]
    if kind == "COUNT":
        return cnt, None
    acc = torch_dtype(acc_dtype)
    if kind in ("SUM", "AVG"):
        x = torch.where(ok, vals.to(acc), torch.zeros((), dtype=acc, device=dev))
        # floats by a scan that stays in the partition, as the reference's
        # segmented scan does: a global prefix would carry an inf or a NaN
        # into every later partition
        s = (_doubling_scan(x, pstart, torch.add) if x.is_floating_point()
             else _seg_running_sum(x, pstart))[end_idx]
        if kind == "AVG":
            return s / torch.clamp(cnt, min=1), cnt > 0
        return s, cnt > 0
    if kind in ("MIN", "MAX"):
        ident, op = _minmax_ident(kind, acc_dtype)
        x = torch.where(ok, vals.to(acc), torch.full((), ident, dtype=acc, device=dev))
        return _seg_running_op(x, pstart, op)[end_idx], cnt > 0
    raise ValueError(kind)


def _prefix(x):
    c = torch.cumsum(x, 0)
    return torch.cat([torch.zeros(1, dtype=c.dtype, device=c.device), c])


def _floor_log2(length, levels: int):
    """floor(log2(length)) for 1 <= length < 2^levels, exactly in
    integers: the count of powers 2^1 .. 2^(levels-1) at most length."""
    j = torch.zeros_like(length)
    for k in range(1, levels):
        j += (length >= (1 << k)).to(length.dtype)
    return j


def _window_minmax_table(x, lo, hi, max_width: int, op, ident):
    """min/max over [lo, hi] per row via a doubling sparse table with
    ceil(log2(max_width)) levels; windows are <= max_width after clamping.
    Two gathers of the flattened table at int64 indices j * n + lo."""
    n = x.shape[0]
    tables = [x]
    shift = 1
    while shift < max_width:
        prev = tables[-1]
        tables.append(op(prev, _static_shift(prev, -shift, ident)))
        shift *= 2
    stk = torch.stack(tables).reshape(-1)
    length = torch.clamp(hi - lo + 1, min=1)
    j = _floor_log2(length, len(tables))
    pw = torch.ones_like(j) << j
    a = stk[j * n + lo]
    b = stk[j * n + hi - pw + 1]
    return op(a, b)


def framed_agg(vals, valid, pstart, lo, hi, kind: str, acc_dtype,
               lo_unbounded: bool, hi_unbounded: bool,
               rows_max_width: Optional[int] = None,
               group_starts=None, rows_offsets=None):
    """SUM/COUNT/AVG/MIN/MAX over the per-row frame [lo, hi] (row-space
    bounds already clamped to the partition; empty frame iff lo > hi).
    Prefix sums for the invertible aggregates; MIN/MAX by a forward
    segmented scan (prefix frames), a reverse one (suffix frames), a peer
    group's scan (RANGE CURRENT ROW .. CURRENT ROW, `group_starts`) or a
    doubling sparse table (bounded ROWS frames, `rows_max_width`)."""
    n = pstart.shape[0]
    dev = pstart.device
    ok = valid if valid is not None else torch.ones(n, dtype=torch.bool, device=dev)
    empty = lo > hi
    if rows_offsets is not None and kind in ("SUM", "AVG", "COUNT"):
        return _rows_frame_agg(vals, ok, pstart, rows_offsets, kind, acc_dtype, empty)
    loc = torch.clamp(lo, 0, n - 1)
    hic = torch.clamp(hi, 0, n - 1)
    pc = _prefix(ok.to(torch.int64))
    cnt = torch.where(empty, 0, pc[hic + 1] - pc[loc])
    if kind == "COUNT":
        return cnt, None
    acc = torch_dtype(acc_dtype)
    x = vals.to(acc)
    if kind in ("SUM", "AVG"):
        zero = torch.zeros((), dtype=acc, device=dev)
        pv = _prefix(torch.where(ok, x, zero))
        s = torch.where(empty, zero, pv[hic + 1] - pv[loc])
        if kind == "AVG":
            return s / torch.clamp(cnt, min=1), cnt > 0
        return s, cnt > 0
    if kind in ("MIN", "MAX"):
        ident, op = _minmax_ident(kind, acc_dtype)
        xm = torch.where(ok, x, torch.full((), ident, dtype=acc, device=dev))
        if lo_unbounded:
            out = _seg_running_op(xm, pstart, op)[hic]
        elif hi_unbounded:
            pend = _end_flags(pstart)
            run = _seg_running_op(xm.flip(0), pend.flip(0), op).flip(0)
            out = run[loc]
        elif group_starts is not None:
            # RANGE CURRENT ROW .. CURRENT ROW: the peer group's aggregate
            run = _seg_running_op(xm, group_starts, op)
            _, ge = segment_bounds(group_starts)
            out = run[ge]
        else:
            assert rows_max_width is not None
            out = _window_minmax_table(xm, loc, hic, rows_max_width, op, ident)
        return out, cnt > 0
    raise ValueError(kind)


def _rows_frame_agg(vals, ok, pstart, rows_offsets, kind, acc_dtype, empty):
    """SUM/AVG/COUNT over [i + lo_off, i + hi_off] clamped to the
    partition: a global inclusive cumsum, static shifts for in-range
    lookups, and partition-edge values by propagation."""
    lo_off, hi_off = rows_offsets
    n = pstart.shape[0]
    dev = pstart.device
    i = _iota(n, dev)
    ps, pe = segment_bounds(pstart)
    endf = _end_flags(pstart)

    def framed_sum(contrib):
        c = torch.cumsum(contrib, 0)
        # c just before the partition start (0 for the first partition)
        c_before = seg_propagate(pstart, _static_shift(c, 1, 0))
        c_end = seg_propagate(endf, c, reverse=True)
        # c[min(i + hi_off, pe)]
        c_hi = torch.where(i + hi_off <= pe, _static_shift(c, -hi_off, 0), c_end)
        # the low side clamps at ps -> c[ps - 1] = c_before
        c_lo = torch.where(i + lo_off >= ps, _static_shift(c, -(lo_off - 1), 0), c_before)
        return c_hi - c_lo

    cnt = torch.where(empty, 0, framed_sum(ok.to(torch.int64)))
    if kind == "COUNT":
        return cnt, None
    acc = torch_dtype(acc_dtype)
    zero = torch.zeros((), dtype=acc, device=dev)
    s = torch.where(empty, zero, framed_sum(torch.where(ok, vals.to(acc), zero)))
    if kind == "AVG":
        return s / torch.clamp(cnt, min=1), cnt > 0
    return s, cnt > 0


def frame_bounds(pstart, ostart, frame):
    """Row-space [lo, hi] per row for an explicit frame spec
    (unit, lo_bound, hi_bound).  RANGE bounds are peer-group based
    (UNBOUNDED/CURRENT only); ROWS bounds are row offsets.  Clamped to
    the partition; empty frames come out as lo > hi."""
    unit, b1, b2 = frame
    n = pstart.shape[0]
    i = _iota(n, pstart.device)
    ps, pe = segment_bounds(pstart)
    if unit == "ROWS":
        def bnd(b):
            if b[0] == "UP":
                return ps
            if b[0] == "UF":
                return pe
            if b[0] == "CR":
                return i
            return i - b[1] if b[0] == "P" else i + b[1]
        lo, hi = bnd(b1), bnd(b2)
    else:
        gs, ge = segment_bounds(pstart | ostart)
        lo = ps if b1[0] == "UP" else gs
        hi = pe if b2[0] == "UF" else ge
    return torch.maximum(lo, ps), torch.minimum(hi, pe)
