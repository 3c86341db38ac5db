"""Window functions: each function of heavydb_tpu_torch/ops/window.py
against the reference's heavydb_tpu/ops/window.py.

Seeded sorted-order inputs made with numpy: partition and peer starts, a
last partition of three rows closing the domain as pad rows do, float64
values with -0.0, subnormals, a NaN that is not NULL and 15 % NULL, and
integers.  The scans, ranks and navigation functions, the running, whole
partition and framed aggregates over every frame form (prefix, suffix,
peer group, bounded ROWS on the sparse table and on shifted prefixes, empty
frames) for each accumulator dtype, and the running MIN / MAX on both of
its forms.

Tolerances: exact, but DOUBLE sums and averages rtol 1e-9 (atol 1e-9): the
port sums in native float64 in another association order.  The
reference's XLA flushes subnormal floats to zero as they pass through its
operations, where the port moves them bit for bit, so subnormals compare
as 0.0 (`_flat`).
"""

import numpy as np
import pytest


# ---- ops/window.py against the reference's, function by function ---------
# Each reference side runs under one jax.jit a test case (eager JAX compiles
# every small operation of its scans apart, ~10 x the time).

N = 203  # a partition of 3 "pad" rows closes the domain
FRAMES = [("ROWS", ("UP",), ("CR",)), ("ROWS", ("CR",), ("UF",)),
          ("RANGE", ("CR",), ("CR",)), ("ROWS", ("P", 2), ("F", 3)),
          ("ROWS", ("F", 1), ("F", 2)), ("ROWS", ("P", 4), ("P", 2)),
          ("RANGE", ("UP",), ("UF",))]
OFFSETS = (3, 1, 0, -1, -2, N + 5)


@pytest.fixture(scope="module")
def seg():
    rng = np.random.default_rng(77)
    pstart = rng.random(N) < 0.08
    pstart[0] = True
    pstart[N - 3] = True  # the pad rows' own partition
    ostart = rng.random(N) < 0.4
    vals = rng.normal(0, 100, N)
    vals[rng.random(N) < 0.05] = -0.0
    vals[rng.random(N) < 0.03] = 5e-324
    vals[7] = np.nan  # a NaN that is not NULL (valid True)
    valid = rng.random(N) > 0.15
    ints = rng.integers(-1000, 1000, N)
    return dict(pstart=pstart, ostart=ostart, vals=vals, valid=valid, ints=ints)


def _ref(fn, *arrays):
    """fn(*arrays) of the reference's, under one jax.jit, as numpy."""
    import jax
    import jax.numpy as jnp

    out = jax.jit(fn)(*[jnp.asarray(a) for a in arrays])
    return jax.tree_util.tree_map(np.asarray, out)


def _port(fn, *arrays):
    import torch

    return fn(*[torch.as_tensor(np.asarray(a)) for a in arrays])


def _flat(x):
    """Floats with subnormals as 0.0: the reference's XLA flushes subnormal
    floats to zero as they pass through its operations (not always: a value
    it only moves may keep them); the port moves them bit for bit."""
    x = x.numpy() if hasattr(x, "numpy") else np.asarray(x)
    if x.dtype.kind == "f":
        x = np.where(np.abs(x) < np.finfo(x.dtype).tiny, 0.0, x).astype(x.dtype)
    return x


def _eq(got, want, tol=False):
    """got (the port's) equal to want (the reference's), or within tol."""
    got, want = _flat(got), _flat(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if tol:
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                                   rtol=1e-9, atol=1e-9)
    else:
        np.testing.assert_array_equal(got, want)


def _tv(got, want, tol=False, valid_only=True):
    """A (value, valid) pair against the reference's: validity exact,
    values where valid."""
    gv, gm = got
    wv, wm = want
    if wm is None:
        assert gm is None or bool(gm.all())
        _eq(gv, wv, tol)
        return
    gm = np.broadcast_to(gm.numpy(), np.shape(wv))
    wm = np.broadcast_to(np.asarray(wm), np.shape(wv))
    np.testing.assert_array_equal(gm, wm)
    m = wm if valid_only else np.ones_like(wm)
    _eq(gv.numpy()[m], np.asarray(wv)[m], tol)


def _scans(W, p, o, v, i):
    out = list(W.seg_propagate(p, v, i)) + list(W.seg_propagate(p, v, i, reverse=True))
    out += [W.seg_propagate(o, v), W.seg_propagate(o, v, reverse=True)]
    out += list(W.forward_fill_value(v, p))
    out += [W.partition_ids(p), W.row_number(p), W.rank(p, o), W.dense_rank(p, o)]
    out += list(W.segment_bounds(p | o))
    out += [W._next_start_idx(p), W.partition_counts(p), W.percent_rank(p, o),
            W.cume_dist(p, o)]
    return out + [W.ntile(p, nb) for nb in (1, 2, 3, 7, 50)]


def test_scans_and_ranks_match_reference(seg):
    from heavydb_tpu.ops import window as RW
    from heavydb_tpu_torch.ops import window as PW

    args = (seg["pstart"], seg["ostart"], seg["vals"], seg["ints"])
    got = _port(lambda *a: _scans(PW, *a), *args)
    want = _ref(lambda *a: _scans(RW, *a), *args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _eq(g, w)


def _navigation(W, v, ok, p, o):
    out = [W.nonnull_lookup(v, ok, p)]
    for off in OFFSETS:
        out += [W._static_shift(v, off, 0.0), W.shift_in_partition(v, ok, p, off),
                W.shift_in_partition(v, None, p, off, (-1.5, None))]
    return out + [W.first_value(v, ok, p), W.last_value_frame(v, ok, p, o)]


def test_navigation_matches_reference(seg):
    from heavydb_tpu.ops import window as RW
    from heavydb_tpu_torch.ops import window as PW

    args = (seg["vals"], seg["valid"], seg["pstart"], seg["ostart"])
    got = _port(lambda *a: _navigation(PW, *a), *args)
    want = _ref(lambda *a: _navigation(RW, *a), *args)
    for g, w in zip(got[0], want[0]):
        _eq(g, w)
    for j in range(len(OFFSETS)):
        _eq(got[1 + 3 * j], want[1 + 3 * j])
        _tv(got[2 + 3 * j], want[2 + 3 * j])
        _tv(got[3 + 3 * j], want[3 + 3 * j])
    for g, w in zip(got[-2:], want[-2:]):
        _tv(g, w, valid_only=False)


def _aggregates(W, v, ok, p, o, kind, acc):
    out = [W.running_agg(v, ok, p, o, kind, acc), W.whole_partition_agg(v, ok, p, kind, acc)]
    for frame in FRAMES:
        unit, b1, b2 = frame
        lo, hi = W.frame_bounds(p, o, frame)
        lo_unb, hi_unb = b1[0] == "UP", b2[0] == "UF"
        gs = rw = ro = None
        if not lo_unb and not hi_unb:
            if unit == "RANGE":
                gs = p | o
            else:
                lo_off = -b1[1] if b1[0] == "P" else (b1[1] if b1[0] == "F" else 0)
                hi_off = -b2[1] if b2[0] == "P" else (b2[1] if b2[0] == "F" else 0)
                rw, ro = max(hi_off - lo_off + 1, 1), (lo_off, hi_off)
        out += [(lo, hi), W.framed_agg(v, ok, p, lo, hi, kind, acc, lo_unb, hi_unb, rw, gs,
                                       rows_offsets=ro)]
    return out


@pytest.mark.parametrize("kind,dt", [
    ("SUM", "float64"), ("SUM", "float32"), ("SUM", "int64"), ("SUM", "int32"),
    ("AVG", "float64"), ("AVG", "int32"), ("COUNT", "float64"),
    ("MIN", "float64"), ("MIN", "float32"), ("MIN", "int64"), ("MIN", "int32"),
    ("MAX", "float64"), ("MAX", "float32"), ("MAX", "int64"), ("MAX", "int32"),
])
def test_aggregates_match_reference(seg, kind, dt):
    """running_agg, whole_partition_agg, frame_bounds and framed_agg (prefix,
    suffix, peer-group, bounded ROWS with the sparse table and the shifted
    prefixes, empty frames) against the reference's."""
    from heavydb_tpu.ops import window as RW
    from heavydb_tpu_torch.ops import window as PW

    v = (seg["vals"] if dt.startswith("float") else seg["ints"]).astype(dt)
    if kind in ("SUM", "AVG"):
        acc = np.dtype(np.float64) if dt.startswith("float") or kind == "AVG" \
            else np.dtype(np.int64)
    elif kind == "COUNT":
        acc = np.dtype(np.int64)
    else:
        acc = np.dtype(dt)
    tol = kind in ("SUM", "AVG") and acc.kind == "f"
    args = (v, seg["valid"], seg["pstart"], seg["ostart"])
    got = _port(lambda *a: _aggregates(PW, *a, kind, acc), *args)
    want = _ref(lambda *a: _aggregates(RW, *a, kind, acc), *args)
    _tv(got[0], want[0], tol)
    _tv(got[1], want[1], tol)
    for j in range(len(FRAMES)):
        _eq(got[2 + 2 * j][0], want[2 + 2 * j][0])
        _eq(got[2 + 2 * j][1], want[2 + 2 * j][1])
        _tv(got[3 + 2 * j], want[3 + 2 * j], tol)


def _minmax(W, x, p, lo, hi, dt):
    out = []
    for kind in ("MIN", "MAX"):
        ident, op = W._minmax_ident(kind, np.dtype(dt))
        out.append(W._seg_running_op(x, p, op))
        for width, (lw, hw) in zip((1, 2, 5, 8, 13), zip(lo, hi)):
            out.append(W._window_minmax_table(x, lw, hw, width, op, ident))
    return out


@pytest.mark.parametrize("dt", ["float64", "float32", "int64", "int32", "int16"])
def test_minmax_table_and_running_op_match_reference(seg, dt):
    """The sparse table at several widths, with floor(log2) in integers,
    and the running MIN / MAX with resets on both of its forms (<= 32-bit
    cummax, 64-bit doubling), NaN propagation included."""
    import torch

    from heavydb_tpu.ops import window as RW
    from heavydb_tpu_torch.ops import window as PW

    rng = np.random.default_rng(5)
    lo = rng.integers(0, N, (5, N)).astype(np.int32)
    hi = np.minimum(lo + rng.integers(-1, (1, 2, 5, 8, 13), (N, 5)).T, N - 1).astype(np.int32)
    x = (seg["vals"] if dt.startswith("float") else seg["ints"]).astype(dt)
    got = _port(lambda x_, p_, lo_, hi_: _minmax(PW, x_, p_, lo_.long(), hi_.long(), dt),
                x, seg["pstart"], lo, hi)
    want = _ref(lambda *a: _minmax(RW, *a, dt), x, seg["pstart"], lo, hi)
    for g, w in zip(got, want):
        _eq(g, w)
    length = torch.arange(1, 1 << 12)
    assert torch.equal(PW._floor_log2(length, 12),
                       torch.tensor([n.bit_length() - 1 for n in range(1, 1 << 12)]))
