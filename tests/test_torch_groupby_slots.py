"""The port's per-slot kernels B3a-c (heavydb_tpu_torch/kernels/
groupby_slots.py) against the JAX package's Pallas kernels
(heavydb_tpu/kernels/groupby_pallas.py) run in interpret mode, on numpy
inputs made from a seed.  On the CPU each wrapper runs its plain PyTorch
version, so the launch counters must stay at 0.

Tolerances: counts and integer sums are exact.  Float32 sums use
rtol=1e-4, atol=1e-3: the reference adds in float32 per 1024-4096-row block
on the matrix unit, the port in float32 per CUDA block and in float64
across.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heavydb_tpu.kernels import groupby_pallas as GP
from heavydb_tpu_torch.kernels import groupby_slots as GS

F32_TOL = dict(rtol=1e-4, atol=1e-3)
SLOTS = [1, 129, 700, 4096]
WRAPPERS = (GS.count_per_slot, GS.sum_f32_per_slot, GS.sum_int_per_slot)


@pytest.fixture(autouse=True)
def no_launches():
    yield
    assert [w.launches for w in WRAPPERS] == [0, 0, 0]


def _rows(seed: int, n: int, num_slots: int):
    """gid with out-of-range ids on both sides, a row mask, float32 values
    and int32 values over the whole int32 range."""
    rng = np.random.default_rng(seed)
    return dict(
        gid=rng.integers(-3, num_slots + 3, n).astype(np.int32),
        mask=rng.random(n) < 0.9,
        f32=rng.standard_normal(n).astype(np.float32),
        i32=rng.integers(-2**31, 2**31 - 1, n, endpoint=True).astype(np.int32),
    )


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _np_sum(gid, mask, v, num_slots, dtype):
    ok = (gid >= 0) & (gid < num_slots)
    if mask is not None:
        ok &= mask
    out = np.zeros(num_slots, dtype)
    np.add.at(out, gid[ok], v[ok].astype(dtype))
    return out


def _check(kind, gid, v, mask, num_slots):
    """The port's wrapper against the Pallas kernel in interpret mode."""
    if kind == "count":
        want = GP.count_per_slot(_j(gid), _j(mask), num_slots, interpret=True)
        got = GS.count_per_slot(_t(gid), None if mask is None else _t(mask),
                                num_slots)
    else:
        ref = GP.sum_f32_per_slot if kind == "sum_f32" else GP.sum_int_per_slot
        want = ref(_j(gid), _j(v), _j(mask), num_slots, interpret=True)
        port = GS.sum_f32_per_slot if kind == "sum_f32" else GS.sum_int_per_slot
        got = port(_t(gid), _t(v), None if mask is None else _t(mask), num_slots)
    want = np.asarray(want)
    assert got.shape == (num_slots,)
    assert str(got.dtype)[6:] == str(want.dtype)
    if kind == "sum_f32":
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    else:
        assert np.array_equal(got.numpy(), want)
    return got.numpy()


# ---------------------------------------------------------------------------
# against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_slots", SLOTS)
@pytest.mark.parametrize("kind", ["count", "sum_f32", "sum_int"])
def test_matches_pallas_interpret(kind, num_slots):
    d = _rows(num_slots, 12_000, num_slots)
    v = {"count": None, "sum_f32": d["f32"], "sum_int": d["i32"]}[kind]
    got = _check(kind, d["gid"], v, d["mask"], num_slots)
    # and numpy: ids outside [0, S) and masked-out rows are dropped
    if kind == "count":
        want = _np_sum(d["gid"], d["mask"], np.ones_like(d["gid"]), num_slots,
                       np.int64)
        assert np.array_equal(got, want)
    elif kind == "sum_int":
        assert np.array_equal(got, _np_sum(d["gid"], d["mask"], v, num_slots,
                                           np.int64))


@pytest.mark.parametrize("kind", ["count", "sum_f32", "sum_int"])
def test_no_mask_matches_pallas_interpret(kind):
    d = _rows(11, 10_000, 700)
    v = {"count": None, "sum_f32": d["f32"], "sum_int": d["i32"]}[kind]
    _check(kind, d["gid"], v, None, 700)


def test_sum_int_wraps_wide_values_as_pallas():
    # each value adds its two's-complement int32: 2^31 + 5 -> -2^31 + 5,
    # 2^40 -> 0, -2^31 - 1 -> 2^31 - 1, int64 extremes -> their low words
    rng = np.random.default_rng(12)
    n = 10_000
    gid = rng.integers(-3, 132, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    v = rng.integers(-2**40, 2**40, n).astype(np.int64)
    v[:8] = [2**31 + 5, -2**31 - 1, 2**40, 2**32 - 1, 2**31, -2**31,
             np.iinfo(np.int64).max, np.iinfo(np.int64).min]
    gid[:8] = np.arange(8)
    mask[:8] = True
    got = _check("sum_int", gid, v, mask, 129)
    assert np.array_equal(got, _np_sum(gid, mask, v.astype(np.int32), 129,
                                       np.int64))
    small = GS.sum_int_per_slot(_t(np.array([0, 1, 2, 3, 1], np.int32)),
                                _t(np.array([2**31 + 5, -3, 7, 2**40, 1])),
                                None, 4)
    assert small.tolist() == [-2147483643, -2, 7, 0]


def test_sum_f32_keeps_non_finite_values_in_their_slot():
    # The reference sums with a one-hot product, so NaN * 0 and inf * 0
    # spread a valid row's NaN or inf to every slot; the port keeps each in
    # its own slot, as numpy does.  NaN in a masked-out or out-of-range row
    # reaches no slot.
    gid = np.array([0, 1, 2, 3, 1, 2, 4, 5, 5, 6, 0, -1, 9], np.int32)
    v = np.array([1, np.nan, 2, 3, 4, np.inf, -np.inf, np.inf, -np.inf, 5,
                  np.nan, np.nan, np.inf], np.float32)
    mask = np.ones(13, bool)
    mask[10] = False
    with np.errstate(invalid="ignore"):  # inf + -inf
        want = _np_sum(gid, mask, v, 8, np.float64).astype(np.float32)
    assert np.isnan(want[1]) and np.isnan(want[5]) and want[2] == np.inf
    assert want[0] == 1 and want[3] == 3 and want[4] == -np.inf
    for fn in (GS.sum_f32_per_slot, GS.sum_f32_per_slot_plain):
        got = fn(_t(gid), _t(v), _t(mask), 8).numpy()
        np.testing.assert_array_equal(got, want)
    ref = np.asarray(GP.sum_f32_per_slot(_j(gid), _j(v), _j(mask), 8,
                                         interpret=True))
    assert np.isnan(ref).all()


@pytest.mark.parametrize("gid_dtype", [np.int64, np.int16, np.uint8])
def test_gid_and_value_dtypes_cast_as_pallas(gid_dtype):
    # gid casts to int32 (int64 ids past 2^32 wrap); narrow integer and
    # bool values widen; float64 values round to float32
    rng = np.random.default_rng(13)
    n = 6_000
    gid = rng.integers(0, 129, n).astype(gid_dtype)
    if gid_dtype == np.int64:
        gid[::7] += 2**32
    mask = rng.random(n) < 0.8
    _check("count", gid, None, mask, 129)
    _check("sum_int", gid, rng.integers(-2**15, 2**15, n).astype(np.int16),
           mask, 129)
    _check("sum_int", gid, rng.random(n) < 0.5, mask, 129)
    _check("sum_f32", gid, rng.standard_normal(n), mask, 129)


# ---------------------------------------------------------------------------
# edges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_slots", [1, 4096, 12288, 12289, 24577, 65536])
def test_plain_versions_match_numpy(num_slots):
    # the kernels' shared-memory and global paths split at 12288 (B3c) and
    # 24576 (B3a, B3b) slots; the plain versions have no split
    d = _rows(num_slots + 7, 20_000, num_slots)
    g, m = _t(d["gid"]), _t(d["mask"])
    ones = np.ones_like(d["gid"])
    assert np.array_equal(GS.count_per_slot(g, m, num_slots).numpy(),
                          _np_sum(d["gid"], d["mask"], ones, num_slots, np.int64))
    np.testing.assert_allclose(
        GS.sum_f32_per_slot(g, _t(d["f32"]), m, num_slots).numpy(),
        _np_sum(d["gid"], d["mask"], d["f32"], num_slots, np.float64), **F32_TOL)
    assert np.array_equal(
        GS.sum_int_per_slot(g, _t(d["i32"]), m, num_slots).numpy(),
        _np_sum(d["gid"], d["mask"], d["i32"], num_slots, np.int64))


def test_empty_input():
    g = torch.zeros(0, dtype=torch.int32)
    m = torch.zeros(0, dtype=torch.bool)
    for mask in (m, None):
        c = GS.count_per_slot(g, mask, 5)
        f = GS.sum_f32_per_slot(g, torch.zeros(0), mask, 5)
        i = GS.sum_int_per_slot(g, torch.zeros(0, dtype=torch.int64), mask, 5)
        assert c.dtype == torch.int64 and c.tolist() == [0] * 5
        assert f.dtype == torch.float32 and f.tolist() == [0.0] * 5
        assert i.dtype == torch.int64 and i.tolist() == [0] * 5


def test_wrappers_reject_bad_arguments():
    g = torch.zeros(4, dtype=torch.int32)
    v = torch.zeros(4)
    for num_slots in (0, GS.MAX_SLOTS + 1):
        with pytest.raises(ValueError):
            GS.count_per_slot(g, None, num_slots)
        with pytest.raises(ValueError):
            GS.sum_f32_per_slot(g, v, None, num_slots)
        with pytest.raises(ValueError):
            GS.sum_int_per_slot(g, g, None, num_slots)
    with pytest.raises(ValueError):
        GS.count_per_slot(v, None, 3)  # float slot ids
    with pytest.raises(ValueError):
        GS.sum_int_per_slot(g, v, None, 3)  # float values
    with pytest.raises(ValueError):
        GS.launch("sum_f32", g, g, None, 3)  # int values to the float kernel
    with pytest.raises(ValueError):
        GS.launch("sum_int", g, v, None, 3)


# ---------------------------------------------------------------------------
# ragged and misaligned rows (the kernel's vector path starts at gid's first
# 16-byte boundary and leaves a scalar head and tail)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [4097, 12_003, 1, 6])
@pytest.mark.parametrize("kind", ["count", "sum_f32", "sum_int"])
def test_ragged_rows_match_pallas_interpret(kind, n):
    d = _rows(n + 31, n, 700)
    v = {"count": None, "sum_f32": d["f32"], "sum_int": d["i32"]}[kind]
    _check(kind, d["gid"], v, d["mask"], 700)


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("kind", ["count", "sum_f32", "sum_int", "sum_int64"])
def test_offset_views_match_pallas_interpret(kind, offset):
    # gid, mask and values are views that start `offset` elements into
    # their storage (contiguous, but not 16-byte aligned)
    n = 9_001
    d = _rows(40 + offset, n + offset, 129)
    v = {"count": None, "sum_f32": d["f32"], "sum_int": d["i32"],
         "sum_int64": d["i32"].astype(np.int64) * 3 + 2**33}[kind]
    kind = kind.replace("64", "")
    sl = slice(offset, None)
    g, m = _t(d["gid"])[sl], _t(d["mask"])[sl]
    assert g.storage_offset() == offset and g.is_contiguous()
    if kind == "count":
        got = GS.count_per_slot(g, m, 129)
        want = GP.count_per_slot(_j(d["gid"][sl]), _j(d["mask"][sl]), 129,
                                 interpret=True)
    else:
        port = GS.sum_f32_per_slot if kind == "sum_f32" else GS.sum_int_per_slot
        ref = GP.sum_f32_per_slot if kind == "sum_f32" else GP.sum_int_per_slot
        got = port(g, _t(v)[sl], m, 129)
        want = ref(_j(d["gid"][sl]), _j(v[sl]), _j(d["mask"][sl]), 129,
                   interpret=True)
    want = np.asarray(want)
    if kind == "sum_f32":
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    else:
        assert np.array_equal(got.numpy(), want)
