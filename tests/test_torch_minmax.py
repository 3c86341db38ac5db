"""Kernel B3 (kernels/groupby_minmax.py, per-slot MIN or MAX over
257..4096 slots) on the CPU:

- its launch plan (csrc/groupby_minmax.cu on csrc/stream_agg.cuh: one
  256-thread block's copy of a u32 count and an int32 key a slot), worked
  out by hand as tests/test_torch_hist.py does for B2;
- the wrapper (its plain version here) against the JAX package's Pallas
  `minmax_per_slot` in interpret mode at 257, 1000 and 4096 slots;
- the contract at the edges the kernel's vector loads meet: a ragged row
  count, views that start one element into their storage, values one
  element off gid, NaN, +-inf, the int32 extremes, narrow integer values.

MIN and MAX are exact: every comparison is exact equality (NaN where the
other side has NaN).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heavydb_tpu.kernels import groupby_pallas as GP
from heavydb_tpu_torch.kernels import _build, groupby_minmax as GM

B3_SLOTS = (257, 1000, 4096)


@pytest.fixture(autouse=True)
def no_launches():
    assert GM.minmax_per_slot.launches == 0
    yield
    assert GM.minmax_per_slot.launches == 0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want, equal_nan=got.dtype.kind == "f")


def _np_minmax(gid, values, mask, num_slots, is_min):
    ok = (gid >= 0) & (gid < num_slots)
    if mask is not None:
        ok &= mask
    if values.dtype.kind == "f":
        ident = np.inf if is_min else -np.inf
    else:
        info = np.iinfo(values.dtype)
        ident = info.max if is_min else info.min
    out = np.full(num_slots, ident, values.dtype)
    # np.minimum / np.maximum propagate NaN, as the kernel's keys do
    (np.minimum if is_min else np.maximum).at(out, gid[ok], values[ok])
    return out


# (slots) -> shared bytes a block, by hand: a u32 count and an int32 key a
# slot, each array from an 8-byte boundary
PLAN_SMEM = {257: 1032 + 1032, 1000: 4000 + 4000, 4096: 16384 + 16384}


@pytest.mark.parametrize("num_slots", B3_SLOTS)
def test_plan_by_hand(num_slots):
    p = GM.plan(num_slots)
    assert (p.tier, p.cluster, p.threads) == ("shared", 1, 256)
    assert p.smem_bytes == PLAN_SMEM[num_slots]
    assert p.slots_per_block == num_slots
    # MIN and MAX keep the same 4-byte cells
    assert p.smem_bytes == _build.smem_bytes(num_slots, ["max"])


def test_plan_fits_four_blocks_at_every_slot_count():
    # the largest B3 launch: 4096 slots in 32 KB, so four 256-thread blocks
    # (1024 threads) share an SM's 228 KB
    assert GM.plan(GM.MAX_SLOTS).smem_bytes == 32 * 1024
    for s in range(1, GM.MAX_SLOTS + 1, 97):
        assert GM.plan(s).smem_bytes <= _build.SMEM_FOUR_BLOCKS


@pytest.mark.parametrize("num_slots", B3_SLOTS)
@pytest.mark.parametrize("kind", ["int32", "float32"])
@pytest.mark.parametrize("is_min", [True, False])
def test_matches_pallas_interpret_at_b3_slots(num_slots, kind, is_min):
    rng = np.random.default_rng(num_slots)
    n = 6000
    gid = rng.integers(-3, num_slots + 3, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    v = (rng.integers(-10**6, 10**6, n).astype(np.int32) if kind == "int32"
         else rng.standard_normal(n).astype(np.float32))
    j = GP.minmax_per_slot(jnp.asarray(gid), jnp.asarray(v), jnp.asarray(mask),
                           num_slots, is_min, interpret=True)
    got = GM.minmax_per_slot(_t(gid), _t(v), _t(mask), num_slots, is_min)
    _same(got.numpy(), np.asarray(j))


def _edge_rows(n, num_slots, seed):
    """Rows at the kernel's edges: out-of-range ids on both sides, a mask,
    float32 values with a NaN, +inf and -inf each in a slot of its own and
    int32 values with both extremes."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(-3, num_slots + 3, n + 4).astype(np.int32)
    mask = rng.random(n + 4) < 0.9
    f = rng.standard_normal(n + 4).astype(np.float32)
    i = rng.integers(-2**31, 2**31 - 1, n + 4).astype(np.int32)
    for r, (g, x) in {5: (1, np.nan), 9: (2, np.inf), 13: (3, -np.inf)}.items():
        gid[r], mask[r], f[r] = g, True, x
    i[20], i[21] = -2**31, 2**31 - 1
    return gid, mask, f, i


# (rows, value rows): n + 3 rows; views one element in; values one element
# off gid
VIEWS = {
    "n + 3 rows": (slice(0, -1), slice(0, -1)),
    "offset by one element": (slice(1, None), slice(1, None)),
    "values offset from gid": (slice(0, -1), slice(1, None)),
}


@pytest.mark.parametrize("view", VIEWS)
@pytest.mark.parametrize("is_min", [True, False])
def test_edges_match_numpy(view, is_min):
    S = 1000
    gid, mask, f, i = _edge_rows(3001, S, 5)
    rows, vrows = VIEWS[view]
    tg, tm = _t(gid)[rows], _t(mask)[rows]
    for v in (f, i):
        got = GM.minmax_per_slot(tg, _t(v)[vrows], tm, S, is_min)
        _same(got.numpy(), _np_minmax(gid[rows], v[vrows], mask[rows], S, is_min))
    if view != "values offset from gid":
        got = GM.minmax_per_slot(tg, _t(f)[vrows], tm, S, is_min).numpy()
        assert np.isnan(got[1])  # NaN wins both MIN and MAX
        assert got[3 if is_min else 2] == (-np.inf if is_min else np.inf)


@pytest.mark.parametrize("dtype", [np.bool_, np.int8, np.int16])
@pytest.mark.parametrize("is_min", [True, False])
def test_narrow_values_widen_and_come_back(dtype, is_min):
    rng = np.random.default_rng(3)
    n, S = 2000, 300
    # every slot reached: an unreached slot's int32 identity has no narrow
    # counterpart
    gid = rng.permutation(np.arange(n) % S).astype(np.int32)
    v = (rng.random(n) < 0.5 if dtype is np.bool_
         else rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max, n).astype(dtype))
    got = GM.minmax_per_slot(_t(gid), _t(v), None, S, is_min)
    assert got.dtype == _t(v).dtype
    want = _np_minmax(gid, v.astype(np.int32), None, S, is_min)
    assert np.array_equal(got.numpy().astype(np.int32), want)


def test_unreached_slots_keep_identity_and_bad_inputs_raise():
    gid = _t(np.array([0, 0, 2], np.int32))
    f = _t(np.array([1.5, -2.0, 3.0], np.float32))
    assert GM.minmax_per_slot(gid, f, None, 300, True)[1] == np.inf
    assert GM.minmax_per_slot(gid, f, None, 300, False)[1] == -np.inf
    i = _t(np.array([4, 5, 6], np.int32))
    assert GM.minmax_per_slot(gid, i, None, 300, True)[299] == 2**31 - 1
    assert GM.minmax_per_slot(gid, i, None, 300, False)[299] == -2**31
    with pytest.raises(ValueError):
        GM.minmax_per_slot(gid, f, None, GM.MAX_SLOTS + 1, True)
    with pytest.raises(ValueError):
        GM.minmax_per_slot(gid, _t(np.zeros(3, np.int64)), None, 300, True)
