"""The host-side design of B1 (kernels/lane_agg.py) and B2
(kernels/radix_hist.py) over csrc/stream_agg.cuh, on the CPU:

- the shared bytes of a block's cells (`_build.smem_bytes`, which the
  kernel checks against its own layout at launch), against counts worked
  out by hand;
- the tier each wrapper's `plan` picks for a slot count and stream set,
  its cluster size, its shared bytes a block against the 227 KB a block
  may opt in to on the H100, and which block of a cluster owns each slot;
- a torch model of the kernel's exact integer sum as two 32-bit words
  (the low word's carry added with the high word), row by row, against
  int64 sums that wrap mod 2^64.

Everything here is exact: integer arithmetic throughout.
"""

import numpy as np
import pytest
import torch

from heavydb_tpu_torch.kernels import _build, lane_agg, radix_hist

B2_OPS = ("count", "sumi", "sumf", "sumd")
B1_OPS = B2_OPS + ("min", "max")
STREAM_SETS = {
    "none": (),
    "four": B2_OPS,
    "sixteen": tuple(B2_OPS[k % 4] for k in range(16)),
}
# (slots, stream set) -> (tier, cluster, threads) of radix_hist.plan, worked
# out by hand from the cells' bytes a slot: 4 (none), 28 (four), 100
# (sixteen); 56 / 112 / 227 KB a block for four / two / one block an SM;
# clusters of 2 or 4 such blocks, then global atomics
B2_TIERS = {
    (2, "none"): ("shared", 1, 256), (2, "four"): ("shared", 1, 256),
    (2, "sixteen"): ("shared", 1, 256),
    (257, "sixteen"): ("shared", 1, 256),
    (1000, "four"): ("shared", 1, 256), (1000, "sixteen"): ("shared", 1, 512),
    (3000, "four"): ("shared", 1, 512),
    (5000, "four"): ("shared_sm", 1, 1024),
    (10000, "none"): ("shared", 1, 256), (10000, "four"): ("cluster", 2, 1024),
    (10000, "sixteen"): ("global", 1, 256), (3000, "sixteen"): ("cluster", 2, 1024),
    (24577, "none"): ("shared", 1, 512), (24577, "four"): ("cluster", 4, 1024),
    (24577, "sixteen"): ("global", 1, 256),
    (65536, "none"): ("cluster", 2, 1024), (65536, "four"): ("global", 1, 256),
    (65536, "sixteen"): ("global", 1, 256),
}
SLOTS = (2, 10, 32, 33, 256, 257, 1000, 3000, 5000, 10000, 24577, 65536)


# (slots, ops) -> shared bytes, by hand: u32 counts, SUMI / SUMD 8 bytes a
# cell and the others 4, each array from an 8-byte boundary
SMEM_CASES = {
    "1000 slots, four": (1000, B2_OPS, 4000 + 4000 + 8000 + 4000 + 8000),
    "257 slots, odd arrays": (257, ("count", "sumi", "min", "sumd"),
                              1032 + 1032 + 2056 + 1032 + 2056),
    "3 slots, counts only": (3, (), 16),
    "2560 slots, sixteen": (2560, STREAM_SETS["sixteen"], 10240 + 4 * 61440),
}


@pytest.mark.parametrize("case", list(SMEM_CASES))
def test_smem_bytes(case):
    slots, ops, want = SMEM_CASES[case]
    assert _build.smem_bytes(slots, ops) == want


def _check_ownership(plan, num_slots):
    """Every slot lies in exactly one block of the cluster (stream_agg.cuh:
    slot g in block g % C at cell g // C), at a cell below the block's slot
    count."""
    C = plan.cluster
    seen = set()
    for g in range(num_slots):
        rank, cell = g % C, g // C
        assert 0 <= rank < C and 0 <= cell < plan.slots_per_block
        assert (rank, cell) not in seen
        seen.add((rank, cell))
    assert len(seen) == num_slots


@pytest.mark.parametrize("set_name", list(STREAM_SETS))
@pytest.mark.parametrize("num_slots", SLOTS)
def test_b2_plan(num_slots, set_name):
    ops = STREAM_SETS[set_name]
    plan = radix_hist.plan(num_slots, ops)
    want = B2_TIERS.get((num_slots, set_name))
    if want is not None:
        assert (plan.tier, plan.cluster, plan.threads) == want
    if plan.tier == "global":
        # only where no cluster of radix_hist's largest size (4) holds the cells
        assert radix_hist.CLUSTER_SIZES[-1] == 4
        assert _build.smem_bytes(-(-num_slots // 4), ops) > _build.SMEM_BLOCK_MAX
        assert plan.smem_bytes == 0
        return
    assert plan.slots_per_block == -(-num_slots // plan.cluster)
    assert plan.smem_bytes == _build.smem_bytes(plan.slots_per_block, ops)
    assert plan.smem_bytes <= _build.SMEM_BLOCK_MAX == 227 * 1024
    if plan.tier == "cluster":
        assert plan.cluster in radix_hist.CLUSTER_SIZES
        assert _build.smem_bytes(num_slots, ops) > _build.SMEM_BLOCK_MAX
        # the smallest cluster that holds the cells
        smaller = [c for c in (1,) + radix_hist.CLUSTER_SIZES if c < plan.cluster]
        assert all(_build.smem_bytes(-(-num_slots // c), ops) > _build.SMEM_BLOCK_MAX
                   for c in smaller)
    else:
        assert plan.cluster == 1
        # blocks an SM the tier's threads give, within the SM's 228 KB
        per_sm = 1024 // plan.threads
        assert per_sm * (plan.smem_bytes + 1024) <= 228 * 1024
    _check_ownership(plan, num_slots)


@pytest.mark.parametrize("set_name", ["none", "four", "sixteen", "sixteen_b1"])
@pytest.mark.parametrize("num_slots", [s for s in SLOTS if s <= lane_agg.MAX_SLOTS] + [100])
def test_b1_plan(num_slots, set_name):
    ops = tuple(B1_OPS[k % 6] for k in range(16)) if set_name == "sixteen_b1" \
        else STREAM_SETS[set_name]
    plan = lane_agg.plan(num_slots, ops)
    assert (plan.tier, plan.cluster, plan.threads) == ("shared", 1, 256)
    # a copy of every slot's cells a block, four blocks an SM at any B1 shape
    assert plan.slots_per_block == num_slots
    assert plan.smem_bytes == _build.smem_bytes(num_slots, ops) <= _build.SMEM_FOUR_BLOCKS
    _check_ownership(plan, num_slots)


# ---------------------------------------------------------------------------
# exact integer sums as two 32-bit words
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def halves_sum(gid: torch.Tensor, x: torch.Tensor, num_slots: int) -> torch.Tensor:
    """A model of stream_agg.cuh sa_add_halves and its merge: each slot's
    cell is (lo, hi) u32; a row adds its low word to lo (the add returns
    the old lo), and its high word plus the carry out of lo to hi, each
    only when nonzero.  Returns hi << 32 | lo as int64."""
    lo = torch.zeros(num_slots, dtype=torch.int64)
    hi = torch.zeros(num_slots, dtype=torch.int64)
    for g, v in zip(gid.tolist(), x.to(torch.int64).tolist()):
        if not 0 <= g < num_slots:
            continue
        u = v & 0xFFFFFFFFFFFFFFFF
        add_lo, add_hi = u & M32, u >> 32
        if add_lo:
            old = int(lo[g])
            lo[g] = (old + add_lo) & M32
            add_hi = (add_hi + ((old + add_lo) >> 32)) & M32
        if add_hi:
            hi[g] = (int(hi[g]) + add_hi) & M32
    u64 = (hi << 32) | lo  # wraps into int64's sign bit as the kernel's u64
    return u64


def _int64_sums(gid, x, num_slots):
    ok = (gid >= 0) & (gid < num_slots)
    idx = torch.where(ok, gid.to(torch.int64), num_slots)
    out = torch.zeros(num_slots + 1, dtype=torch.int64)
    out.index_add_(0, idx, x.to(torch.int64))  # int64 adds wrap mod 2^64
    return out[:num_slots]


HALVES_CASES = {
    # dtype, low, high: values drawn uniformly in [low, high)
    "int8": (np.int8, -128, 128),
    "int16": (np.int16, -2**15, 2**15),
    "int32 past 2^32": (np.int32, 2**30, 2**31),
    "int32 negative": (np.int32, -2**31, -2**30),
    "int64 +-2^40": (np.int64, -2**40, 2**40),
    "int64 wrap past 2^63": (np.int64, 2**62, 2**63 - 1),
    "int64 full range": (np.int64, -2**63, 2**63 - 1),
}


@pytest.mark.parametrize("case", list(HALVES_CASES))
def test_halves_sum_is_exact(case):
    dtype, low, high = HALVES_CASES[case]
    rng = np.random.default_rng(len(case))
    n, S = 3000, 7
    gid = torch.from_numpy(rng.integers(-1, S + 1, n).astype(np.int32))
    x = torch.from_numpy(rng.integers(low, high, n, dtype=np.int64).astype(dtype))
    want = _int64_sums(gid, x, S)
    assert torch.equal(halves_sum(gid, x, S), want)
    # the case reaches what it names
    exact = [sum(int(v) for g, v in zip(gid.tolist(), x.tolist()) if g == s)
             for s in range(S)]
    if "past 2^32" in case:
        assert min(exact) > 2**32
    if "negative" in case:
        assert max(exact) < 0
    if "wrap" in case:
        assert min(exact) >= 2**63 and torch.equal(
            want, torch.tensor([(e + 2**63) % 2**64 - 2**63 for e in exact]))
