"""A model of B5's two-level radix partition (heavydb_tpu_torch/kernels/
csrc/radix_groupby.cu `part_hist_kernel`, `part_l1_kernel`,
`part_l2_kernel`) on the CPU, against the plain version
`radix_partition_plain` and the JAX package's reference.

The CUDA code cannot run here, so its schedule is modelled with the
kernels' own mapping:

- the histogram counts all 2^pbits final partitions; `offsets` is their
  exclusive scan, and level-1 bucket b1 spans
  [offsets[b1 << p2], offsets[(b1 + 1) << p2]);
- `level_bits(pbits)` splits the bits: level 1 buckets a tile's valid rows
  by the top p1 bits and reserves one range a bucket at cursor[b1 << p2]
  (starting at offsets[b1 << p2]), into a scratch copy; level 2 buckets
  each region's tiles by the low p2 bits, at cursor[partition] (starting
  at offsets), into the final arrays.  With p2 = 0 level 1 writes the
  final arrays;
- a tile of T rows ranks its valid rows by bucket: a histogram, its
  exclusive scan, a rank a row.  The kernel ranks rows inside a bucket by
  shared-memory atomics and its tiles reserve in any order, so the model
  draws both from a seeded generator;
- level 2's tiles: region r holds ceil(len_r / T) tiles from the
  exclusive scan of those counts; tile t belongs to the last region whose
  first tile is <= t, so no tile straddles two regions.

Everything is exact: counts, offsets, and each partition's set of rows.
"""

import numpy as np
import pytest
import torch

from heavydb_tpu.kernels import radix_groupby as JRG
from heavydb_tpu_torch.kernels import _build, radix_groupby as RG


def _hash(gid):
    return (gid.long() * RG._MULT) & 0xFFFFFFFF


def _part(h, pbits):
    return (h >> (32 - pbits)) if pbits else torch.zeros_like(h)


def l2_tiles(offsets, counts, p1, p2, T):
    """Level 2's tile list: (region, first row, rows) of every tile."""
    nv = offsets[-1] + counts[-1]
    r0 = offsets[::1 << p2]
    assert r0.shape[0] == 1 << p1
    r1 = torch.cat([r0[1:], nv.view(1)])
    nt = (r1 - r0 + T - 1) // T
    t0 = torch.cumsum(nt, 0) - nt
    t = torch.arange(int(nt.sum()))
    reg = torch.searchsorted(t0, t, right=True) - 1
    start = r0[reg] + (t - t0[reg]) * T
    rows = torch.clamp(r1[reg] - start, max=T)
    return reg, start, rows


def _level(tiles, h_all, valid, cols, outs, pbits, lo, nb, cshift, cursor, gen):
    """One level over `tiles` [(first row, rows, cbase)] in the order given:
    each tile ranks its valid rows by bucket (part >> lo) & (nb - 1) and
    writes each column's rows at the ranges it reserves."""
    for r0, rows, cbase in tiles:
        sl = slice(r0, r0 + rows)
        ok = valid[sl]
        loc = (_part(h_all[sl][ok], pbits) >> lo) & (nb - 1)
        m = loc.shape[0]
        hist = torch.bincount(loc, minlength=nb)
        base = torch.cumsum(hist, 0) - hist
        # bucket-major; the order inside a bucket as the atomics give it
        order = torch.argsort(loc * m + torch.randperm(m, generator=gen))
        pos = torch.empty_like(loc)
        pos[order] = torch.arange(m)
        adj = torch.zeros(nb, dtype=torch.int64)
        for b in torch.nonzero(hist).flatten().tolist():
            c = cbase + (b << cshift)
            adj[b] = cursor[c] - base[b]
            cursor[c] += hist[b]
        dst = adj[loc] + pos
        for src, out in zip(cols, outs):
            out[dst] = src[sl][ok]


def two_level_model(gid, streams, num_slots, pbits, T, seed=0):
    """B5's schedule on the CPU: (hb, parts, counts, offsets) as
    `radix_partition` returns them, cut to the valid rows."""
    gen = torch.Generator().manual_seed(seed)
    n = gid.shape[0]
    valid = (gid >= 0) & (gid < num_slots)
    h = _hash(gid)
    counts = torch.bincount(_part(h[valid], pbits), minlength=1 << pbits)
    offsets = torch.cumsum(counts, 0) - counts
    nv = int(counts.sum())
    p1, p2 = RG.level_bits(pbits)
    cols = [(h ^ 0x80000000).to(torch.int32)] + [v for v, _ in streams]
    final = [torch.full_like(c, -1) for c in cols]
    first = final if p2 == 0 else [torch.full_like(c, -1) for c in cols]
    tiles = [(t * T, min(T, n - t * T), 0) for t in range(-(-n // T))]
    tiles = [tiles[i] for i in torch.randperm(len(tiles), generator=gen)]
    _level(tiles, h, valid, cols, first, pbits, p2, 1 << p1, p2,
           offsets.clone(), gen)
    if p2:
        s_h = (first[0].long() & 0xFFFFFFFF) ^ 0x80000000
        reg, start, rows = l2_tiles(offsets, counts, p1, p2, T)
        tiles = [(int(s), int(r), int(g) << p2) for g, s, r in zip(reg, start, rows)]
        tiles = [tiles[i] for i in torch.randperm(len(tiles), generator=gen)]
        _level(tiles, s_h, torch.ones(n, dtype=torch.bool), first, final,
               pbits, 0, 1 << p2, 0, offsets.clone(), gen)
    return final[0][:nv], [c[:nv] for c in final[1:]], counts, offsets


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pbits,want", [
    (0, (0, 0)), (3, (3, 0)), (8, (8, 0)), (9, (5, 4)), (12, (6, 6)),
    (15, (8, 7))])
def test_level_bits(pbits, want):
    p1, p2 = RG.level_bits(pbits)
    assert (p1, p2) == want
    assert p1 + p2 == pbits and max(p1, p2) <= RG.LEVEL_BITS
    if 9 <= pbits <= 12:
        # the reference's _plan splits its 2^pt partitions the same way
        # (2^(pt - 1) input tiles of 32768 rows give pt bits)
        assert JRG._plan(1 << (pbits - 1))[:2] == want


def _inputs(seed, n, num_slots, hot=0.0, bad=False):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, num_slots, n).astype(np.int32)
    if hot:
        gid[rng.random(n) < hot] = num_slots // 3
    if bad:
        gid[rng.random(n) < 0.05] = -1
        gid[rng.random(n) < 0.05] = num_slots + 2
        gid[rng.random(n) < 0.02] = np.iinfo(np.int32).min
    gid = torch.from_numpy(gid)
    # the row id names each output row's origin; one stream of each width
    streams = [(torch.arange(n, dtype=torch.int32), "sumi"),
               (torch.from_numpy(rng.random(n) < 0.7), "count"),
               (torch.from_numpy(rng.standard_normal(n)), "sumd"),
               (torch.from_numpy(rng.integers(-99, 99, n).astype(np.int16)), "sumi")]
    return gid, streams


def _by_partition(hb, parts, counts):
    """Rows sorted by (partition, origin row): one partition's rows are a
    set, so both sides compare in this order."""
    region = torch.repeat_interleave(torch.arange(counts.shape[0]), counts)
    order = torch.argsort(region * (1 << 32) + parts[0].long())
    return [hb[order]] + [p[order] for p in parts]


CASES = {
    "uniform, two levels": dict(seed=0, n=5000, num_slots=1 << 16, pbits=9, T=64),
    "2^15 partitions": dict(seed=1, n=20_000, num_slots=1 << 20, pbits=15, T=256),
    "hot key 60 %": dict(seed=2, n=6000, num_slots=1 << 14, pbits=12, T=128, hot=0.6),
    "empty regions": dict(seed=3, n=4000, num_slots=50, pbits=10, T=64),
    "n not a multiple of T": dict(seed=4, n=5037, num_slots=1 << 12, pbits=11, T=64),
    "masked and out-of-range gid": dict(seed=5, n=5000, num_slots=3000, pbits=12,
                                        T=100, bad=True),
    "one level": dict(seed=6, n=3000, num_slots=1 << 12, pbits=6, T=64, bad=True),
    "no partition bits": dict(seed=7, n=700, num_slots=100, pbits=0, T=64, bad=True),
    "the kernel's tile": dict(seed=8, n=3 * RG.PART_TILE + 5, num_slots=1 << 18,
                              pbits=13, T=RG.PART_TILE, hot=0.3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_two_level_model_matches_plain(case):
    c = dict(CASES[case])
    pbits, T = c.pop("pbits"), c.pop("T")
    num_slots = c["num_slots"]
    gid, streams = _inputs(**c)
    hb, parts, counts, offsets = two_level_model(gid, streams, num_slots, pbits, T)
    phb, pparts, pcounts, poffsets = RG.radix_partition_plain(
        gid, streams, num_slots, pbits)
    assert torch.equal(counts, pcounts) and torch.equal(offsets, poffsets)
    # every valid row exactly once (no output row left at the fill -1)
    valid = (gid >= 0) & (gid < num_slots)
    assert torch.equal(torch.sort(parts[0].long()).values,
                       torch.nonzero(valid).flatten())
    for a, b in zip(_by_partition(hb, parts, counts),
                    _by_partition(phb, pparts, pcounts)):
        assert torch.equal(a, b)
    # each row sits in the partition of its top hash bits, with its own hb
    h = _hash(gid[parts[0].long()])
    region = torch.repeat_interleave(torch.arange(1 << pbits), counts)
    assert torch.equal(_part(h, pbits), region)
    assert torch.equal(hb, (h ^ 0x80000000).to(torch.int32))


def test_model_groups_match_the_reference():
    # the model's partitions, grouped by hb inside each, give the
    # reference specification's groups in its (hash) order
    gid, _ = _inputs(9, 6000, 1 << 13, bad=True)
    hb, _, counts, _ = two_level_model(gid, [], 1 << 13, 10, 64)
    keys, lens = [], []
    for p, (o, c) in enumerate(zip((torch.cumsum(counts, 0) - counts).tolist(),
                                   counts.tolist())):
        k, n = torch.unique(hb[o:o + c], return_counts=True)
        keys.append(k)
        lens.append(n)
    keys, lens = torch.cat(keys), torch.cat(lens)
    rg, rln, _, rng_, _ = JRG._ref_sparse_groupby(gid.numpy(), [], 1 << 13, (),
                                                  1 << 13)
    m = int(rng_)
    assert keys.shape[0] == m
    h = (keys.long() & 0xFFFFFFFF) ^ 0x80000000
    assert np.array_equal(((h * RG._INV) & 0xFFFFFFFF).to(torch.int32).numpy(),
                          rg[:m])
    assert np.array_equal(lens.numpy(), rln[:m])


@pytest.mark.parametrize("shape", ["uniform", "hot region", "empty regions",
                                   "one row"])
@pytest.mark.parametrize("T", [64, RG.PART_TILE])
def test_l2_tile_map(shape, T):
    p1, p2 = 5, 4
    P = 1 << (p1 + p2)
    gen = torch.Generator().manual_seed(len(shape) + T)
    if shape == "uniform":
        counts = torch.randint(0, 3 * T // 16 + 2, (P,), generator=gen)
    elif shape == "hot region":
        counts = torch.randint(0, 40, (P,), generator=gen)
        counts[37] = 20 * T + 11  # region 2 holds most rows
    elif shape == "empty regions":
        counts = torch.randint(0, 3 * T, (P,), generator=gen)
        counts[torch.rand(P, generator=gen) < 0.7] = 0
        counts[: 3 << p2] = 0  # the first regions, and the last one, empty
        counts[-(1 << p2):] = 0
    else:
        counts = torch.zeros(P, dtype=torch.int64)
        counts[200] = 1
    offsets = torch.cumsum(counts, 0) - counts
    nv = int(counts.sum())
    reg, start, rows = l2_tiles(offsets, counts, p1, p2, T)
    assert bool((rows >= 1).all()) and bool((rows <= T).all())
    # every row in exactly one tile
    cover = torch.zeros(nv, dtype=torch.int64)
    for s, r in zip(start.tolist(), rows.tolist()):
        cover[s:s + r] += 1
    assert bool((cover == 1).all())
    # no tile straddles two regions; each region has ceil(len / T) tiles
    r0 = offsets[::1 << p2]
    r1 = torch.cat([r0[1:], torch.tensor([nv])])
    assert bool((start >= r0[reg]).all()) and bool((start + rows <= r1[reg]).all())
    assert torch.equal(torch.bincount(reg, minlength=1 << p1),
                       (r1 - r0 + T - 1) // T)


@pytest.mark.parametrize("op,dtype", [
    (op, dt) for op, dts in _build._ALLOWED.items() for dt in dts])
def test_scratch_below_b6_stage(op, dtype):
    # B5's scratch (hb and the stream, 4 + value bytes a row) is freed
    # before B6's stage (hb, the int64 length and the record: 12 + record
    # bytes a row) is allocated; for every stream class the stage is the
    # larger, so the scratch never sets the radix tier's peak memory
    v = torch.empty(0, dtype=getattr(torch, dtype))
    rec = torch.empty(0, dtype=RG.record_dtype(v, op))
    assert 4 + v.element_size() < 12 + rec.element_size()
