"""Models of the redesigned B4 / B6 kernels (heavydb_tpu_torch/kernels/
csrc/tile_sort.cuh, radix_groupby.cu) on the CPU, and B6's launch split
(kernels/radix_groupby.py `group_launch`) against the JAX package's
specification `_ref_sparse_groupby`.

The CUDA code cannot run here, so its schedules are modelled with the same
mapping the kernels use:

- `block_sort`: thread t holds positions t*E .. t*E + E - 1 of the
  bitonic network in registers; strides j < E compare in registers,
  E <= j < 32E between lanes (lane ^ j/E), j >= 32E in a shared buffer
  padded by one word after every E, then loaded back.  Words are
  (key << 32) | index, so the result must equal a stable `torch.sort`
  exactly.
- `warp_add`: a warp whose lanes all carry one rank folds them into one
  shared-memory atomic; any other warp adds one atomic a lane.

Everything is exact: keys, indices, sums of integers.
"""

import numpy as np
import pytest
import torch

from heavydb_tpu.kernels import radix_groupby as JRG
from heavydb_tpu_torch.kernels import gate, radix_groupby as RG, tile_sort

I64_MAX = torch.iinfo(torch.int64).max  # the kernels' ~0ull padding word
RG_SENT = 0x7FFFFFFF
E = 16  # keys a thread holds: tile_sort.cu TS_E, radix_groupby.cu RG_E


# ---------------------------------------------------------------------------
# block_sort
# ---------------------------------------------------------------------------


def _pad(p, E):
    return p + p // E  # tile_sort.cuh bsort_pad


def block_sort_model(v, n2, E, trace=None):
    """tile_sort.cuh block_sort on v [threads, E] (thread t holds positions
    t*E + e); returns the registers afterwards.  trace gets (k, j, where)
    for every stride, in order."""
    v = v.clone()
    threads = v.shape[0]
    assert threads % 32 == 0 and n2 <= threads * E and n2 & (n2 - 1) == 0
    t = torch.arange(threads)
    base = t * E
    lane = t % 32
    wspan = 32 * E
    live = (t // 32) * wspan < n2

    def regs(k):
        j = E // 2
        while j >= 1:
            if j < k:
                for e in range(E):
                    if e & j:
                        continue
                    asc = ((base + e) & k) == 0
                    a, b = v[:, e].clone(), v[:, e | j].clone()
                    swap = torch.where(asc, a > b, a < b) & live
                    v[:, e] = torch.where(swap, b, a)
                    v[:, e | j] = torch.where(swap, a, b)
                if trace is not None:
                    trace.append((k, j, "registers"))
            j //= 2

    def warp(k, j_hi):
        nonlocal v
        asc = (base & k) == 0
        j = j_hi
        while j >= E:
            m = j // E
            assert m < 32  # the partner stays in the warp
            keep_min = ((lane & m) == 0) == asc
            w = v[t ^ m]
            new = torch.where(keep_min[:, None], torch.minimum(v, w),
                              torch.maximum(v, w))
            v = torch.where(live[:, None], new, v)
            if trace is not None:
                trace.append((k, j, "shuffle"))
            j //= 2

    k = 2
    while k <= min(n2, wspan):
        warp(k, k // 2)
        regs(k)
        k *= 2
    if n2 <= wspan:
        return v
    pos = base[:, None] + torch.arange(E)[None, :]
    buf = torch.full((_pad(n2, E),), -12345, dtype=torch.int64)
    k = 2 * wspan
    while k <= n2:
        buf[_pad(pos[live], E)] = v[live]
        j = k // 2
        while j >= wspan:
            q = torch.arange(n2 // 2)
            lo = ((q & ~(j - 1)) << 1) | (q & (j - 1))
            pa, pb = _pad(lo, E), _pad(lo + j, E)
            a, b = buf[pa].clone(), buf[pb].clone()
            swap = torch.where((lo & k) == 0, a > b, a < b)
            buf[pa] = torch.where(swap, b, a)
            buf[pb] = torch.where(swap, a, b)
            if trace is not None:
                trace.append((k, j, "shared"))
            j //= 2
        v[live] = buf[_pad(pos[live], E)]
        warp(k, wspan // 2)
        regs(k)
        k *= 2
    return v


def _words(keys, n_slots):
    """(key << 32) | index as the kernels pack them (signed here: the
    kernels bias the key and compare unsigned, the same order), padded
    with the ~0ull word past the keys."""
    w = torch.full((n_slots,), I64_MAX, dtype=torch.int64)
    n = keys.shape[0]
    w[:n] = (keys.to(torch.int64) << 32) | torch.arange(n)
    return w


def _tile_keys(T, seed, kind="mixed"):
    if kind == "descending":
        return torch.arange(T, dtype=torch.int32).flip(0) * 7919 - 2**30
    if kind == "constant":
        return torch.full((T,), -5, dtype=torch.int32)
    rng = np.random.default_rng(seed)
    k = rng.integers(-40, 40, T).astype(np.int64)           # many duplicates
    pick = rng.random(T)
    k[pick < 0.1] = np.iinfo(np.int32).max
    k[(pick >= 0.1) & (pick < 0.2)] = np.iinfo(np.int32).min
    k[(pick >= 0.2) & (pick < 0.25)] = RG_SENT - 1
    wide = (pick >= 0.25) & (pick < 0.6)
    k[wide] = rng.integers(-2**31, 2**31, int(wide.sum()))
    return torch.from_numpy(k.astype(np.int32))


def _b4_threads(T):
    """Threads of tile_sort.cu's block for a tile of T keys."""
    return max(32, T // E)


@pytest.mark.parametrize("kind", ["mixed", "descending"])
@pytest.mark.parametrize("T", [32, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
                               16384])
def test_block_sort_model_matches_torch_sort(T, kind):
    threads = _b4_threads(T)
    keys = _tile_keys(T, T + E, kind)
    out = block_sort_model(_words(keys, threads * E).view(threads, E), T, E)
    flat = out.reshape(-1)[:T]
    want = torch.sort(keys, stable=True)
    assert torch.equal((flat >> 32).to(torch.int32), want.values)
    assert torch.equal(flat & 0xFFFFFFFF, want.indices)


@pytest.mark.parametrize("kind", ["mixed", "constant"])
@pytest.mark.parametrize("T", [32, 256, 1024, 4096, 16384])
def test_block_sort_model_sorts_bare_keys(T, kind):
    """B4 with no payload sorts the int32 keys themselves: equal keys are
    indistinguishable, and padding past the tile never mixes in."""
    threads = _b4_threads(T)
    keys = _tile_keys(T, 2 * T + E, kind)
    v = torch.full((threads * E,), torch.iinfo(torch.int32).max, dtype=torch.int64)
    v[:T] = keys.to(torch.int64)
    out = block_sort_model(v.view(threads, E), T, E).reshape(-1)[:T]
    assert torch.equal(out.to(torch.int32), torch.sort(keys).values)


@pytest.mark.parametrize("ng", [1, 2, 5, 31, 32, 33, 300, 512, 513, 2500, 4096,
                                4097, 8192])
def test_block_sort_model_sorts_b6_groups(ng):
    """B6 sorts ng distinct (key, slot) words padded to a power of two n2
    in a block of 256 threads (partitions of <= 4096 rows) or 512."""
    rng = np.random.default_rng(ng)
    threads = 256 if ng <= 4096 else 512
    n2 = 1
    while n2 < ng:
        n2 *= 2
    keys = torch.from_numpy(rng.choice(
        np.arange(-2**31, 2**31 - 1, 7919, dtype=np.int64), ng,
        replace=False).astype(np.int32))
    slots = torch.from_numpy(rng.permutation(2 * 8192)[:ng])
    w = torch.full((threads * E,), I64_MAX, dtype=torch.int64)
    w[:ng] = (keys.to(torch.int64) << 32) | slots
    out = block_sort_model(w.view(threads, E), n2, E).reshape(-1)
    want = torch.sort(keys)
    assert torch.equal((out[:ng] >> 32).to(torch.int32), want.values)
    assert torch.equal(out[:ng] & 0xFFFFFFFF, slots[want.indices])
    assert torch.all(out[ng:n2] == I64_MAX)


@pytest.mark.parametrize("n2", [2, 32, 64, 256, 512, 1024, 2048, 4096, 8192,
                                16384])
def test_block_sort_schedule_is_the_bitonic_network(n2):
    """Every (stage k, stride j) of the bitonic network once, in order,
    each where the stride split puts it."""
    threads = _b4_threads(n2)
    trace = []
    block_sort_model(_words(_tile_keys(n2, 1), threads * E).view(threads, E),
                     n2, E, trace)
    want = []
    k = 2
    while k <= n2:
        j = k // 2
        while j >= 1:
            where = ("registers" if j < E else "shuffle" if j < 32 * E
                     else "shared")
            want.append((k, j, where))
            j //= 2
        k *= 2
    assert trace == want


def test_block_sort_barriers_at_4096_keys():
    # strides through shared memory (one barrier each) per 4096-key tile:
    # 28 in the first design, 6 at 16 keys a thread
    trace = []
    block_sort_model(_words(_tile_keys(4096, 2), 4096).view(-1, E), 4096, E,
                     trace)
    assert sum(w == "shared" for _, _, w in trace) == 6


@pytest.mark.parametrize("n_payloads", range(5))
def test_sort_tiles_on_the_cpu_takes_the_plain_version(n_payloads):
    key = _tile_keys(256, n_payloads)
    pays = [torch.arange(256, dtype=torch.int32) * (j + 1)
            for j in range(n_payloads)]
    got = tile_sort.sort_tiles(key, pays, 64)
    want = tile_sort.sort_tiles_plain(key, pays, 64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(got) == 1 + n_payloads
    assert tile_sort.sort_tiles.launches == 0


# ---------------------------------------------------------------------------
# warp_add
# ---------------------------------------------------------------------------


def warp_add_model(ranks, x):
    """radix_groupby.cu warp_add on one warp (rank -1 on the lanes past
    the partition's rows): the (rank, value) of each atomic it issues."""
    ok = [r >= 0 for r in ranks]
    if all(r == ranks[0] for r in ranks):
        return [(ranks[0], sum(x))] if ok[0] else []
    return [(r, xi) for r, xi, o in zip(ranks, x, ok) if o]


@pytest.mark.parametrize("case", ["distinct", "one", "few", "tail", "random",
                                  "one with a tail", "past the rows"])
def test_warp_add_model_adds_each_rank_once(case):
    rng = np.random.default_rng(len(case))
    lane = np.arange(32)
    ranks = {"distinct": lane, "one": np.zeros(32, int),
             "few": rng.integers(0, 3, 32),
             "tail": np.where(lane < 19, rng.integers(0, 4, 32), -1),
             "random": rng.integers(0, 12, 32),
             "one with a tail": np.where(lane < 19, 3, -1),
             "past the rows": np.full(32, -1)}[case].tolist()
    x = rng.integers(-1000, 1000, 32).tolist()
    atomics = warp_add_model(ranks, x)
    got = {}
    for r, v in atomics:
        got[r] = got.get(r, 0) + v
    want = {}
    for r, v in zip(ranks, x):
        if r >= 0:
            want[r] = want.get(r, 0) + v
    assert got == want
    # a hot warp (every lane one rank) costs one atomic
    assert len(atomics) == (1 if case == "one" else sum(r >= 0 for r in ranks))


# ---------------------------------------------------------------------------
# B6's launch split
# ---------------------------------------------------------------------------


def test_group_launch_boundaries():
    counts = torch.tensor([0, 1, 3052, RG.SMALL_TILE, RG.SMALL_TILE + 1, 7000,
                           RG.GROUP_TILE, RG.GROUP_TILE + 1, 10**6])
    assert RG.group_launch(counts).tolist() == [0, 0, 0, 0, 1, 1, 1, -1, -1]
    assert RG.GROUP_LAUNCHES[-1][1] == RG.GROUP_TILE
    # the launches cover 0..GROUP_TILE once, each within its block sort
    # (256 threads x 16 words, 512 x 16)
    assert RG.GROUP_LAUNCHES[0][0] == 0
    for (_, hi), (lo, _) in zip(RG.GROUP_LAUNCHES, RG.GROUP_LAUNCHES[1:]):
        assert lo == hi + 1
    assert [hi for _, hi in RG.GROUP_LAUNCHES] == [256 * E, 512 * E]


def _hot_partition_gid(hot_rows, seed):
    """24576 rows (plan: 8 partitions): `hot_rows` of one key, the rest
    spread over the other seven partitions."""
    n = 3 * RG.GROUP_TILE
    pbits = RG.plan(n)
    cand = torch.arange(1, 1 << 16)
    part = ((cand * RG._MULT) & 0xFFFFFFFF) >> (32 - pbits)
    hot = int(cand[part == 0][0])
    others = cand[part != 0]
    rng = np.random.default_rng(seed)
    gid = others[torch.from_numpy(rng.integers(0, others.shape[0],
                                               n - hot_rows))]
    gid = torch.cat([torch.full((hot_rows,), hot), gid]).to(torch.int32)
    return gid[torch.from_numpy(rng.permutation(n))], pbits


@pytest.mark.parametrize("hot_rows,launch", [
    (2000, 0), (RG.SMALL_TILE, 0), (RG.SMALL_TILE + 1, 1), (6000, 1),
    (RG.GROUP_TILE, 1), (RG.GROUP_TILE + 1, -1)])
def test_bit0_falls_exactly_past_the_tile(hot_rows, launch):
    gid, pbits = _hot_partition_gid(hot_rows, hot_rows)
    v = torch.arange(gid.shape[0], dtype=torch.int64)
    _, _, counts, _ = RG.radix_partition_plain(gid, [], 1 << 16, pbits)
    where = RG.group_launch(counts)
    assert int(counts[0]) == hot_rows and int(where[0]) == launch
    assert int((where[1:] == 0).sum()) == counts.shape[0] - 1
    g, ln, tot, ng, ovf = RG.sparse_groupby(gid, [(v, "sumi")], 1 << 16, 1 << 16)
    rg, rln, rtot, rng_, rovf = JRG._ref_sparse_groupby(
        gid.numpy(), [v.numpy().astype(np.int32)], 1 << 16, ("sumi32",), 1 << 16)
    # bit 0 exactly when no launch takes the partition; below it, the
    # groups equal the reference's
    assert int(ovf) & 1 == (launch == -1)
    m = int(ng)
    assert m == int(rng_)
    assert np.array_equal(g.numpy()[:m], rg[:m])
    assert np.array_equal(ln.numpy()[:m], rln[:m])
    assert np.array_equal(tot[0].numpy()[:m], rtot[0][:m])


def test_gate_hot_case_takes_the_second_launch():
    gid, mask, *_ = gate._inputs(torch.device("cpu"), 1 << 14, 3000, 5)
    gid = torch.where(mask, gid, -1)
    gid[:4400] = 7
    pbits = RG.plan(gid.shape[0])
    _, _, counts, _ = RG.radix_partition_plain(gid, [], 3000, pbits)
    where = RG.group_launch(counts)
    assert sorted(where.tolist()) == [0] * (counts.shape[0] - 1) + [1]
