"""Hash-join operations.

Port of heavydb_tpu/ops/join.py, with the same functions and contracts on
torch tensors of one device.  Two build forms, as in the reference:

- **Perfect** (dense key range): a positional CSR over [key_min,
  key_min + key_range): per-slot counts, offsets and the build rows in
  slot order; probed with gathers (`build_perfect`, `probe_perfect`,
  `probe_perfect_unique`).
- **Sorted** (no dense range): the build rows sorted by key, probed with a
  binary search (`build_sorted`, `probe_counts`) or through an
  open-addressing table over the sorted runs (`build_hash_table`,
  `probe_counts_hash`).

1:N matches expand into a domain of a static capacity (`expand_matches`),
which also returns the exact capacity needed so the executor can retry
with a larger one.

The reference's `lut_gather` (a one-hot matmul standing in for a gather
on the TPU) is a plain index here.  Its prefix sums are `torch.cumsum`
(int64 where a count can pass 2^31), its reverse min-scan a `torch.cummin`
of the flipped tensor, `.at[i].min` a `scatter_reduce_(..., "amin")`, and a
scatter with index n as the drop slot writes into an n + 1 buffer that is
sliced.  The sorted build is stable, so build rows of one key keep their
row order (the reference's `lax.sort(is_stable=False)` leaves it open).
The hashes are computed in int64 with explicit masks and are bit-equal to
the reference's uint32 / uint64 ones.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from heavydb_tpu_torch.kernels import join_build

_INT64_MAX = (1 << 63) - 1
_M32 = 0xFFFFFFFF


def _iota(n: int, device, dtype=torch.int32):
    return torch.arange(n, dtype=dtype, device=device)


def _in_domain(b: int, num_rows: int, valid, device):
    ok = torch.ones(b, dtype=torch.bool, device=device)
    ok[int(num_rows):] = False
    return ok if valid is None else ok & valid


class SortedBuild(NamedTuple):
    """Build-side index: rows sorted by key."""

    keys_sorted: torch.Tensor  # [B] int64 key values in sorted order
    rows_sorted: torch.Tensor  # [B] int32 original build-row index
    valid_sorted: torch.Tensor  # [B] bool, invalid rows sorted to the end


def build_sorted(keys, valid, num_rows) -> SortedBuild:
    """Sort the build side by (key, invalid flag), stably.  Invalid and
    out-of-domain rows get key INT64_MAX; the flag keeps a valid key equal
    to INT64_MAX before them, so the valid rows form a sorted prefix."""
    b = keys.shape[0]
    ok = _in_domain(b, num_rows, valid, keys.device)
    k = torch.where(ok, keys.to(torch.int64), _INT64_MAX)
    # lexicographic (key, flag): the flag pass first, then a stable key pass
    p = torch.sort((~ok).to(torch.int8), stable=True).indices
    p = p[torch.sort(k[p], stable=True).indices]
    return SortedBuild(k[p], p.to(torch.int32), ok[p])


def probe_counts(build: SortedBuild, probe_keys, probe_valid):
    """For each probe row: (first match position, match count)."""
    pk = probe_keys.to(torch.int64)
    nvalid = build.valid_sorted.sum()
    lo = torch.searchsorted(build.keys_sorted, pk, side="left")
    hi = torch.searchsorted(build.keys_sorted, pk, side="right")
    # clamp matches into the valid prefix of the sorted build array
    lo = torch.minimum(lo, nvalid)
    hi = torch.minimum(hi, nvalid)
    cnt = (hi - lo).to(torch.int32)
    if probe_valid is not None:
        cnt = torch.where(probe_valid, cnt, 0)
    return lo.to(torch.int32), cnt


class HashJoinTable(NamedTuple):
    keys: torch.Tensor  # int64 [rounds*slots], key per claimed slot
    lo: torch.Tensor  # int32 [rounds*slots], first match position
    cnt: torch.Tensor  # int32 [rounds*slots], run length
    rows_sorted: torch.Tensor
    slots: int
    rounds: int
    unresolved: torch.Tensor  # 0-d int32: build keys that claimed no slot


def _split32(k):
    """int64 keys -> (low, high) 32-bit halves as non-negative int64."""
    return k & _M32, (k >> 32) & _M32


def _mix32(lo32, hi32, r: int):
    """The reference's uint32 mix of a key's halves for round r, in int64
    masked to 32 bits (a wrapping int64 product has the uint64 one's low
    bits; the operands are below 2^32, so every shift is logical)."""
    h = (lo32 * 0x85EBCA6B + hi32 * 0xC2B2AE35
         + ((0x9E3779B9 * (r + 1)) & _M32)) & _M32
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    return h ^ (h >> 15)


def build_hash_table(build: SortedBuild, slots: int, rounds: int = 4) -> HashJoinTable:
    """Open-addressing join table from a sorted build (reference
    BaselineJoinHashTable): each distinct build key claims a hashed slot
    (the least key wins a slot, the losers hash again next round) and
    stores its (first position, run length) in the sorted array."""
    dev = build.keys_sorted.device
    b = build.keys_sorted.shape[0]
    ks = build.keys_sorted
    first = torch.ones(b, dtype=torch.bool, device=dev)
    first[1:] = ks[1:] != ks[:-1]
    first &= build.valid_sorted
    pos = _iota(b, dev)
    nvalid = build.valid_sorted.sum().to(torch.int32)
    # run length: the next run's start (a reverse min-scan over the run
    # starts) less this position
    s = torch.where(first, pos, b)
    rev = torch.cummin(s.flip(0), 0).values.flip(0)
    nxt_first = torch.cat([rev[1:], torch.full((1,), b, dtype=torch.int32, device=dev)])
    run = (torch.minimum(nxt_first, nvalid) - pos).to(torch.int32)
    uk = torch.where(first, ks, _INT64_MAX)
    lo32, hi32 = _split32(uk)
    unresolved = first
    keys_t, lo_t, cnt_t = [], [], []
    for r in range(rounds):
        slot = _mix32(lo32, hi32, r) & (slots - 1)
        idx = torch.where(unresolved, slot, slots)
        val = torch.where(unresolved, uk, _INT64_MAX)
        buf = torch.full((slots + 1,), _INT64_MAX, dtype=torch.int64, device=dev)
        buf.scatter_reduce_(0, idx, val, "amin")
        owner = unresolved & (buf[slot] == uk)
        widx = torch.where(owner, slot, slots)
        lo_buf = torch.zeros(slots + 1, dtype=torch.int32, device=dev)
        lo_buf.scatter_(0, widx, pos)
        cnt_buf = torch.zeros(slots + 1, dtype=torch.int32, device=dev)
        cnt_buf.scatter_(0, widx, run)
        keys_t.append(buf[:slots])
        lo_t.append(lo_buf[:slots])
        cnt_t.append(cnt_buf[:slots])
        unresolved = unresolved & ~owner
    return HashJoinTable(torch.cat(keys_t), torch.cat(lo_t), torch.cat(cnt_t),
                         build.rows_sorted, slots, rounds,
                         unresolved.sum(dtype=torch.int32))


def probe_counts_hash(table: HashJoinTable, probe_keys, probe_valid):
    """(first match position, match count) per probe row through
    `table.rounds` table gathers."""
    pk = probe_keys.to(torch.int64)
    lo32, hi32 = _split32(pk)
    hit_at = torch.full(pk.shape, -1, dtype=torch.int64, device=pk.device)
    for r in range(table.rounds):
        slot = (_mix32(lo32, hi32, r) & (table.slots - 1)) + r * table.slots
        hit = (table.keys[slot] == pk) & (hit_at < 0)
        hit_at = torch.where(hit, slot, hit_at)
    found = hit_at >= 0
    sl = hit_at.clamp(0, table.rounds * table.slots - 1)
    lo = torch.where(found, table.lo[sl], 0)
    cnt = torch.where(found, table.cnt[sl], 0)
    if probe_valid is not None:
        cnt = torch.where(probe_valid, cnt, 0)
    return lo, cnt


def expand_matches(lo, cnt, build_rows_sorted, probe_mask, cap: int,
                   left_outer: bool):
    """Expand 1:N matches into output row pairs in a domain of `cap` slots.

    Each contributing probe row owns the slots [start, start + eff) at the
    exclusive prefix sum of its effective count (its match count, at least
    1 under LEFT OUTER): probe-major, its matches in build order.  A slot
    finds its probe row through a scatter of the row starts and a prefix
    sum, no search.

    Returns (probe_idx[cap] int32, build_idx[cap] int32, out_mask[cap],
             build_matched[cap] (False for LEFT null rows), needed), where
    `needed` is the exact capacity the expansion needs, a 0-d int64 that a
    count of 2^31 or more does not wrap.
    """
    dev = cnt.device
    n = cnt.shape[0]
    eff_cnt = cnt if probe_mask is None else torch.where(probe_mask, cnt, 0)
    if left_outer:
        eff = torch.clamp(eff_cnt, min=1)
        if probe_mask is not None:
            eff = torch.where(probe_mask, eff, 0)
    else:
        eff = eff_cnt
    ends = torch.cumsum(eff, 0, dtype=torch.int64)
    needed = ends[-1] if n else torch.zeros((), dtype=torch.int64, device=dev)
    starts = ends - eff
    has = eff > 0
    # compact the contributing probe rows; mark each one's start slot
    kpos = torch.cumsum(has, 0, dtype=torch.int64) - 1
    rowmap = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    rowmap.scatter_(0, torch.where(has, kpos, n), _iota(n, dev))
    rowmap = rowmap[:n]
    marks = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    marks.scatter_(0, torch.where(has & (starts < cap), starts, cap),
                   torch.ones(n, dtype=torch.int32, device=dev))
    # ordinal among the contributing rows of each slot
    pj = torch.cumsum(marks[:cap], 0, dtype=torch.int32) - 1
    pidx = rowmap[pj.clamp(0, max(n - 1, 0))]
    slot = _iota(cap, dev)
    # the start of a slot's row is below cap, so it fits int32
    ordinal = slot - starts.clamp(max=cap).to(torch.int32)[pidx]
    # (a 0-d int64 beside int32 would compare as int32: clamp it first)
    out_mask = slot < needed.clamp(max=cap)
    matched = ordinal < eff_cnt[pidx]
    bpos = lo[pidx] + torch.where(matched, ordinal, 0)
    bpos = bpos.clamp(0, build_rows_sorted.shape[0] - 1)
    bidx = build_rows_sorted[bpos]
    return pidx, bidx, out_mask, matched & out_mask, needed


def build_matched_flags(lo, cnt, build_rows_sorted, contributing, n_build: int):
    """FULL OUTER support: which BUILD rows matched at least one probe row.

    +1 at each contributing probe row's match window start, -1 past its
    end; a prefix sum > 0 marks the covered sorted positions, which scatter
    through the build rows into per-row flags."""
    dev = cnt.device
    m = build_rows_sorted.shape[0]
    has = cnt > 0
    if contributing is not None:
        has = has & contributing
    lo64 = lo.to(torch.int64)
    diff = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    ones = torch.ones(lo.shape[0], dtype=torch.int32, device=dev)
    diff.index_add_(0, torch.where(has, lo64, m), ones)
    diff.index_add_(0, torch.where(has, lo64 + cnt, m), -ones)
    covered = torch.cumsum(diff[:m], 0, dtype=torch.int32) > 0
    tgt = torch.where(covered, build_rows_sorted.to(torch.int64), n_build)
    flags = torch.zeros(n_build + 1, dtype=torch.bool, device=dev)
    flags[tgt] = True
    return flags[:n_build]


def probe_unique(lo, cnt, build_rows_sorted, mask):
    """Identity-domain probe for builds whose keys are unique (each probe
    row matches at most one build row): no expansion.  Returns
    (build_idx[n], matched[n])."""
    bpos = lo.clamp(0, build_rows_sorted.shape[0] - 1)
    bidx = build_rows_sorted[bpos]
    matched = cnt > 0
    if mask is not None:
        matched = matched & mask
    return bidx, matched


# ---------------------------------------------------------------------------
# Perfect (dense-range positional) join: reference PerfectJoinHashTable
# ---------------------------------------------------------------------------


class PerfectBuild(NamedTuple):
    counts: torch.Tensor  # [R] int32, rows per key slot
    offsets: torch.Tensor  # [R] int64, CSR offsets into payload
    payload: torch.Tensor  # [B] int32, build row ids grouped by key slot
    key_min: int


def build_perfect(keys, valid, num_rows, key_min: int, key_range: int) -> PerfectBuild:
    """CSR build over the dense key space [key_min, key_min + key_range).
    Each row's slot and the slots' counts come from kernel J1 (on the CPU
    its plain version); a row that drops has the slot key_range."""
    slot, counts = join_build.perfect_count(keys, valid, num_rows, key_min, key_range)
    offsets = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    # rows in slot order, each slot's rows in row order
    payload = torch.sort(slot, stable=True).indices.to(torch.int32)
    return PerfectBuild(counts, offsets, payload, key_min)


def _perfect_slot(build: PerfectBuild, probe_keys, probe_valid, key_range: int):
    pk = probe_keys.to(torch.int64) - build.key_min
    ok = (pk >= 0) & (pk < key_range)
    if probe_valid is not None:
        ok = ok & probe_valid
    return pk.clamp(0, key_range - 1), ok


def probe_perfect(build: PerfectBuild, probe_keys, probe_valid, key_range: int):
    slot, ok = _perfect_slot(build, probe_keys, probe_valid, key_range)
    lo = build.offsets[slot].to(torch.int32)
    cnt = torch.where(ok, build.counts[slot], 0)
    return lo, cnt


def probe_perfect_unique(build: PerfectBuild, probe_keys, probe_valid,
                         key_range: int, mask):
    """Perfect probe for builds whose keys are unique: the build side
    composes slot -> build row (a key_range-sized gather) so each probe row
    takes one lookup of [build row, count].  Returns (build_idx[n], cnt[n],
    matched[n])."""
    slot, ok = _perfect_slot(build, probe_keys, probe_valid, key_range)
    direct = build.payload[build.offsets.clamp(0, build.payload.shape[0] - 1)]
    bidx = direct[slot]
    cnt = torch.where(ok, build.counts[slot], 0)
    matched = cnt > 0
    if mask is not None:
        matched = matched & mask
    return bidx, cnt, matched
