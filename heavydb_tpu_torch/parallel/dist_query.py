"""Distributed query steps over a device mesh.

Counterpart of heavydb_tpu/parallel/dist_query.py, whose five steps are
shard_map'd bodies with explicit collectives.  Here each step's factory
returns a function that runs the per-shard body on mesh.devices[i] over that
shard's row block (contiguous blocks of ceil(N / S) rows, `row_sharding`),
then performs the collective explicitly:

- psum: the shards' partials moved with .to() to one device and added;
- psum_scatter: each owner adds the shards' slices of its slot block;
- all_gather: the shards' candidates concatenated in shard order;
- all_to_all: a transpose of the shards' [S, row_block] send bins.

Outputs keep the reference's layout: replicated arrays, or owner-sharded
arrays concatenated by shard, on mesh.devices[0].  Inputs are tensors of
the global rows plus `nrows[S]`, each shard's count of live rows at the
head of its block, as in the reference.

The bodies are plain scatters in the reference too, not Pallas kernels, so
they stay plain torch.  Float sums accumulate in float64 and return
float32: the shards' order of addition differs from XLA's anyway, and a
float32 accumulator over 10^6 rows a slot drifts past 1e-5.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from heavydb_tpu_torch.parallel.mesh import SHARD_AXIS, Mesh, row_sharding

# the reference's routing hash, (k * 0x9E3779B97F4A7C15) >> 33 in uint64,
# taken here in int64 (the product wraps alike) with the shift's sign bits
# masked off
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_LOW31 = (1 << 31) - 1


def shard_hash(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The shard each key routes to: ((uint64(k) * golden) >> 33) % S."""
    h = ((keys.to(torch.int64) * _GOLDEN) >> 33) & _LOW31
    return (h % n_shards).to(torch.int32)


def _shards(mesh: Mesh, *arrays):
    """Per shard: its row block of each array, on its device, and its
    live-row mask (the last argument is nrows[S])."""
    *cols, nrows = arrays
    slices = row_sharding(mesh).shard_slices(int(cols[0].shape[0]))
    out = []
    for s, (dev, sl) in enumerate(zip(mesh.devices, slices)):
        block = [c[sl].to(dev) for c in cols]
        live = torch.arange(block[0].shape[0], device=block[0].device) < int(nrows[s])
        out.append((block, live))
    return out


def _psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    dev = parts[0].device
    total = parts[0].clone()
    for p in parts[1:]:
        total += p.to(dev)
    return total


def _segment_sums(seg, num_slots, values=None):
    """(int64 counts, float64 sums) over seg in [0, num_slots], the last
    slot the dump of dropped rows, which is cut off."""
    dev = seg.device
    counts = torch.zeros(num_slots + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, seg, torch.ones_like(seg, dtype=torch.int64))
    if values is None:
        return counts[:num_slots], None
    sums = torch.zeros(num_slots + 1, dtype=torch.float64, device=dev)
    sums.index_add_(0, seg, values.to(torch.float64))
    return counts[:num_slots], sums[:num_slots]


def _slots(keys, live, num_slots, dump):
    gid = keys.to(torch.int32).clamp(0, num_slots - 1).to(torch.int64)
    return torch.where(live, gid, dump)


def distributed_groupby_sum_count(mesh: Mesh, num_slots: int):
    """fn(keys[N], values[N], nrows[S]) -> (counts[num_slots] int64,
    sums[num_slots] float32), replicated: shard-local partial aggregates,
    then one psum."""

    def fn(keys, values, nrows):
        cs, ss = [], []
        for (k, v), live in _shards(mesh, keys, values, nrows):
            seg = _slots(k, live, num_slots, num_slots)
            vals = torch.where(live, v.to(torch.float32), 0.0)
            c, s = _segment_sums(seg, num_slots, vals)
            cs.append(c)
            ss.append(s)
        return _psum(cs), _psum(ss).to(torch.float32)

    return fn


def distributed_groupby_reduce_scatter(mesh: Mesh, num_slots: int):
    """Owner-sharded group-by: shard-local dense partials over
    ceil(num_slots / S) * S slots, then one reduce-scatter so that shard s
    owns slots [s*B, (s+1)*B).  fn(keys, values, nrows) -> (counts[S*B]
    int32, sums[S*B] float32), the owners' blocks concatenated by shard.
    Map-side combining makes it skew-immune."""
    n_shards = mesh.shape[SHARD_AXIS]
    block = -(-num_slots // n_shards)
    padded = block * n_shards

    def fn(keys, values, nrows):
        parts = []
        for (k, v), live in _shards(mesh, keys, values, nrows):
            seg = _slots(k, live, num_slots, padded)
            vals = torch.where(live, v.to(torch.float32), 0.0)
            parts.append(_segment_sums(seg, padded, vals))
        counts, sums = [], []
        for s, dev in enumerate(mesh.devices):
            sl = slice(s * block, (s + 1) * block)
            counts.append(_psum([c[sl].to(dev) for c, _ in parts]))
            sums.append(_psum([x[sl].to(dev) for _, x in parts]))
        dev0 = mesh.devices[0]
        return (torch.cat([c.to(dev0) for c in counts]).to(torch.int32),
                torch.cat([x.to(dev0) for x in sums]).to(torch.float32))

    return fn


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest, ties to the lower index (lax.top_k's
    order, which torch.topk does not promise)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def distributed_topk(mesh: Mesh, k: int, descending: bool = True):
    """Distributed ORDER BY ... LIMIT k: shard-local top-k, all_gather of
    the S*k candidates, the final top-k replicated.
    fn(values[N], payload[N], nrows[S]) -> (top_vals[k], top_payload[k])."""

    def fn(values, payload, nrows):
        cand_v, cand_p = [], []
        dev0 = mesh.devices[0]
        for (v, p), live in _shards(mesh, values, payload, nrows):
            if v.dtype.is_floating_point:
                neutral = float("-inf") if descending else float("inf")
            else:
                info = torch.iinfo(v.dtype)
                neutral = info.min if descending else info.max
            masked = torch.where(live, v, neutral)
            sv = masked if descending else -masked
            idx = _top_k(sv, min(k, sv.shape[0]))
            cand_v.append(sv[idx].to(dev0))
            cand_p.append(p[idx].to(dev0))
        cv, cp = torch.cat(cand_v), torch.cat(cand_p)
        fin = _top_k(cv, k)
        out_v = cv[fin] if descending else -cv[fin]
        return out_v, cp[fin]

    return fn


def _send_bins(dest, cols, n_shards: int, row_block: int):
    """Rows sorted (stably) by destination into fixed [S, row_block] bins,
    zero-padded, rows past a bin's row_block dropped.  Returns the bins of
    each column and the per-destination row counts before the cut."""
    order = torch.argsort(dest, stable=True)
    sdest = dest[order].to(torch.int64)
    counts = torch.bincount(sdest, minlength=n_shards + 1)[:n_shards]
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(sdest.shape[0], device=dest.device) \
        - offsets[sdest.clamp(max=n_shards - 1)]
    ok = (sdest < n_shards) & (pos < row_block)
    flat = torch.where(ok, sdest * row_block + pos, n_shards * row_block)
    bins = []
    for c in cols:
        send = torch.zeros(n_shards * row_block + 1, dtype=c.dtype, device=c.device)
        send[flat] = c[order]
        bins.append(send[:-1].view(n_shards, row_block))
    return bins, counts


def _all_to_all(mesh: Mesh, sends: List[torch.Tensor]) -> List[torch.Tensor]:
    """sends[s][r] goes from shard s to shard r; shard r receives the
    senders' bins concatenated in sender order."""
    return [torch.cat([sends[s][r].to(dev) for s in range(len(sends))])
            for r, dev in enumerate(mesh.devices)]


def _route(keys, live, n_shards):
    return torch.where(live, shard_hash(keys, n_shards), n_shards)


def _exchange(mesh, routed, row_block):
    """routed: per shard (dest, cols).  Returns, per column, each receiving
    shard's rows [S*row_block]; each receiving shard's counts[S]; and each
    sending shard's largest bin before the cut to row_block."""
    n_shards = mesh.size
    sent = [_send_bins(dest, cols, n_shards, row_block) for dest, cols in routed]
    n_cols = len(routed[0][1])
    recv_cols = [_all_to_all(mesh, [bins[j] for bins, _ in sent]) for j in range(n_cols)]
    clipped = [counts.clamp(max=row_block).to(torch.int32).view(n_shards, 1)
               for _, counts in sent]
    recv_counts = [c.view(n_shards) for c in _all_to_all(mesh, clipped)]
    maxima = [counts.max() for _, counts in sent]
    return recv_cols, recv_counts, maxima


def distributed_join_groupby(mesh: Mesh, row_block: int, num_groups: int):
    """Repartitioned hash join + group-by: both sides routed to the shard
    owning hash(key) in row_block bins, the co-located partitions joined
    locally (sort + probe: does the probe key exist in the build
    partition), per-group COUNT / SUM partials merged with a psum.
    fn(pk, pg, pv, pn, bk, bn) -> (counts[G] int32, sums[G] float32,
    overflow[S] int32); overflow counts rows past row_block."""
    n_shards = mesh.shape[SHARD_AXIS]

    def fn(pk, pg, pv, pn, bk, bn):
        probe = _shards(mesh, pk, pg, pv, pn)
        build = _shards(mesh, bk, bn)
        p_recv, p_cnt, p_max = _exchange(
            mesh, [(_route(k, live, n_shards), [k, g, v])
                   for (k, g, v), live in probe], row_block)
        b_recv, b_cnt, b_max = _exchange(
            mesh, [(_route(k, live, n_shards), [k]) for (k,), live in build],
            row_block)
        overflow = sum(max(int(m) - row_block, 0) for m in p_max + b_max)
        cs, ss = [], []
        for r in range(n_shards):
            rpk, rpg, rpv = (c[r] for c in p_recv)
            (rbk,) = (c[r] for c in b_recv)
            r_iota = torch.arange(n_shards * row_block, device=rpk.device)
            p_valid = (r_iota % row_block) < p_cnt[r][r_iota // row_block]
            b_valid = (r_iota % row_block) < b_cnt[r][r_iota // row_block]
            sb = torch.sort(torch.where(b_valid, rbk.to(torch.int64), 1 << 62)).values
            key = rpk.to(torch.int64)
            pos = torch.searchsorted(sb, key).clamp(0, sb.shape[0] - 1)
            hit = p_valid & (sb[pos] == key)
            seg = _slots(rpg, hit, num_groups, num_groups)
            c, s = _segment_sums(seg, num_groups,
                                 torch.where(hit, rpv.to(torch.float32), 0.0))
            cs.append(c)
            ss.append(s)
        counts = _psum(cs).to(torch.int32)
        return (counts, _psum(ss).to(torch.float32),
                torch.full((n_shards,), overflow, dtype=torch.int32, device=counts.device))

    return fn


def hash_repartition(mesh: Mesh, row_block: int):
    """Shuffle step: route rows to shard hash(key) % S in row_block bins.
    fn(keys, values, nrows) -> (keys'[S*S*row_block], values'[...],
    counts'[S*S], overflow[S]), shard s's received rows and counts at block
    s; overflow is the psum of each shard's largest bin (the exact
    capacity a retry needs)."""
    n_shards = mesh.shape[SHARD_AXIS]

    def fn(keys, values, nrows) -> Tuple[torch.Tensor, ...]:
        shards = _shards(mesh, keys, values, nrows)
        recv, counts, maxima = _exchange(
            mesh, [(_route(k, live, n_shards), [k, v]) for (k, v), live in shards],
            row_block)
        dev0 = mesh.devices[0]
        need = sum(int(m) for m in maxima)
        rk = torch.cat([k.to(dev0) for k in recv[0]])
        return (rk, torch.cat([v.to(dev0) for v in recv[1]]),
                torch.cat([c.to(dev0) for c in counts]),
                torch.full((n_shards,), need, dtype=torch.int32, device=rk.device))

    return fn
