"""ORDER BY / top-k operations.

Port of heavydb_tpu/ops/sort.py.  Every key is mapped to integer codes
whose order is the ORDER BY order; torch compares them exactly on every
device.  Two operations:

- `sort_permutation`: the full lexicographic sort.  Each key becomes one
  code of at most 33 bits (a NULL folded in as one more bit), or a 64-bit
  code beside a 1-bit NULL flag; the codes are packed into as few int64
  words as hold them, and the words sorted by one stable `torch.sort`
  pass each (`ops.groupby._lex_sort_perm`), least significant first.
  The reference carries payloads through `lax.sort` as extra operands;
  torch cannot, so payloads are gathered through the permutation.
- `topk_indices` / `topk_indices_u`: the k largest keys, ties in row order
  (the reference's `lax.top_k` below 16385 rows and its radix select
  above, which agree).  The k-th value comes from one `torch.topk`, whose
  value is exact whatever order it gives ties; the rows strictly above it
  and the first ties in row order are marked by a prefix sum, found by a
  binary search of a second prefix sum, and ordered by a stable sort of
  the k winners.  No step reads a value back to the host.

Floats compare in total order on the top-k path (-0.0 below +0.0, as the
reference's orderable bits and `lax.top_k`) and with -0.0, +0.0 and the
subnormals equal in the full sort (as `lax.sort` compares them); NaN keys
sort as 0 on both.  DOUBLE keys use
their exact bits: the reference's arithmetic f64 codec, which above 16384
rows folds -0.0 into +0.0 and subnormals into 0, is a TPU workaround that
is not copied.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from heavydb_tpu_torch.ops.groupby import _flush_subnormals, _lex_sort_perm

TV = Tuple[torch.Tensor, Optional[torch.Tensor]]

_INT64_MIN = -(1 << 63)


def _signed_order(key):
    """key -> int32 (keys of <= 4 bytes) or int64 codes whose signed order
    is the key's order; floats in total order (-0.0 below +0.0)."""
    if key.dtype == torch.float32:
        b = key.view(torch.int32)
        return b ^ ((b >> 31) & 0x7FFFFFFF)
    if key.dtype == torch.float64:
        b = key.view(torch.int64)
        return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFF)
    if key.dtype == torch.bool or key.element_size() <= 4:
        return key.to(torch.int32)
    return key.to(torch.int64)


def _orderable_bits(key):
    """key -> (u, bits): the reference's orderable bits as int64.  For 32
    bits u equals them (0 <= u < 2^32); 64-bit bits are held with their
    top bit flipped (u = bits ^ 2^63 read as signed), so signed int64
    compares keep their order."""
    s = _signed_order(key)
    if s.dtype == torch.int32:
        return s.to(torch.int64) + (1 << 31), 32
    return s, 64


def _ascending_codes(val, valid, asc: bool, nulls_first: bool):
    """One ORDER BY key -> [(code, width)], int64 codes whose ascending
    lexicographic order is the key's order: NaN, -0.0 and subnormals as
    +0.0, NULL first or last.  A code of width < 64 is unsigned; width 64
    is signed.  It stands for the reference's `_sortable_operands` pair
    (null rank, value), the null rank folded into one more bit."""
    v = torch.as_tensor(val)
    if v.is_floating_point():
        # lax.sort compares with subnormals as zero, and -0.0 == +0.0
        flat = torch.isnan(v) | (v.abs() < torch.finfo(v.dtype).tiny)
        v = torch.where(flat, torch.zeros((), dtype=v.dtype, device=v.device), v)
    u, w = _orderable_bits(v)
    if not asc:
        if w == 32:
            u = ((1 << 32) - 1) - u
        else:  # the exact reversal for DOUBLE, the reference's negation for BIGINT
            u = ~u if v.is_floating_point() else -u
    if valid is None:
        return [(u, w)]
    if w < 64:
        # NULL takes the lowest or the highest code of one more bit
        if nulls_first:
            return [(torch.where(valid, u + 1, 0), w + 1)]
        return [(torch.where(valid, u, 1 << w), w + 1)]
    null_flag = valid.to(torch.int64) if nulls_first else (~valid).to(torch.int64)
    return [(null_flag, 1), (torch.where(valid, u, 0), 64)]


def _sortable_operands(val, valid, asc: bool, nulls_first: bool):
    """Key column -> (null_rank int8, value) ascending-sort operands, the
    reference's: NaN as 0, DESC by negation (int64 for integers), NULL
    rank -1 first or 1 last.  -0.0 and the subnormals become +0.0 after
    the negation, as `lax.sort` compares them, so that a stable
    `torch.sort` keeps such ties in row order."""
    v = torch.as_tensor(val)
    if v.dtype == torch.bool:
        v = v.to(torch.int8)
    fp = v.is_floating_point()
    if fp:
        v = torch.where(torch.isnan(v), torch.zeros((), dtype=v.dtype, device=v.device), v)
    if not asc:
        v = -v if fp else -v.to(torch.int64)
    if fp:
        v = _flush_subnormals(v)
    if valid is None:
        return torch.zeros(v.shape, dtype=torch.int8, device=v.device), v
    nullr = torch.where(valid, 0, -1 if nulls_first else 1).to(torch.int8)
    return nullr, torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=v.device))


def _pack_words(operands):
    """(code, width) operands, most significant first -> int64 words, most
    significant first, that sort as the operands do lexicographically:
    adjacent operands share a word while their widths fit 64 bits.  A full
    64-bit word of unsigned codes is read with its top bit flipped."""
    groups: List[list] = []
    for code, w in reversed(operands):
        if not groups or sum(x[1] for x in groups[-1]) + w > 64:
            groups.append([])
        groups[-1].insert(0, (code, w))
    words = []
    for g in reversed(groups):
        if len(g) == 1 and g[0][1] == 64:
            words.append(g[0][0])
            continue
        total = sum(w for _, w in g)
        word, shift = None, total
        for code, w in g:
            shift -= w
            part = code << shift if shift else code
            word = part if word is None else word | part
        words.append(word ^ _INT64_MIN if total == 64 else word)
    return words


def composite_topk_key(key_tvs: Sequence[TV], specs, total_bits: int,
                       in_domain=None):
    """Pack multi-column ORDER BY keys into ONE int64 where a LARGER value
    means EARLIER in the output order (the reference's descending-priority
    convention).

    specs: per key (wv, lo, asc, nulls_first, nullable): wv = value bit
    width (narrowed by chunk stats when lo is not None), lo = int bias, or
    None for the full-width orderable bits.  A nullable key spends one more
    bit: real codes shift up by 1, NULL takes the all-ones code (nulls
    first) or 0 (nulls last).  The caller guarantees sum of widths <= 63.

    in_domain (optional bool[n]) spends the top bit, so padding rows rank
    below every real row.  Returns (key, bits): key equals the reference's
    unsigned key when bits < 64; at 64 bits it is that key with its top bit
    flipped, read as signed, so that signed compares keep its order."""
    bits = total_bits + (1 if in_domain is not None else 0)
    acc = None
    for (val, valid), (wv, lo, asc, nulls_first, nullable) in zip(key_tvs, specs):
        top = (1 << wv) - 1
        if lo is None:  # a key of <= 4 bytes: its 32 orderable bits
            u = _orderable_bits(val)[0]
        else:
            # the reference reads val - lo as uint64 and clips it to the
            # width: a negative difference clips to the top
            d = val.to(torch.int64) - lo
            u = torch.where(d < 0, top, torch.clamp(d, max=top))
        if asc:  # earlier = smaller value: flip within the width
            u = top - u
        w = wv
        if nullable:
            w = wv + 1
            u = u + 1
            if valid is not None:
                u = torch.where(valid, u, (1 << w) - 1 if nulls_first else 0)
        acc = u if acc is None else (acc << w) | u
    if in_domain is not None:
        acc = acc | (in_domain.to(torch.int64) << total_bits)
        if bits == 64:
            acc = acc ^ _INT64_MIN
    return acc, bits


def topk_indices_u(u, bits: int, k: int):
    """topk_indices over a packed composite key (composite_topk_key); its
    signed order is its order at every width `bits`."""
    return _select_topk(u, min(k, u.shape[0]))


def topk_indices(key, k: int):
    """Indices of the k largest `key` values, largest first, ties in row
    order; floats in total order."""
    return _select_topk(_signed_order(key), min(k, key.shape[0]))


def _select_topk(s, k: int):
    """The k rows of the largest signed codes `s`, in descending order of s
    and ascending row order among ties."""
    if k <= 0:
        return torch.empty(0, dtype=torch.int64, device=s.device)
    thr = torch.topk(s, k, sorted=False).values.min()
    above = s > thr
    at = s == thr
    cdt = torch.int32 if s.shape[0] < (1 << 31) else torch.int64
    # all rows strictly above the k-th value, then the first ties to reach k
    sel = above | (at & (torch.cumsum(at, 0, dtype=cdt) <= k - above.sum()))
    # the j-th winner in row order: where the count of winners reaches j + 1
    count = torch.cumsum(sel, 0, dtype=cdt)
    out = torch.searchsorted(count, torch.arange(1, k + 1, dtype=cdt, device=s.device))
    return out[torch.sort(s[out], descending=True, stable=True).indices]


def sort_permutation(
    key_tvs: Sequence[TV],
    specs: Sequence[Tuple[bool, bool]],  # (asc, nulls_first) per key
    mask,  # valid-row mask or None
    payloads: Sequence = (),
):
    """Returns (perm[N] int64, valid_sorted[N] bool, sorted_payloads): row
    indices in output order (stable), rows outside `mask` pushed to the
    end, and each payload gathered through perm."""
    ops = [] if mask is None else [((~mask).to(torch.int64), 1)]
    for (val, valid), (asc, nulls_first) in zip(key_tvs, specs):
        ops += _ascending_codes(val, valid, asc, nulls_first)
    perm = _lex_sort_perm(_pack_words(ops))
    valid_sorted = (torch.ones(perm.shape[0], dtype=torch.bool, device=perm.device)
                    if mask is None else mask[perm])
    return perm, valid_sorted, tuple(p[perm] for p in payloads)
