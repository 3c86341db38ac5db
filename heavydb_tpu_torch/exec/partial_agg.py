"""Decomposable-aggregate machinery: split a Compound's aggregates into
mergeable partials and rebuild the finalize step.

Two consumers:
- leaf execution in one process (Executor._try_sharded_compound): fragment
  waves on one device and shards' row blocks on a mesh produce partial
  batches, merged on the device by one re-aggregation Compound;
- multi-host execution (parallel/dist_engine.py): each host is a "leaf"
  computing partials over its row partition; the merge Compound is the
  aggregator reduce (reference leaf execution + aggregator merge,
  QueryEngine/RelAlgExecutor.cpp:1211 executeRelAlgQuerySingleStep +
  broadcast_serialized_rows, heavy.thrift:769-771).

Decomposition rules (reference two-slot kAVG + ResultSetReduction merges):
  COUNT/COUNT_IF -> partial COUNT, merge SUM
  SUM/SUM_IF     -> partial SUM,   merge SUM
  MIN / MAX      -> partial MIN/MAX, merge MIN/MAX
  AVG            -> partials SUM + COUNT, finalize sum/cnt (NULL if cnt=0)
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.plan import exprs as E
from heavydb_tpu_torch.plan import rel_alg as R

STREAMABLE_AGGS = frozenset({
    E.AggKind.COUNT, E.AggKind.COUNT_IF, E.AggKind.SUM, E.AggKind.SUM_IF,
    E.AggKind.AVG, E.AggKind.MIN, E.AggKind.MAX, E.AggKind.SAMPLE,
    E.AggKind.SINGLE_VALUE,
})


def decomposable(node: R.Compound) -> bool:
    if not node.is_aggregate or not node.aggs:
        return False
    for a in node.aggs:
        if a.kind not in STREAMABLE_AGGS or a.distinct:
            return False
        if a.kind in (E.AggKind.MIN, E.AggKind.MAX) \
                and a.arg is not None and a.arg.type.is_dict_string:
            # dict-string MIN/MAX order by lexicographic RANK inside the
            # kernel but the finalized per-partition value is an ID —
            # merging ids picks the wrong string; keep these single-pass
            return False
    return True


def decompose(node: R.Compound):
    """Returns (wave_aggs, wave_targets, wave_names, fin) where `fin[j]`
    describes how original aggregate j finalizes from the merged partials:
    ("ref", pos) or ("avg", sum_pos, cnt_pos)."""
    from heavydb_tpu_torch.plan.builder import _agg_result_type

    k = len(node.group_exprs)
    wave_aggs: List[E.Agg] = []
    fin = []
    for a in node.aggs:
        if a.kind == E.AggKind.AVG:
            s_t = _agg_result_type(E.AggKind.SUM, a.arg, False)
            spos = len(wave_aggs)
            wave_aggs.append(E.Agg(E.AggKind.SUM, a.arg, False, s_t))
            cpos = len(wave_aggs)
            wave_aggs.append(
                E.Agg(E.AggKind.COUNT, a.arg, False, T.bigint(nullable=False))
            )
            fin.append(("avg", spos, cpos))
        else:
            fin.append(("ref", len(wave_aggs)))
            wave_aggs.append(a)

    wave_targets = []
    wave_names = []
    for i, g in enumerate(node.group_exprs):
        wave_targets.append(
            E.InputRef(0, i, g.type, getattr(g, "dict_ref", None))
        )
        wave_names.append(f"k{i}")
    for j, wa in enumerate(wave_aggs):
        wave_targets.append(E.InputRef(0, k + j, wa.type))
        wave_names.append(f"p{j}")
    return wave_aggs, wave_targets, wave_names, fin


def make_leaf_node(node: R.Compound) -> Tuple[R.Compound, list, list]:
    """The per-partition (leaf/wave) Compound: same joins/filter/groups,
    decomposed aggregates, identity targets, no having."""
    wave_aggs, wave_targets, wave_names, fin = decompose(node)
    leaf = R.Compound(
        list(node.inputs), list(node.join_levels), node.filter_cond,
        list(node.group_exprs), wave_aggs, wave_targets, wave_names, None,
    )
    return leaf, wave_aggs, fin


def make_merge_node(
    node: R.Compound,
    wave_aggs: List[E.Agg],
    fin: list,
    source: R.RelNode,
) -> R.Compound:
    """The aggregator-merge Compound over the concatenated partial rows."""
    k = len(node.group_exprs)
    merge_groups = [
        E.InputRef(0, i, g.type, getattr(g, "dict_ref", None))
        for i, g in enumerate(node.group_exprs)
    ]
    merge_aggs: List[E.Agg] = []
    for j, wa in enumerate(wave_aggs):
        ref = E.InputRef(0, k + j, wa.type)
        if wa.kind == E.AggKind.MIN:
            mk = E.AggKind.MIN
        elif wa.kind in (E.AggKind.MAX, E.AggKind.SAMPLE,
                         E.AggKind.SINGLE_VALUE):
            # SAMPLE of samples is a sample; SINGLE_VALUE partials are all
            # equal by contract — max picks one either way
            mk = E.AggKind.MAX
        else:  # COUNT/COUNT_IF/SUM/SUM_IF partials all merge by SUM
            mk = E.AggKind.SUM
        merge_aggs.append(E.Agg(mk, ref, False, wa.type))

    dbl = T.double(nullable=True)

    def finalize_expr(j: int) -> E.Expr:
        how = fin[j]
        if how[0] == "ref":
            return E.InputRef(0, k + how[1], node.aggs[j].type)
        _, spos, cpos = how
        s = E.Cast(E.InputRef(0, k + spos, wave_aggs[spos].type), dbl)
        c = E.InputRef(0, k + cpos, wave_aggs[cpos].type)
        cond = E.BinOp(
            E.BinOpKind.GT, c, E.Constant(0, T.bigint(False)),
            T.boolean(False),
        )
        div = E.BinOp(E.BinOpKind.DIV, s, E.Cast(c, dbl), dbl)
        return E.Case(
            whens=((cond, div),), else_=E.Constant(None, dbl), type=dbl
        )

    def remap_postagg(e: E.Expr) -> E.Expr:
        def sub(x):
            if isinstance(x, E.InputRef):
                if x.field_idx < k:
                    return E.InputRef(
                        0, x.field_idx, x.type, getattr(x, "dict_ref", None)
                    )
                return finalize_expr(x.field_idx - k)
            return x

        return E.rewrite(e, sub)

    merge_targets = [remap_postagg(te) for te in node.target_exprs]
    merge_having = (
        remap_postagg(node.having) if node.having is not None else None
    )
    return R.Compound(
        [source], [], None, merge_groups, merge_aggs, merge_targets,
        list(node.fields), merge_having,
    )
