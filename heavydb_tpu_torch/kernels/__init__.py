"""The hand-written CUDA kernels (B1-B6, B3a-c, J1) and their wrappers."""


def launch_counts() -> dict:
    """Each kernel wrapper's launches so far in this process, by its name
    (`counter.launches`; 0 on the CPU, where the wrappers run their plain
    versions)."""
    from heavydb_tpu_torch.kernels import (groupby_minmax, groupby_slots, join_build,
                                           lane_agg, radix_groupby, radix_hist, tile_sort)

    return {fn.__name__: fn.launches for fn in (
        lane_agg.lane_agg, radix_hist.fused_hist, groupby_minmax.minmax_per_slot,
        groupby_slots.count_per_slot, groupby_slots.sum_f32_per_slot,
        groupby_slots.sum_int_per_slot, radix_groupby.radix_partition,
        radix_groupby.radix_group, tile_sort.sort_tiles, join_build.perfect_count)}
