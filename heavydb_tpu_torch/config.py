"""Engine configuration / flag system.

Analogue of the reference's `SystemParameters` + the `g_*` globals bound by
CommandLineOptions (ThriftHandler/CommandLineOptions.cpp, 281 flags).  We keep
one dataclass; server/CLI layers map CLI/INI options onto it, and a runtime-
settable subset is exposed via ALTER SYSTEM/SESSION (reference
Catalog/DdlCommandExecutor).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass
class Config:
    # ---- storage / fragmentation ----
    # Rows per fragment (reference default 32M, Fragmenter/FragmentDefaultValues.h:19).
    # We keep fragments smaller by default so fragment-level metadata pruning has
    # granularity on typical test data; benchmarks override.
    default_fragment_rows: int = 1 << 22  # 4M
    # Device scan-cache byte budget for LRU eviction (reference BufferMgr
    # slab LRU).  0 = auto (70% of the device memory free at start-up on
    # CUDA, 8 GB on the CPU).  -1 = unbounded.
    device_cache_bytes: int = 0
    # Upload a bulk-loaded table's columns into the device scan cache at
    # load time (`Executor.prestage_table`), so that its first query does
    # not pay the upload.  None = auto (on for a CUDA device).
    eager_device_staging: "Optional[bool]" = None
    # Minimum rows before eager staging bothers (tiny tables stage
    # on-demand at negligible cost)
    eager_staging_min_rows: int = 1 << 20
    # Fragment-wave streaming threshold: a decomposable aggregate or an
    # ORDER BY ... LIMIT over one table whose needed column bytes pass this
    # runs in waves, the partials merged on the device, so that tables
    # larger than device memory stay queryable (reference
    # gpu_input_mem_limit punt-to-CPU / out-of-core).  0 = auto (cache
    # budget / 2); -1 disables streaming.
    stream_threshold_bytes: int = 0
    # Row cap per wave of a streamed ORDER BY ... LIMIT (the top-k select's
    # temporaries are several bytes a row; an uncapped 1B-row wave would
    # exhaust device memory).
    topk_stream_row_cap: int = 1 << 26

    # ---- group-by ----
    # Dense-range ceiling: group keys whose ranges span more slots than
    # this (their product) take the hash or the sort tier.
    baseline_groupby_threshold: int = 1 << 24
    # Above this many dense slots the perfect tier's per-slot buffers give
    # way to the radix tier (or the sort tier), which allocates nothing
    # [slots]-sized.
    sortagg_min_slots: int = 1 << 20
    # The hash group-by tier: multi-round slot claims for sparse keys, and
    # COUNT(DISTINCT)'s hash form past 2^21 rows (the reference's rule).
    # Off on this runtime, where the sort tier serves sparse keys; flip it
    # on to re-evaluate.
    enable_hash_groupby: bool = False
    # col || col between two dict-encoded strings builds a DENSE |L|x|R|
    # pairwise translation table at launch; this caps the cross-product
    # size (4M pairs intern in ~0.2s via the native dictionary).
    pair_concat_max_entries: int = 1 << 22
    # The radix tier (exec/radix_tier.py, hand kernels B5 and B6; the
    # counterpart of the reference's baseline-hash group-by,
    # GroupByRuntime.cpp:25): dense key spaces past sortagg_min_slots whose
    # aggregates fit its streams.  A skewed partition or the int-limb
    # exactness bound falls back to the sort tier through the retry ladder.
    enable_radix_groupby: bool = True
    # The sort tier's first group capacity where nothing bounds the keys; a
    # run with more groups sizes itself from its own count.
    baseline_groupby_initial_entries: int = 1 << 14

    # ---- joins ----
    # Max dense key range for the perfect join-hash-table path
    # (reference PerfectJoinHashTable).
    perfect_join_max_range: int = 1 << 26
    # Dynamic selectivity probe (reference JoinFilterPushDown.cpp +
    # find_push_down_candidates re-plan loop): before the runtime join
    # reorder, count the rows surviving each input's single-input WHERE
    # conjuncts on the device, so the build/probe decision sees
    # POST-filter cardinalities.  Counts are cached per (conjuncts,
    # table generation).
    enable_selectivity_probe: bool = True

    # ---- execution ----
    enable_watchdog: bool = False
    watchdog_max_projected_rows: int = 128_000_000
    enable_dynamic_watchdog: bool = False
    dynamic_watchdog_time_limit_ms: int = 0
    # session lifecycle eviction (reference Catalog/SessionsStore.cpp);
    # 0 disables
    idle_session_duration_s: int = 0
    max_session_duration_s: int = 0

    # ---- distributed ----
    # Shards of the 1-D mesh each scan is row-sharded over: n distinct
    # cards, or n virtual shards of the CPU; None or 1 = the Database's
    # device alone.
    num_shards: Optional[int] = None

    # ---- logging / debug ----
    # Each SELECT's scope tree (`Database.last_query_timings`)
    enable_debug_timer: bool = False

    # admission control (reference ExecutorResourceMgr; enable-executor-
    # resource-mgr + executor-cpu-result-mem-ratio style knobs)
    enable_executor_resource_mgr: bool = True
    max_concurrent_queries: int = 4
    max_exec_bytes: int = 0  # 0 = unlimited
    admission_queue_timeout_s: float = 300.0

    def clone(self, **overrides) -> "Config":
        return dataclasses.replace(self, **overrides)


DEFAULT = Config()
