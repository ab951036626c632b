"""Device approximate seed search: masked-frontier scheme traversal.

The device replacement for the recursive search_ng21 tree walk
(search.cpp:173-188, BASELINE.json north star: "FM-index approximate search
... as batched rank-query gathers in JAX"). Instead of a per-seed DFS, the
whole read batch's seeds advance together as a FRONTIER of bidirectional
cursor states:

  state = (lb, lb_rev, length, search_idx, part_idx, char_pos,
           errors, last_op, seed_id)

One jitted iteration expands every active state by one pattern position —
match, 4 substitutions, 5 insertions and a deletion, up to 11 children per
state — where every child interval comes from ONE pair of combined
rank-row gathers (checkpoint + bit planes per row, device_index
rank_rows_lookup). Children are compacted into the fixed-capacity frontier
with a scatter+cummax repeat-by-counts construction and a single row
gather (scatters/gathers are per-row latency-bound, so the
per-iteration launch count is the cost model); states that complete their
search's last part persist as done rows and are extracted at the end.
Part-boundary bookkeeping reads one fused [T, 8] scheme row per state.
The production chunk path (_run_chunk_fused) runs a whole chunk's seeds
as ONE global-frontier dispatch per capacity slice, with early exit on
eviction and a doubled-capacity retry.

Semantics vs the host DFS (search_host.search_seed_groups): EXACT,
including report order and cap behavior. The frontier is maintained in
DFS order throughout: every state's replacement block (itself when done
or part-advancing, else its children in the host DFS's edge order —
match, substitutions by symbol, insertions by symbol, deletion) is
compacted in place, so a prefix ordering of the search tree is preserved
at every iteration; finished states become DONE rows that hold their
frontier slot until the scan ends, and reading the final frontier in slot
order yields the exact DFS leaf order. Host-side post-processing then
replays the host's dedup-by-(lb, len, errors)-keeping-first and the
running-total cap abort (search.cpp:173-188) over that ordered stream,
which reproduces the native DFS's (groups, total, aborted) bit-exactly —
hard/soft-cap decisions and anchor choice match the host even when the
caps bind. Seeds that overflow the frontier or report capacity are
flagged and re-searched on the host path.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .alphabet import SIGMA
from .index.device_index import DeviceIndex, rank_all
from .schemes import ExpandedSearch, expand_scheme

_EDIT_SYMBOLS = (1, 2, 3, 4, 5)

# last_op codes
_OP_M, _OP_I, _OP_D = 0, 1, 2


# chunk-level batching geometry: seeds per device dispatch and the shared
# frontier/report budgets of one dispatch. 256 seeds per block collapses a
# 250-read chunk (~50-100k seeds at longread error budgets) into a few
# hundred device calls instead of one call per (query, length class) — the
# difference between per-dispatch latency dominating and amortizing away.
# The frontier budget is SHARED across a block's seeds (live states are
# bursty and anti-correlated); seeds whose states or reports get evicted
# are re-searched by the native DFS. Env-tunable for per-chip calibration:
# iteration cost scales with FRONTIER, eviction rate falls with it.
import os as _os

_BLOCK_SEEDS = int(_os.environ.get("FLOXER_TPU_SEARCH_BLOCK_SEEDS", 256))
_BLOCK_FRONTIER = int(
    _os.environ.get("FLOXER_TPU_SEARCH_BLOCK_FRONTIER", 1 << 15)
)
_BLOCK_REPORTS = int(
    _os.environ.get("FLOXER_TPU_SEARCH_BLOCK_REPORTS", 1 << 13)
)
# max frontier-search executions in flight before draining results to the
# host (see search_seeds_many stage 1: bounds the live device buffers)
_INFLIGHT_BLOCKS = max(
    1, int(_os.environ.get("FLOXER_TPU_SEARCH_INFLIGHT_BLOCKS", 4))
)
# longest pattern the frontier search will dispatch: the scan length, and
# so one execution's duration, grows with the pattern. Longer seeds fall
# back to the native DFS redo path, which is faster for them anyway. The
# bound is not measured on the GPU yet.
_MAX_DEVICE_PATTERN = int(
    _os.environ.get("FLOXER_TPU_SEARCH_MAX_PATTERN", 112)
)
_LEN_QUANTUM = 32  # pattern pad quantum: bounds the jit key count
# device search engine: "workqueue" = the round-5 stack-ordered work
# queue (search_queue.py, total-work-bounded), "frontier" = the round-4
# synchronous global frontier (peak-width-bounded; kept for ablation)
_SEARCH_ENGINE = _os.environ.get("FLOXER_TPU_SEARCH_ENGINE", "workqueue")


def _gather_padded_patterns(arrays, sel, pad_len):
    """[len(sel), pad_len] int32 pattern block from the chunk's flat seed
    buffer: offsets broadcast + in-range mask + clamped gather (shared by
    the fused chunk path and the legacy block loop)."""
    gather = arrays.offsets_g[sel][:, None] + np.arange(
        pad_len, dtype=np.int64
    )
    in_range = (
        np.arange(pad_len, dtype=np.int64)[None, :]
        < arrays.length_g[sel][:, None]
    )
    return np.where(
        in_range,
        arrays.buffer[np.minimum(gather, arrays.buffer.shape[0] - 1)],
        0,
    ).astype(np.int32)


class DeviceSearcher:
    """Drop-in Searcher that discovers anchor groups with the device
    frontier search, then reuses the host post-processing (caps, ordering,
    choice strategies, dominance sweep). Seeds that overflow the device
    buffers transparently fall back to the host DFS."""

    # one fused dispatch per chunk (default) vs the legacy loop of one
    # dispatch per [_BLOCK_SEEDS]-seed block per error class. The sharded
    # searcher overrides this: its shard_map program is per-block.
    _one_dispatch_chunk = not _os.environ.get(
        "FLOXER_TPU_SEARCH_NO_CHUNK_FUSE"
    )
    # counts fused chunk dispatches for tests/diagnostics
    _chunk_dispatches = 0

    def __init__(self, host_searcher, device_index: DeviceIndex):
        self._host = host_searcher
        self._device_index = device_index
        self.index = host_searcher.index
        self.num_reference_sequences = host_searcher.num_reference_sequences
        self.config = host_searcher.config

    def _run_search(self, patterns, errors, expanded):
        return search_seeds_device(
            self._device_index,
            patterns,
            errors,
            expanded,
            max_total_count=self._host.search_cap(),
        )

    def _run_block(
        self, padded, seed_class, tables, frontier_cap, report_cap, max_iter
    ):
        """One fixed-shape frontier dispatch; returns device arrays so the
        caller can overlap several blocks before synchronizing."""
        return _frontier_search(
            self._device_index,
            jnp.asarray(padded),
            jnp.asarray(seed_class),
            tables.start,
            tables.end,
            tables.direction,
            tables.lower,
            tables.upper,
            tables.num_searches,
            tables.num_parts,
            frontier_cap,
            report_cap,
            max_iter,
        )

    def _run_chunk_fused(self, arrays):
        """ONE device dispatch for a whole chunk's eligible seeds: every
        (errors, length) pair becomes a class of one unified SchemeTables
        (heterogeneous padding, see from_length_classes), seeds are packed
        into [num_blocks, _BLOCK_SEEDS, pad_len] in gid order, and
        _frontier_search_chunk scans the blocks inside a single jitted
        program. Returns (report rows [k, 5] = gid, lb, lb_rev, len, err;
        overflow gids)."""
        eligible = np.flatnonzero(arrays.length_g <= _MAX_DEVICE_PATTERN)
        if eligible.size == 0:
            return (
                np.zeros((0, 5), dtype=np.int64),
                np.zeros(0, dtype=np.int64),
            )
        err_len = np.stack(
            [arrays.errors_g[eligible], arrays.length_g[eligible]], axis=1
        )
        uniq_pairs, class_of = np.unique(
            err_len, axis=0, return_inverse=True
        )
        # numpy 2.0.0 returns a 2-D inverse for axis-unique (fixed in
        # 2.0.1); flatten defensively since the dependency is unpinned
        class_of = np.asarray(class_of).reshape(-1)
        class_searches = [
            expand_scheme(int(e), int(length)) for e, length in uniq_pairs
        ]
        tables = SchemeTables.from_length_classes(class_searches)
        # tight pad: every pad iteration runs the full per-iteration cost
        # for the whole frontier, so quantize at 8 (a ~40-char seed padded
        # to 64 wasted 40% of the scan)
        pad_len = -(-int(arrays.length_g[eligible].max()) // 8) * 8
        max_iterations = (
            pad_len + int(uniq_pairs[:, 0].max()) + 2 * tables.num_parts + 2
        )

        patterns = _gather_padded_patterns(arrays, eligible, pad_len)

        if _SEARCH_ENGINE == "workqueue":
            # round-5 stack-ordered work queue: total-work-bounded, so no
            # spike sizing and no slice split — the whole chunk is one
            # stack (search_queue module docstring)
            return self._dispatch_workqueue(
                patterns,
                class_of,
                eligible,
                tables,
                int(uniq_pairs[:, 0].max()),
            )

        # GLOBAL-frontier geometry (round 4): per-iteration cost is
        # row-count bound (~30 ns/row/launch), so one shared frontier
        # covering as many seeds as fits beats any small-block split
        # (measured 27x at chr21 scale). The capacity must cover the
        # BRANCHING SPIKE: the frontier holds the full init width for the
        # ~13 context chars it takes intervals to become specific, then
        # every seed reaches its first part boundary simultaneously and
        # the error-budget branching multiplies width ~5x for a few
        # iterations (measured peak 821k states from a 160k init on the
        # chr21 chunk) before collapsing. Undersizing silently sends the
        # whole slice to the host redo path.
        def quantize(value, floor):
            value = max(int(value), floor)
            granule = 1 << max(0, value.bit_length() - 2)
            return -(-value // granule) * granule

        spike_factor = float(
            # measured on the chr21 chunk: untruncated burst peak lands in
            # (27, 35] states/seed ~ 13x num_searches; starting at the
            # measured factor skips a guaranteed-to-overflow first attempt
            _os.environ.get("FLOXER_TPU_SEARCH_SPIKE_FACTOR", "13")
        )
        cap_frontier = int(
            _os.environ.get("FLOXER_TPU_SEARCH_MAX_FRONTIER", 1 << 21)
        )
        per_seed = max(int(tables.num_searches * spike_factor), 1)
        # slice the chunk so each slice's spiked frontier fits the cap
        seeds_per_slice = max(cap_frontier // per_seed, 1 << 10)
        num_slices = -(-eligible.size // seeds_per_slice)
        slice_size = -(-eligible.size // num_slices)

        all_rows = []
        ovf_parts = []
        for s0 in range(0, eligible.size, slice_size):
            s1 = min(s0 + slice_size, eligible.size)
            rows, ovf = self._dispatch_slice(
                patterns[s0:s1],
                class_of[s0:s1],
                eligible[s0:s1],
                tables,
                pad_len,
                max_iterations,
                quantize,
                per_seed,
                cap_frontier,
            )
            all_rows.append(rows)
            ovf_parts.append(ovf)
        rows = (
            np.concatenate(all_rows)
            if all_rows
            else np.zeros((0, 5), dtype=np.int64)
        )
        ovf_gids = (
            np.concatenate(ovf_parts)
            if ovf_parts
            else np.zeros(0, dtype=np.int64)
        )
        return rows, np.unique(ovf_gids).astype(np.int64)

    def _dispatch_workqueue(self, patterns, class_of, gids, tables,
                            max_errors):
        """One work-queue dispatch for the chunk's eligible seeds
        (search_queue): returns (rows [k, 5] = gid, lb, lb_rev, len, err
        in per-seed host-DFS order; overflow gids). Capacity shortfalls
        retry once inside workqueue_runner; a persisting overflow routes
        every seed to the host redo, like the frontier path."""
        from .search_queue import workqueue_runner

        n = patterns.shape[0]
        pad_len = patterns.shape[1]
        S = max(int(n), 1 << 10)
        granule = 1 << max(0, S.bit_length() - 2)
        S = -(-S // granule) * granule
        pat = np.zeros((S, pad_len), dtype=np.int32)
        pat[:n] = patterns
        cls = np.full(S, tables.dead_class, dtype=np.int32)
        cls[:n] = class_of
        report_cap = max(32 * n, 1 << 13)

        rows6, overflow = workqueue_runner(
            self._device_index, pat, cls, tables, report_cap,
            pad_len, max_errors,
        )
        type(self)._chunk_dispatches += 1
        local = rows6[:, 4]
        keep = local < n
        rows = np.empty((int(keep.sum()), 5), dtype=np.int64)
        rows[:, 0] = gids[local[keep]]
        rows[:, 1] = rows6[keep, 0]  # lb
        rows[:, 2] = rows6[keep, 1]  # lb_rev
        rows[:, 3] = rows6[keep, 2]  # length
        rows[:, 4] = rows6[keep, 3]  # errors
        if overflow:
            return rows, gids.astype(np.int64)
        return rows, np.zeros(0, dtype=np.int64)

    def _dispatch_slice(
        self,
        patterns,
        class_of,
        gids,
        tables,
        pad_len,
        max_iterations,
        quantize,
        per_seed,
        cap_frontier,
    ):
        """One global-frontier dispatch for a slice of the chunk's seeds;
        on (rare) frontier eviction, ONE retry at doubled capacity before
        conceding the slice to the host redo path."""
        n = patterns.shape[0]
        S = quantize(n, 1 << 10)
        pat = np.zeros((S, pad_len), dtype=np.int32)
        pat[:n] = patterns
        cls = np.full(S, tables.dead_class, dtype=np.int32)
        cls[:n] = class_of
        gid_arr = np.zeros(S, dtype=np.int32)
        gid_arr[:n] = gids
        r_total = quantize(32 * n, 1 << 13)
        frontier = min(
            quantize(n * per_seed, max(_BLOCK_FRONTIER, 1 << 15)),
            cap_frontier,
        )

        for attempt in range(2):
            reports, count, overflow = _frontier_search_chunk(
                self._device_index,
                jnp.asarray(pat.reshape(1, S, pad_len)),
                jnp.asarray(cls.reshape(1, S)),
                jnp.asarray(gid_arr.reshape(1, S)),
                tables.start,
                tables.end,
                tables.direction,
                tables.lower,
                tables.upper,
                tables.num_searches,
                tables.num_parts,
                frontier,
                r_total,
                max_iterations,
            )
            type(self)._chunk_dispatches += 1
            overflowed = bool(np.asarray(overflow).any())
            if not overflowed or frontier >= cap_frontier:
                break
            # the overflow flag covers BOTH frontier eviction and report
            # exhaustion; grow both budgets or a report-bound slice burns
            # a guaranteed-to-fail second dispatch
            frontier = min(frontier * 2, cap_frontier)
            r_total *= 2

        count = int(np.asarray(count))
        # download only the used prefix (padded to a power of two so the
        # slice program set stays bounded)
        n_pad = 1
        while n_pad < max(count, 1):
            n_pad *= 2
        n_pad = min(n_pad, r_total)
        raw = np.asarray(reports[:n_pad])[:count]
        rows = np.empty((count, 5), dtype=np.int64)
        rows[:, 0] = raw[:, 4]  # gid (written on device)
        rows[:, 1:] = raw[:, :4]
        if overflowed:
            # evicted slice: every seed redoes on the host DFS (its
            # partial rows are discarded by the caller's redo mask)
            return rows, gids.astype(np.int64)
        return rows, np.zeros(0, dtype=np.int64)

    def _legacy_block_loop(self, arrays, inflight, drain_one):
        """One _run_block dispatch per [_BLOCK_SEEDS]-seed block per error
        class (the pre-round-4 execution shape; the sharded searcher's
        shard_map program still runs this way)."""
        for errors in np.unique(arrays.errors_g).tolist():
            sel = np.flatnonzero(
                (arrays.errors_g == errors)
                & (arrays.length_g <= _MAX_DEVICE_PATTERN)
            )
            if sel.shape[0] == 0:
                continue
            lengths = arrays.length_g[sel]
            uniq_lens, len_class = np.unique(lengths, return_inverse=True)
            class_searches = [
                expand_scheme(errors, int(length)) for length in uniq_lens
            ]
            tables = SchemeTables.from_length_classes(class_searches)
            pad_len = -(-int(uniq_lens.max()) // _LEN_QUANTUM) * _LEN_QUANTUM
            max_iterations = (
                pad_len + int(errors) + 2 * tables.num_parts + 2
            )
            # gather all patterns of this class: [n_sel, pad_len]
            patterns = _gather_padded_patterns(arrays, sel, pad_len)

            for base in range(0, sel.shape[0], _BLOCK_SEEDS):
                stop = min(base + _BLOCK_SEEDS, sel.shape[0])
                n_real = stop - base
                padded = np.zeros((_BLOCK_SEEDS, pad_len), dtype=np.int32)
                padded[:n_real] = patterns[base:stop]
                seed_class = np.full(
                    _BLOCK_SEEDS, tables.dead_class, dtype=np.int32
                )
                seed_class[:n_real] = len_class[base:stop]
                out = self._run_block(
                    padded,
                    seed_class,
                    tables,
                    _BLOCK_FRONTIER,
                    _BLOCK_REPORTS,
                    max_iterations,
                )
                inflight.append((out, sel[base:stop], n_real))
                while len(inflight) >= _INFLIGHT_BLOCKS:
                    drain_one()

    def search_seeds_many(self, jobs):
        """Chunk-level device search: every job's seeds (all queries of a
        read chunk, fwd and rc) are classed by error count, padded into
        fixed [_BLOCK_SEEDS, len] pattern blocks with per-seed scheme
        classes, and dispatched as a handful of frontier-search calls.
        Anchor selection over the device-found groups runs in one native
        call (select_one: caps, ordering, choice, locate, dominance —
        search.cpp:190-318); seeds that overflow the device buffers are
        re-searched by the native DFS. Results are SearchResultSoA, same
        as the host chunk path.

        Groups reach anchor selection in exact host-DFS emission order
        with the host's dedup and running-total cap replay (module
        docstring), so output matches the host chunk path bit-exactly —
        including when the anchor caps bind."""
        import os

        from .native import (
            get_library,
            native_search_select_batch_offsets,
            native_select_from_groups_batch,
        )
        from .search_host import (
            AnchorChoiceStrategy,
            AnchorGroupOrder,
            assemble_chunk_seed_arrays,
            build_soa_results,
        )

        if not jobs:
            return []
        if os.environ.get("FLOXER_TPU_NO_NATIVE_SELECT") or (
            get_library() is None
        ):
            # no native select: per-query device path (slower, same output)
            return [self.search_seeds(s, q) for s, q in jobs]

        config = self.config
        order_code = {
            AnchorGroupOrder.COUNT_FIRST: 0,
            AnchorGroupOrder.ERRORS_FIRST: 1,
            AnchorGroupOrder.NONE: 2,
        }[config.anchor_group_order]
        choice_code = {
            AnchorChoiceStrategy.ROUND_ROBIN: 0,
            AnchorChoiceStrategy.FULL_GROUPS: 1,
            AnchorChoiceStrategy.FIRST_REPORTED: 2,
        }[config.anchor_choice_strategy]

        arrays = assemble_chunk_seed_arrays(jobs)
        total_seeds = arrays.total_seeds
        buffer = arrays.buffer

        # ---- stage 1: device group discovery, one error class at a time,
        # async across a BOUNDED window of in-flight blocks. Unbounded
        # accumulation (sync once at the end) would keep hundreds of queued
        # frontier scans, each with a live [frontier, report] buffer set,
        # in device memory at chunk scale. Draining a block's reports to
        # host after a small overlap window keeps at most _INFLIGHT_BLOCKS
        # live executions while still hiding dispatch latency behind
        # device compute.
        inflight = []  # (device results, gids, n_real)
        pending = []  # (host reports, num_reports, overflow, gids, n_real)

        def drain_one():
            (d_reports, d_num, d_overflow), gids, n_real = inflight.pop(0)
            pending.append(
                (
                    np.asarray(d_reports),
                    int(d_num),
                    np.asarray(d_overflow),
                    gids,
                    n_real,
                )
            )
        # seeds longer than _MAX_DEVICE_PATTERN never go to the device: the
        # frontier scan's iteration count grows with the pattern (see
        # constant above).
        # They join the native-DFS redo set, which is faster for them anyway.
        long_gids = np.flatnonzero(arrays.length_g > _MAX_DEVICE_PATTERN)

        report_rows = []  # each [k, 5]: gid, lb, lb_rev, len, err
        overflow_gids = []
        if self._one_dispatch_chunk:
            # ONE device dispatch for the whole chunk (all error classes,
            # all length classes): see _frontier_search_chunk
            rows, ovf_gids = self._run_chunk_fused(arrays)
            report_rows.append(rows)
            overflow_gids.append(ovf_gids)
        else:
            self._legacy_block_loop(arrays, inflight, drain_one)
            while inflight:
                drain_one()
            for reports, num_reports, overflow, gids, n_real in pending:
                reports = reports[:num_reports]
                local = reports[:, 4]
                keep = local < n_real
                rows = np.empty((int(keep.sum()), 5), dtype=np.int64)
                rows[:, 0] = gids[local[keep]]
                rows[:, 1:] = reports[keep, :4]
                report_rows.append(rows)
                overflow_gids.append(
                    gids[np.flatnonzero(overflow[:n_real])]
                )

        redo_parts = [long_gids] + (
            [np.concatenate(overflow_gids)] if overflow_gids else []
        )
        redo = np.unique(np.concatenate(redo_parts))
        redo_set_mask = np.zeros(total_seeds, dtype=bool)
        redo_set_mask[redo] = True

        # ---- stage 2: vectorized order-preserving dedup + cap replay ----
        # Reports arrive in frontier slot order: per-seed DFS order, but
        # interleaved across a block's seeds. A stable per-gid grouping,
        # keep-first dedup and running-total cap replay reproduce the host
        # DFS's exact (groups, total, aborted) per seed (search.cpp:173-188)
        # — group ORDER feeds the unstable introsort in select_one, so even
        # the no-cap case needs DFS emission order for bit-exact parity.
        rep = (
            np.concatenate(report_rows)
            if report_rows
            else np.zeros((0, 5), dtype=np.int64)
        )
        if rep.shape[0]:
            rep = rep[~redo_set_mask[rep[:, 0]]]
        statuses = np.zeros(total_seeds, dtype=np.int64)
        if rep.shape[0]:
            # stable per-gid grouping preserves per-seed DFS order
            rep = rep[np.argsort(rep[:, 0], kind="stable")]
            # keep-first dedup by (gid, lb, len, err): lexsort is stable, so
            # the first row of each equal-key run is the first DFS report
            perm = np.lexsort((rep[:, 4], rep[:, 3], rep[:, 1], rep[:, 0]))
            key = rep[perm][:, [0, 1, 3, 4]]
            first = np.ones(rep.shape[0], dtype=bool)
            first[1:] = np.any(key[1:] != key[:-1], axis=1)
            rep = rep[np.sort(perm[first])]
        gid_of_group = rep[:, 0]

        if rep.shape[0]:
            # cap replay (search_cap): group kept iff the running total
            # BEFORE it is under the cap; the crossing group is included
            # and the seed is marked aborted (status bit 0)
            cap = self._host.search_cap()
            csum = np.cumsum(rep[:, 3])
            seg_first = np.ones(rep.shape[0], dtype=bool)
            seg_first[1:] = gid_of_group[1:] != gid_of_group[:-1]
            base = np.zeros(rep.shape[0], dtype=np.int64)
            starts_pos = np.flatnonzero(seg_first)
            base[starts_pos] = csum[starts_pos] - rep[starts_pos, 3]
            base = np.maximum.accumulate(base)
            running = csum - base
            keep = (running - rep[:, 3]) < cap
            seed_aborted = np.zeros(total_seeds, dtype=bool)
            np.logical_or.at(
                seed_aborted, gid_of_group[keep], running[keep] >= cap
            )
            statuses[seed_aborted] = 1
            rep = rep[keep]
            running = running[keep]
            gid_of_group = rep[:, 0]
        groups_flat = rep[:, [1, 2, 3, 4]]

        group_counts = np.bincount(gid_of_group, minlength=total_seeds)
        group_starts = np.zeros(total_seeds + 1, dtype=np.int64)
        np.cumsum(group_counts, out=group_starts[1:])
        totals = np.zeros(total_seeds, dtype=np.int64)
        if rep.shape[0]:
            # truncated running total at each seed's stop point
            last_pos = group_starts[1:][group_counts > 0] - 1
            totals[np.unique(gid_of_group)] = running[last_pos]

        # ---- stage 3: anchor selection over the found groups ----
        # On device (caps, ordering, choice, locate, dominance as batched
        # segmented ops — search_select_device, bit-identical to the native
        # select) when FLOXER_TPU_DEVICE_SELECT is set; native C++ otherwise
        # (one dispatch per chunk is a latency trade that needs
        # per-deployment calibration).
        out = None
        if os.environ.get("FLOXER_TPU_DEVICE_SELECT") and getattr(
            self, "_device_index", None
        ) is not None:
            from .search_select_device import device_select_from_groups_batch

            out = device_select_from_groups_batch(
                self._device_index,
                groups_flat,
                group_starts,
                totals,
                statuses,
                config.max_num_anchors_hard,
                config.max_num_anchors_soft,
                order_code,
                choice_code,
                config.erase_useless_anchors,
            )
        if out is None:
            out = native_select_from_groups_batch(
                self.index,
                groups_flat,
                group_starts,
                totals,
                statuses,
                config.max_num_anchors_hard,
                config.max_num_anchors_soft,
                order_code,
                choice_code,
                config.erase_useless_anchors,
                self._host.num_threads,
            )
        if out is None:  # library vanished mid-run; per-query fallback
            return [self.search_seeds(s, q) for s, q in jobs]
        anchors_arr, counts = out

        nw_g = np.zeros(total_seeds, dtype=np.int64)
        kept_raw_g = np.zeros(total_seeds, dtype=np.int64)
        kept_useful_g = np.zeros(total_seeds, dtype=np.int64)
        excluded_soft_g = np.zeros(total_seeds, dtype=np.int64)
        rows_parts: list[np.ndarray] = []
        gid_parts: list[np.ndarray] = []

        status = counts[:, 0]
        nw = counts[:, 1]
        ok = ((status & 6) == 0) & ~redo_set_mask
        nw = np.where(ok, nw, 0)
        sub = np.flatnonzero(ok)
        nw_g[sub] = nw[sub]
        kept_raw_g[sub] = counts[sub, 2]
        kept_useful_g[sub] = counts[sub, 3]
        excluded_soft_g[sub] = counts[sub, 4] - counts[sub, 2]
        valid = (
            np.arange(anchors_arr.shape[1], dtype=np.int64)[None, :]
            < nw[:, None]
        )
        rows_parts.append(anchors_arr[valid])
        gid_parts.append(np.repeat(np.arange(total_seeds), nw))

        # ---- stage 4: native DFS redo for device-overflow seeds ----
        if redo.shape[0]:
            redo_key = (
                arrays.length_g[redo] * 4096 + arrays.errors_g[redo]
            )
            for key_value in np.unique(redo_key).tolist():
                cls_sel = redo[redo_key == key_value]
                length, errors = key_value // 4096, key_value % 4096
                out = native_search_select_batch_offsets(
                    self.index,
                    buffer,
                    arrays.offsets_g[cls_sel],
                    expand_scheme(int(errors), int(length)),
                    self._host.search_cap(),
                    config.max_num_anchors_hard,
                    config.max_num_anchors_soft,
                    order_code,
                    choice_code,
                    config.erase_useless_anchors,
                    self._host.num_threads,
                )
                if out is None:
                    return [self.search_seeds(s, q) for s, q in jobs]
                r_anchors, r_counts = out
                r_status = r_counts[:, 0]
                r_nw = np.where((r_status & 6) == 0, r_counts[:, 1], 0)
                r_ok = np.flatnonzero((r_status & 6) == 0)
                nw_g[cls_sel[r_ok]] = r_nw[r_ok]
                kept_raw_g[cls_sel[r_ok]] = r_counts[r_ok, 2]
                kept_useful_g[cls_sel[r_ok]] = r_counts[r_ok, 3]
                excluded_soft_g[cls_sel[r_ok]] = (
                    r_counts[r_ok, 4] - r_counts[r_ok, 2]
                )
                r_valid = (
                    np.arange(r_anchors.shape[1], dtype=np.int64)[None, :]
                    < r_nw[:, None]
                )
                rows_parts.append(r_anchors[r_valid])
                gid_parts.append(np.repeat(cls_sel, r_nw))
                # native-side group-buffer overflow (status&2) would need a
                # third fallback tier; the buffer is sized past the hard
                # cap, so it cannot trigger outside first_reported abuse —
                # guard anyway by re-searching per seed on the host
                hard_redo = np.flatnonzero(r_status & 2)
                for gid in cls_sel[hard_redo].tolist():
                    self._redo_seed_host(
                        int(gid), arrays, jobs, nw_g, kept_raw_g,
                        kept_useful_g, excluded_soft_g, rows_parts,
                        gid_parts,
                    )

        return build_soa_results(
            arrays,
            nw_g,
            kept_raw_g,
            kept_useful_g,
            excluded_soft_g,
            rows_parts,
            gid_parts,
        )

    def _redo_seed_host(
        self, gid, arrays, jobs, nw_g, kept_raw_g, kept_useful_g,
        excluded_soft_g, rows_parts, gid_parts,
    ):
        """Last-resort per-seed host redo (native group buffer overflow)."""
        from .search_host import search_seed_groups

        job_idx = int(arrays.job_g[gid])
        seed_idx = gid - int(arrays.job_seed_base[job_idx])
        seeds, query = jobs[job_idx]
        qpos = int(arrays.qpos_g[gid])
        length = int(arrays.length_g[gid])
        groups, total, _ = search_seed_groups(
            self.index,
            query[qpos : qpos + length],
            int(arrays.errors_g[gid]),
            self._host.search_cap(),
        )
        aos = self._host.process_seed_groups(seeds[seed_idx], groups, total)
        rows = np.array(
            [
                (a.reference_id, a.reference_position, a.num_errors)
                for anchors in aos.anchors_by_reference
                for a in anchors
            ],
            dtype=np.int64,
        ).reshape(-1, 3)
        nw_g[gid] = rows.shape[0]
        kept_raw_g[gid] = aos.num_kept_raw_anchors
        kept_useful_g[gid] = aos.num_kept_useful_anchors
        excluded_soft_g[gid] = aos.num_excluded_raw_anchors_by_soft_cap
        rows_parts.append(rows)
        gid_parts.append(np.full(rows.shape[0], gid, dtype=np.int64))

    def search_seeds(self, seeds, query):
        from .schemes import expand_scheme
        from .search_host import (
            AnchorGroup,
            SearchResult,
            search_seed_groups,
        )
        from .index.fmindex import Cursor

        result = SearchResult()
        result.anchors_by_seed = [None] * len(seeds)

        buckets: dict[tuple[int, int], list[int]] = {}
        for i, seed in enumerate(seeds):
            buckets.setdefault((seed.length, seed.num_errors), []).append(i)

        for (length, errors), indices in buckets.items():
            patterns = [
                query[
                    seeds[i].query_position : seeds[i].query_position + length
                ]
                for i in indices
            ]
            if length > _MAX_DEVICE_PATTERN:
                # watchdog guard (see _MAX_DEVICE_PATTERN): long seeds run
                # the host DFS directly instead of a device dispatch
                for slot, i in enumerate(indices):
                    groups, total_raw, _ = search_seed_groups(
                        self.index,
                        patterns[slot],
                        errors,
                        self._host.search_cap(),
                    )
                    result.anchors_by_seed[i] = (
                        self._host.process_seed_groups(
                            seeds[i], groups, total_raw
                        )
                    )
                continue
            expanded = expand_scheme(errors, length)
            groups_per_seed, totals, _aborted, overflow = self._run_search(
                patterns, errors, expanded
            )
            for slot, i in enumerate(indices):
                if overflow[slot]:
                    groups, total_raw, _ = search_seed_groups(
                        self.index,
                        patterns[slot],
                        errors,
                        self._host.search_cap(),
                    )
                else:
                    groups = [
                        AnchorGroup(Cursor(lb, lb_rev, ln), er)
                        for lb, lb_rev, ln, er in groups_per_seed[slot]
                    ]
                    total_raw = int(totals[slot])
                result.anchors_by_seed[i] = self._host.process_seed_groups(
                    seeds[i], groups, total_raw
                )
        return result


@dataclass(frozen=True)
class SchemeTables:
    """Expanded-search tables as device arrays [num_classes, num_searches,
    num_parts]. One CLASS per distinct pattern length of one error count
    (same error count => same search count and part count, only the part
    spans differ), so seeds of many different lengths share a single
    frontier-search dispatch — the chunk-level batching that amortizes the
    host->device round trip over every seed of a read chunk.

    Class `num_real` (and any power-of-two padding rows after it) is the
    DEAD class for padding seeds: its parts are the empty span [0, 0) with
    direction +1 and lower bound 1, so a padding state hits the part
    boundary immediately, fails the lower bound, and dies without ever
    expanding or reporting."""

    start: jnp.ndarray
    end: jnp.ndarray
    direction: jnp.ndarray
    lower: jnp.ndarray
    upper: jnp.ndarray
    num_classes: int
    num_real: int
    num_searches: int
    num_parts: int

    @property
    def dead_class(self) -> int:
        return self.num_real

    @classmethod
    def from_length_classes(
        cls, class_searches: list[tuple[ExpandedSearch, ...]]
    ):
        """Classes may be heterogeneous (different error counts => different
        search and part counts): shapes pad to the maxima. A class's missing
        SEARCHES get dead rows (empty span, lower 1: the initial state dies
        at its first boundary check without expanding or reporting). A
        search's missing trailing PARTS become continuation pads (empty
        span, direction +1, lower/upper copied from the search's last real
        part): a state finishing the real scheme steps through each pad in
        one boundary-advance iteration and reports at the global last part
        — same reports, same DFS order."""
        num_real = len(class_searches)
        num_searches = max(len(s) for s in class_searches)
        num_parts = max(
            len(search.pi)
            for searches in class_searches
            for search in searches
        )
        num_classes = 2
        while num_classes < num_real + 1:
            num_classes *= 2
        start = np.zeros((num_classes, num_searches, num_parts), dtype=np.int32)
        end = np.zeros_like(start)
        # dead-class defaults for every padding row
        direction = np.ones_like(start)
        lower = np.ones_like(start)
        upper = np.zeros_like(start)
        for c, searches in enumerate(class_searches):
            for s, search in enumerate(searches):
                real_parts = len(search.pi)
                for j in range(real_parts):
                    start[c, s, j], end[c, s, j] = search.part_spans[j]
                    direction[c, s, j] = search.directions[j]
                    lower[c, s, j] = search.lower[j]
                    upper[c, s, j] = search.upper[j]
                for j in range(real_parts, num_parts):
                    start[c, s, j] = end[c, s, j] = 0
                    direction[c, s, j] = 1
                    lower[c, s, j] = search.lower[real_parts - 1]
                    upper[c, s, j] = search.upper[real_parts - 1]
        return cls(
            jnp.asarray(start),
            jnp.asarray(end),
            jnp.asarray(direction),
            jnp.asarray(lower),
            jnp.asarray(upper),
            num_classes,
            num_real,
            num_searches,
            num_parts,
        )

    @classmethod
    def from_searches(cls, searches: tuple[ExpandedSearch, ...]):
        return cls.from_length_classes([list(searches)])


def _frontier_block(
    index,
    patterns,  # int32 [num_seeds, max_len] padded
    seed_class,  # int32 [num_seeds] scheme-class per seed
    scheme_start,  # int32 [num_classes, num_searches, num_parts]
    scheme_end,
    scheme_direction,
    scheme_lower,
    scheme_upper,
    num_searches: int,
    num_parts: int,
    frontier_capacity: int,
    max_iterations: int,
):
    """One block's frontier program: initial frontier, expand scan,
    returning (final_state, overflow [num_seeds]). Shared by the
    per-block jit (_frontier_search) and the one-dispatch chunk program
    (_frontier_search_chunk)."""
    num_seeds = patterns.shape[0]
    C = frontier_capacity
    from .index.device_index import index_size

    n = index_size(index.fwd)

    # initial frontier: one state per (seed, search) — search-minor order
    # matches the host's `for search in expanded` loop per seed
    init_count = num_seeds * num_searches
    # a frontier smaller than the initial state set is an immediate
    # eviction, not a trace-time crash: fill what fits and let the
    # overflow flag route the block to the host redo like every other
    # capacity shortfall
    init_overflow = init_count > C
    init_count = min(init_count, C)
    seed0 = jnp.repeat(
        jnp.arange(num_seeds, dtype=jnp.int32), num_searches
    )[:init_count]
    search0 = jnp.tile(
        jnp.arange(num_searches, dtype=jnp.int32), num_seeds
    )[:init_count]
    cls0 = seed_class[seed0]

    def blank(value, dtype=jnp.int32):
        return jnp.full((C,), value, dtype=dtype)

    first_part = scheme_start[cls0, search0, 0] * (
        scheme_direction[cls0, search0, 0] > 0
    ) + (scheme_end[cls0, search0, 0] - 1) * (
        scheme_direction[cls0, search0, 0] < 0
    )

    state = {
        "lb": blank(0).at[:init_count].set(0),
        "lb_rev": blank(0).at[:init_count].set(0),
        "length": blank(0).at[:init_count].set(n),
        "search": blank(0).at[:init_count].set(search0),
        "part": blank(0),
        "pos": blank(0).at[:init_count].set(first_part),
        "errors": blank(0),
        "last_op": blank(_OP_M),
        "seed": blank(0).at[:init_count].set(seed0),
        "done": jnp.zeros((C,), dtype=bool),
        "present": jnp.zeros((C,), dtype=bool).at[:init_count].set(True),
    }

    overflow0 = jnp.asarray(init_overflow)  # scalar: any eviction

    # fused scheme-row table: ONE [T, 8] row per (class, search, part)
    # carrying every scalar the expand step needs — direction, start, end,
    # lower, upper, and the NEXT part's direction/start/end — so the eight
    # 3D table gathers per iteration collapse into one row gather. Built
    # from the input tables at trace time; loop-invariant, hoisted out of
    # the scan by XLA.
    def roll_next(table):
        return jnp.concatenate([table[:, :, 1:], table[:, :, -1:]], axis=2)

    scheme_fused = jnp.stack(
        [
            scheme_direction,
            scheme_start,
            scheme_end,
            scheme_lower,
            scheme_upper,
            roll_next(scheme_direction),
            roll_next(scheme_start),
            roll_next(scheme_end),
        ],
        axis=3,
    ).reshape(-1, 8)

    def expand(carry, _):
        state, overflow = carry
        present = state["present"]
        alive = present & ~state["done"]

        search = state["search"]
        cls = seed_class[state["seed"]]
        part = jnp.clip(state["part"], 0, num_parts - 1)
        fused_idx = (cls * num_searches + search) * num_parts + part
        row = scheme_fused[fused_idx]  # [C, 8]
        direction = row[:, 0]
        p_start = row[:, 1]
        p_end = row[:, 2]
        lower = row[:, 3]
        upper = row[:, 4]

        pos = state["pos"]
        at_boundary = jnp.where(
            direction > 0, pos >= p_end, pos < p_start
        ) & alive

        # ---- boundary bookkeeping (no extension) ----
        meets_lower = state["errors"] >= lower
        finished = at_boundary & meets_lower & (state["part"] == num_parts - 1)
        advancing = at_boundary & meets_lower & ~finished
        # killed_lower states simply contribute no entries below

        next_first = jnp.where(
            row[:, 5] > 0,
            row[:, 6],
            row[:, 7] - 1,
        )

        # self-keeping slots: already-done rows hold their DFS position;
        # finishing rows become done in place; advancing rows step to the
        # next part without expanding
        self_keep = (state["done"] & present) | finished | advancing
        part_self = jnp.where(advancing, state["part"] + 1, state["part"])
        pos_self = jnp.where(advancing, next_first, state["pos"])
        done_self = (state["done"] & present) | finished

        # ---- character expansion for non-boundary states ----
        expanding = alive & ~at_boundary
        left = direction < 0

        lb = state["lb"]
        lb_rev = state["lb_rev"]
        length = state["length"]

        # rank gathers for both directions, masked to the needed one
        base_fwd = jnp.where(expanding, lb, 0)
        base_rev = jnp.where(expanding, lb_rev, 0)
        base = jnp.where(left, base_fwd, base_rev)
        if getattr(index, "rank_rows", None) is not None:
            # combined (checkpoint | planes) table, fwd ++ rev: the whole
            # rank pair is TWO gathers instead of eight (device_index
            # rank_rows docstring) — the dominant per-iteration cost here
            # is kernel-launch count, not bytes
            from .index.device_index import rank_rows_lookup
            from .index.fmindex import OCC_BLOCK

            pos_lo = base + jnp.where(
                left, 0, index.rev_block_offset * OCC_BLOCK
            )
            length_m = jnp.where(expanding, length, 0)
            lo = rank_rows_lookup(index.rank_rows, pos_lo)
            hi = rank_rows_lookup(index.rank_rows, pos_lo + length_m)
        else:
            lo = jnp.where(
                left[:, None],
                rank_all(index.fwd, base_fwd),
                rank_all(index.rev, base_rev),
            )
            hi = jnp.where(
                left[:, None],
                rank_all(
                    index.fwd, base_fwd + jnp.where(expanding, length, 0)
                ),
                rank_all(
                    index.rev, base_rev + jnp.where(expanding, length, 0)
                ),
            )
        if isinstance(lo, (list, tuple)):
            lo_s, hi_s = list(lo), list(hi)
        else:  # dense fallback returns [C, SIGMA]
            lo_s = [lo[:, s] for s in range(SIGMA)]
            hi_s = [hi[:, s] for s in range(SIGMA)]
        # per-symbol [C] vectors throughout: [C, SIGMA]-shaped arithmetic
        # tiles as (8, 128) with 6 lanes used — ~5% VPU efficiency; the
        # same math as SIGMA separate [C] vectors is full-width
        counts_s = [hi_s[s] - lo_s[s] for s in range(SIGMA)]
        child_lb_s, child_lb_rev_s = [], []
        secondary_base = jnp.where(left, lb_rev, lb)
        running = jnp.zeros_like(lb)
        for s in range(SIGMA):
            primary = index.C[s] + lo_s[s]
            secondary = secondary_base + running
            running = running + counts_s[s]
            child_lb_s.append(jnp.where(left, primary, secondary))
            child_lb_rev_s.append(jnp.where(left, secondary, primary))

        pattern_symbol = patterns[state["seed"], jnp.clip(state["pos"], 0, patterns.shape[1] - 1)]
        budget_left = state["errors"] < upper

        # candidate grid [C, 13], row-major = (parent slot, edge) order, so
        # the cumsum compaction below replaces every present slot by its
        # ordered block in place — the DFS-prefix invariant. Columns follow
        # the host DFS's edge order (search_host._run_scheme_search.step):
        #   0       self (done row, finishing row, or part-advancing row)
        #   1       match (child at the pattern symbol)
        #   2..6    substitutions, symbols 1..5 (pattern symbol skipped)
        #   7..11   insertions, symbols 1..5
        #   12      deletion
        def select_by_symbol(per_symbol):
            out = per_symbol[0]
            for s in range(1, SIGMA):
                out = jnp.where(pattern_symbol == s, per_symbol[s], out)
            return out

        match_lb = select_by_symbol(child_lb_s)
        match_lb_rev = select_by_symbol(child_lb_rev_s)
        match_count = select_by_symbol(counts_s)

        child_defs = [
            # self: carries done/advancing bookkeeping, fields otherwise kept
            dict(
                valid=self_keep,
                lb=lb,
                lb_rev=lb_rev,
                length=length,
                pos=pos_self,
                errors=state["errors"],
                last_op=state["last_op"],
                part=part_self,
                done=done_self,
            ),
            # match
            dict(
                valid=expanding & (match_count > 0),
                lb=match_lb,
                lb_rev=match_lb_rev,
                length=match_count,
                pos=state["pos"] + direction,
                errors=state["errors"],
                last_op=jnp.full((C,), _OP_M, dtype=jnp.int32),
                part=state["part"],
                done=jnp.zeros((C,), dtype=bool),
            ),
        ]
        # substitutions over symbols 1..5, skipping the match symbol
        for symbol in _EDIT_SYMBOLS:
            valid = (
                expanding
                & budget_left
                & (pattern_symbol != symbol)
                & (counts_s[symbol] > 0)
            )
            child_defs.append(
                dict(
                    valid=valid,
                    lb=child_lb_s[symbol],
                    lb_rev=child_lb_rev_s[symbol],
                    length=counts_s[symbol],
                    pos=state["pos"] + direction,
                    errors=state["errors"] + 1,
                    last_op=jnp.full((C,), _OP_M, dtype=jnp.int32),
                    part=state["part"],
                    done=jnp.zeros((C,), dtype=bool),
                )
            )
        # insertions (text symbol consumed, pattern position unchanged)
        for symbol in _EDIT_SYMBOLS:
            valid = (
                expanding
                & budget_left
                & (counts_s[symbol] > 0)
                & (state["last_op"] != _OP_D)
            )
            child_defs.append(
                dict(
                    valid=valid,
                    lb=child_lb_s[symbol],
                    lb_rev=child_lb_rev_s[symbol],
                    length=counts_s[symbol],
                    pos=state["pos"],
                    errors=state["errors"] + 1,
                    last_op=jnp.full((C,), _OP_I, dtype=jnp.int32),
                    part=state["part"],
                    done=jnp.zeros((C,), dtype=bool),
                )
            )
        # deletion (pattern symbol skipped, no extension)
        valid = expanding & budget_left & (state["last_op"] != _OP_I)
        child_defs.append(
            dict(
                valid=valid,
                lb=lb,
                lb_rev=lb_rev,
                length=length,
                pos=state["pos"] + direction,
                errors=state["errors"] + 1,
                last_op=jnp.full((C,), _OP_D, dtype=jnp.int32),
                part=state["part"],
                done=jnp.zeros((C,), dtype=bool),
            )
        )

        num_kinds = len(child_defs)  # 13

        def stack(field_name):
            return jnp.stack([c[field_name] for c in child_defs], axis=1)

        # ---- two-level stream compaction, scatter+cummax form ----
        # Per-iteration cost is dominated by row-count-proportional
        # gather/scatter launches (~30 ns/row on this chip), so the
        # compaction uses O(1) of them: per-row child counts and local
        # prefixes are elementwise over 13 [C] vectors; the output-slot ->
        # source-row map is ONE [C]-row scatter of row ids at the rows'
        # output offsets followed by a cummax (the classic repeat-by-
        # counts construction); the fields move in ONE 10-wide row gather.
        # The earlier jnp.searchsorted form paid 19 binary-search gathers
        # per iteration (profiled at 4.4 ms/iter of the 12.6 total).
        valid_k = [c["valid"] for c in child_defs]
        local_excl = []  # exclusive prefix of valid over kinds, [C] each
        row_count = jnp.zeros((C,), dtype=jnp.int32)
        for k in range(num_kinds):
            local_excl.append(row_count)
            row_count = row_count + valid_k[k].astype(jnp.int32)
        row_offset_incl = jnp.cumsum(row_count)
        row_offset_excl = row_offset_incl - row_count
        total = row_offset_incl[-1]
        overflow = overflow | (total > C)
        present_new = jnp.arange(C, dtype=jnp.int32) < jnp.minimum(total, C)

        ind = jnp.zeros((C,), dtype=jnp.int32).at[
            jnp.where(row_count > 0, row_offset_excl, C + 1)
        ].set(jnp.arange(1, C + 1, dtype=jnp.int32), mode="drop")
        row_for_j = jnp.maximum(jax.lax.cummax(ind) - 1, 0)  # [C]
        slot_for_j = (
            jnp.arange(C, dtype=jnp.int32) - row_offset_excl[row_for_j]
        )
        # local kind index whose exclusive prefix equals the slot
        local_rows = jnp.stack(local_excl, axis=1)[row_for_j]  # [C, 13]
        valid_rows = jnp.stack(valid_k, axis=1)[row_for_j]  # [C, 13]
        k_match = (local_rows == slot_for_j[:, None]) & valid_rows
        k_for_j = jnp.argmax(k_match, axis=1).astype(jnp.int32)
        src = jnp.minimum(
            row_for_j * num_kinds + k_for_j, C * num_kinds - 1
        )

        # ONE [C * 13, F] tensor for all fields, ONE gather: the field
        # stacking is elementwise (fuses into one kernel); ten separate
        # per-field gathers were ten kernel launches per iteration
        broadcast_kinds = jnp.ones((C, num_kinds), dtype=jnp.int32)
        fields = jnp.stack(
            [
                stack("lb"),
                stack("lb_rev"),
                stack("length"),
                stack("pos"),
                stack("errors"),
                stack("last_op"),
                stack("part"),
                state["search"][:, None] * broadcast_kinds,
                state["seed"][:, None] * broadcast_kinds,
                stack("done").astype(jnp.int32),
            ],
            axis=2,
        ).reshape(C * num_kinds, 10)
        packed = jnp.where(
            present_new[:, None], fields[src], 0
        )  # [C, 10]

        new_state = {
            "lb": packed[:, 0],
            "lb_rev": packed[:, 1],
            "length": packed[:, 2],
            "pos": packed[:, 3],
            "errors": packed[:, 4],
            "last_op": jnp.where(present_new, packed[:, 5], _OP_M),
            "part": packed[:, 6],
            "search": packed[:, 7],
            "seed": packed[:, 8],
            "done": packed[:, 9] > 0,
            "present": present_new,
        }

        return new_state, overflow, total

    # while_loop with EARLY EXIT instead of a fixed-length scan: an
    # overflowing frontier aborts within ~1 iteration of the eviction
    # (the slice is host-redone regardless, so finishing the scan is
    # pure waste — the branching spike made failed attempts cost a full
    # 50-iteration pass), and a frontier whose last live chain finished
    # stops early instead of idling to the pattern-length bound.
    def cond(carry):
        state_c, overflow_c, it, _peak = carry
        alive_any = jnp.any(state_c["present"] & ~state_c["done"])
        return (it < max_iterations) & ~overflow_c & alive_any

    def body(carry):
        state_c, overflow_c, it, peak = carry
        new_state, new_overflow, total = expand((state_c, overflow_c), None)
        return new_state, new_overflow, it + 1, jnp.maximum(peak, total)

    final_state, overflow, _its, peak = jax.lax.while_loop(
        cond,
        body,
        (state, overflow0, jnp.int32(0), jnp.int32(0)),
    )
    return final_state, overflow, peak


@partial(
    jax.jit,
    static_argnames=(
        "num_searches",
        "num_parts",
        "frontier_capacity",
        "report_capacity",
        "max_iterations",
    ),
)
def _frontier_search(
    index: DeviceIndex,
    patterns: jnp.ndarray,  # int32 [num_seeds, max_len] padded
    seed_class: jnp.ndarray,  # int32 [num_seeds] scheme-class per seed
    scheme_start,  # int32 [num_classes, num_searches, num_parts]
    scheme_end,
    scheme_direction,
    scheme_lower,
    scheme_upper,
    num_searches: int,
    num_parts: int,
    frontier_capacity: int,
    report_capacity: int,
    max_iterations: int,
):
    """Returns (reports [R, 5], num_reports, overflow_flags [num_seeds]).

    Reports come back in EXACT host-DFS order per seed (module docstring):
    the frontier is a DFS-prefix ordering at every iteration, finished
    states persist in place as done rows, and the final frontier's done
    rows in slot order are the DFS leaf order."""
    R = report_capacity
    final_state, overflow, _widths = _frontier_block(
        index,
        patterns,
        seed_class,
        scheme_start,
        scheme_end,
        scheme_direction,
        scheme_lower,
        scheme_upper,
        num_searches,
        num_parts,
        frontier_capacity,
        max_iterations,
    )

    # final frontier's done rows in slot order = exact DFS leaf order;
    # gather-compacted (searchsorted over the done prefix sum) rather
    # than scattered
    C = frontier_capacity
    done = final_state["done"] & final_state["present"]
    compacted, num_done = _compact_done_rows(final_state, done, C)
    if R >= C:
        reports = jnp.zeros((R, 5), dtype=jnp.int32).at[:C].set(compacted)
    else:
        reports = compacted[:R]
    # any dropped report (or frontier eviction) => the whole block redoes
    # on the host DFS (conservative scalar, see _frontier_block)
    overflow_flags = jnp.full(
        (patterns.shape[0],), overflow | (num_done > R), dtype=bool
    )
    num_reports = jnp.minimum(num_done, R)
    return reports, num_reports, overflow_flags


def _compact_done_rows(final_state, done, C):
    """Dense-prefix [C, 5] rows (lb, lb_rev, length, errors, seed) of the
    done frontier slots, in slot order, via gather compaction."""
    csum = jnp.cumsum(done.astype(jnp.int32))
    num_done = csum[-1]
    src = jnp.searchsorted(
        csum, jnp.arange(1, C + 1, dtype=jnp.int32), side="left"
    )
    src = jnp.minimum(src, C - 1)
    present = jnp.arange(C, dtype=jnp.int32) < num_done
    rows = jnp.stack(
        [
            jnp.where(present, final_state["lb"][src], 0),
            jnp.where(present, final_state["lb_rev"][src], 0),
            jnp.where(present, final_state["length"][src], 0),
            jnp.where(present, final_state["errors"][src], 0),
            jnp.where(present, final_state["seed"][src], 0),
        ],
        axis=1,
    )
    return rows, num_done


@partial(
    jax.jit,
    static_argnames=(
        "num_searches",
        "num_parts",
        "frontier_capacity",
        "report_capacity",
        "max_iterations",
    ),
)
def _frontier_search_chunk(
    index: DeviceIndex,
    patterns: jnp.ndarray,  # int32 [num_blocks, block_seeds, max_len]
    seed_class: jnp.ndarray,  # int32 [num_blocks, block_seeds]
    gids: jnp.ndarray,  # int32 [num_blocks, block_seeds] global seed ids
    scheme_start,  # int32 [num_classes, num_searches, num_parts]
    scheme_end,
    scheme_direction,
    scheme_lower,
    scheme_upper,
    num_searches: int,
    num_parts: int,
    frontier_capacity: int,
    report_capacity: int,
    max_iterations: int,
):
    """ONE-dispatch chunk search (VERDICT r3 item 2): every block of the
    chunk runs inside a single jitted program — a lax.scan over blocks,
    each step the same frontier program as _frontier_search — with all
    blocks' reports compacted into one global buffer. Per-chunk device
    cost: one upload + one dispatch + one (count, prefix) download,
    mirroring what ops/fused_verify.py does for verification waves.

    Returns (reports [R, 5] = (lb, lb_rev, length, errors, gid),
    num_reports, overflow [num_blocks] per-block scalar eviction flags —
    unlike _frontier_search's per-seed flags). Reports preserve
    per-seed DFS order: within a block by the frontier-slot invariant,
    across blocks because each seed lives in exactly one block and blocks
    append in order."""
    R = report_capacity

    def one_block(carry, xs):
        buffer, count = carry
        patterns_blk, class_blk, gids_blk = xs
        final_state, ovf, widths = _frontier_block(
            index,
            patterns_blk,
            class_blk,
            scheme_start,
            scheme_end,
            scheme_direction,
            scheme_lower,
            scheme_upper,
            num_searches,
            num_parts,
            frontier_capacity,
            max_iterations,
        )
        C = frontier_capacity
        done = final_state["done"] & final_state["present"]
        compacted, num_done = _compact_done_rows(final_state, done, C)
        # translate block-local seed ids to gids in place (column 4)
        compacted = compacted.at[:, 4].set(gids_blk[compacted[:, 4]])
        # append at the running offset: dynamic_update_slice with a static
        # [C]-row window into a [R + C]-row buffer (the C-row tail is
        # scratch, never read back) — no scatter anywhere in the program
        buffer = jax.lax.dynamic_update_slice(
            buffer, compacted, (jnp.minimum(count, R), jnp.int32(0))
        )
        # any dropped report (global budget exhausted) => this block's
        # seeds redo on the host; conservative scalar like the frontier
        # eviction flag
        ovf = ovf | (count + num_done > R)
        count = jnp.minimum(count + num_done, R)
        return (buffer, count), ovf

    buffer0 = jnp.zeros((R + frontier_capacity, 5), dtype=jnp.int32)
    (buffer, count), overflow = jax.lax.scan(
        one_block,
        (buffer0, jnp.int32(0)),
        (patterns, seed_class, gids),
    )
    return buffer[:R], count, overflow


def search_seeds_device(
    index: DeviceIndex,
    patterns: list[np.ndarray],
    max_errors: int,
    expanded_searches,
    frontier_capacity: int = 1 << 14,
    report_capacity: int = 1 << 12,
    runner=None,
    max_total_count: int | None = None,
):
    """Run the frontier search for a batch of same-(length-class) seeds.

    Returns (groups_per_seed: list[list[(lb, lb_rev, len, errors)]],
    totals, aborted, overflow). Groups come back in EXACT host-DFS order
    (deduplicated by (lb, len, errors) keeping the first report), truncated
    by the running-total cap replay of search.cpp:173-188 when
    max_total_count is given: a group is kept iff the total BEFORE it is
    under the cap, totals[i] is the running total at the stop point, and
    aborted[i] mirrors the host DFS's _SearchAborted."""
    tables = SchemeTables.from_searches(expanded_searches)
    max_len = max(len(p) for p in patterns)
    # pad the seed count to a power of two so the jitted kernel sees a
    # bounded set of shapes (padding seeds carry the DEAD scheme class and
    # die on their first boundary check)
    num_padded = 8
    while num_padded < len(patterns):
        num_padded *= 2
    padded = np.zeros((num_padded, max_len), dtype=np.int32)
    seed_class = np.full(num_padded, tables.dead_class, dtype=np.int32)
    for i, pattern in enumerate(patterns):
        padded[i, : len(pattern)] = pattern
        seed_class[i] = 0

    max_iterations = max_len + max_errors + 2 * tables.num_parts + 2

    if runner is not None:
        reports, num_reports, overflow = runner(
            padded,
            seed_class,
            tables,
            frontier_capacity,
            report_capacity,
            max_iterations,
        )
    else:
        reports, num_reports, overflow = _frontier_search(
            index,
            jnp.asarray(padded),
            jnp.asarray(seed_class),
            tables.start,
            tables.end,
            tables.direction,
            tables.lower,
            tables.upper,
            tables.num_searches,
            tables.num_parts,
            frontier_capacity,
            report_capacity,
            max_iterations,
        )
    reports = np.asarray(reports)[: int(num_reports)]
    overflow = np.asarray(overflow)
    cap = (1 << 62) if max_total_count is None else int(max_total_count)

    groups: list[list[tuple[int, int, int, int]]] = [
        [] for _ in range(len(patterns))
    ]
    totals = np.zeros(len(patterns), dtype=np.int64)
    aborted = np.zeros(len(patterns), dtype=bool)
    seen: set = set()
    # reports are in frontier slot order: interleaved across seeds, but in
    # exact DFS order within each seed — the keep-first dedup and cap
    # replay below reproduce search_host.search_seed_groups bit-exactly
    for lb, lb_rev, length, errors, seed in reports:
        s = int(seed)
        if s >= len(patterns):  # padding seed
            continue
        if aborted[s]:
            continue
        key = (s, int(lb), int(length), int(errors))
        if key in seen:
            continue
        seen.add(key)
        groups[s].append((int(lb), int(lb_rev), int(length), int(errors)))
        totals[s] += int(length)
        if totals[s] >= cap:
            aborted[s] = True
    return groups, totals, aborted, overflow


class ShardedDeviceSearcher(DeviceSearcher):
    """DeviceSearcher whose frontier search runs against a row-sharded
    index over an 'index' mesh axis (collective rank queries) — the
    hg38-scale configuration where the occurrence table does not fit one
    chip's HBM. Anchor post-processing and locate stay on the host path,
    identical to DeviceSearcher."""

    # the shard_map frontier program is built per block; chunk fusion of
    # the sharded program is future work
    _one_dispatch_chunk = False

    def __init__(self, host_searcher, mesh, sharded_host_index):
        self._host = host_searcher
        self._mesh = mesh
        self._sh = sharded_host_index
        self.index = host_searcher.index
        self.num_reference_sequences = host_searcher.num_reference_sequences
        self.config = host_searcher.config

    def _run_block(
        self, padded, seed_class, tables, frontier_cap, report_cap, max_iter
    ):
        from .parallel.sharded_index import sharded_frontier_search

        return sharded_frontier_search(
            self._mesh, self._sh, padded, seed_class, tables,
            frontier_cap, report_cap, max_iter,
        )

    def _run_search(self, patterns, errors, expanded):
        from .parallel.sharded_index import sharded_frontier_search

        def runner(padded, seed_class, tables, frontier_cap, report_cap, max_iter):
            return sharded_frontier_search(
                self._mesh, self._sh, padded, seed_class, tables,
                frontier_cap, report_cap, max_iter,
            )

        return search_seeds_device(
            None,
            patterns,
            errors,
            expanded,
            runner=runner,
            max_total_count=self._host.search_cap(),
        )


def make_sharded_searcher(host_searcher, host_index, num_shards: int):
    """Builds a ShardedDeviceSearcher over the first num_shards devices."""
    import jax
    from jax.sharding import Mesh

    from .parallel.sharded_index import INDEX_AXIS, shard_full_index

    devices = jax.devices()
    if len(devices) < num_shards:
        raise ValueError(
            f"--index-shards {num_shards} needs {num_shards} devices, "
            f"have {len(devices)}"
        )
    mesh = Mesh(np.asarray(devices[:num_shards]), (INDEX_AXIS,))
    sh = shard_full_index(host_index, num_shards)
    return ShardedDeviceSearcher(host_searcher, mesh, sh)
