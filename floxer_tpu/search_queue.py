"""Stack-ordered work-queue device seed search.

The synchronous-frontier formulation (search_device._frontier_block) pays
peak_width x iterations: FM intervals stay unspecific for the first ~13
context chars, so the frontier holds its full initial width until every
seed hits its first scheme-part boundary in the same iteration and the
error-budget branching bursts the width >12x — a ~200x structural gap vs
the host DFS, which visits ~85 nodes per seed total (frontier width
telemetry).

This module is bounded by TOTAL work instead of peak width: states live on
a LIFO stack (one [CAP, F] int32 array in HBM); each iteration pops a
fixed quantum of the most recently pushed (deepest) states, expands them,
appends finished states to the report buffer, and pushes surviving
children back on top. Every state is pushed and popped exactly once, so
device cost ~ total tree nodes x a small constant of gather rows — the
same asymptotics as the host DFS (reference engine semantics: the
reference's src/lib/search.cpp:173-188, transliterated by
search_host._run_scheme_search).

Deepest-first (LIFO) order keeps the backlog small: a popped window's
children are popped next, so subtrees drain to completion before older
seeds start — the batched analogue of the host DFS stack.

Report ORDER is restored by explicit DFS path keys instead of the
frontier's in-place slot invariant: every expansion step writes its edge
kind (1=match, 2..6=substitutions by symbol, 7..11=insertions, 12=
deletion — the host DFS edge order) as a 4-bit nibble at the state's
depth into KW per-state key words (earlier depths at more significant
bits, so uint32 word comparison is lexicographic path comparison).
Boundary advances are single-child and consume no nibble. The host sorts
downloaded reports by (seed, search, key words) — exact host-DFS order
per seed, which is all the keep-first dedup and cap replay of
search_seeds_device require.

Burst handling without burst sizing: the push block has a static capacity
of PUSH_FACTOR x quantum rows. Each iteration expands the longest suffix
of the popped window whose EXACT child count (known after the rank
gathers) fits the push block; unexpanded rows simply stay on the stack
(their slice is discarded, the stack top just consumes fewer rows).
A branching burst therefore costs extra iterations proportional to its
own work, never a capacity abort — overflow only fires on genuine stack /
report / key-depth exhaustion, which routes the slice to the host redo
like every other capacity shortfall.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .alphabet import SIGMA
from .index.device_index import rank_all
from .search_device import _EDIT_SYMBOLS, _OP_D, _OP_I, _OP_M

import os as _os

# pop quantum per iteration (sweep on the 57k-seed chr21 chunk,
# 2026-08-21: 64k/3 = 2.28 s vs 32k/2 = 2.91 s, 128k/3 = 3.2 s — large
# quanta amortize per-iteration fixed cost until the window exceeds the
# live backlog)
QUANTUM = int(_os.environ.get("FLOXER_TPU_WQ_QUANTUM", 1 << 16))
# push block rows = PUSH_FACTOR * quantum (the compaction gather length —
# the dominant per-iteration gather; 3 lets burst windows expand ~3x
# before the suffix-fit truncates them)
PUSH_FACTOR = int(_os.environ.get("FLOXER_TPU_WQ_PUSH_FACTOR", 3))

# state row layout in the stack [CAP, F]: 10 scalar fields + KW key words
_F_LB, _F_LBREV, _F_LEN, _F_POS, _F_ERR, _F_OP, _F_PART, _F_SEARCH, \
    _F_SEED, _F_DEPTH = range(10)
_NUM_SCALARS = 10


def key_words_needed(max_len: int, max_errors: int) -> int:
    """Key words for a seed class: one nibble per expansion step; a path
    expands at most pattern_length + errors (insertions) times."""
    return -(-(max_len + max_errors + 2) // 8)


@partial(
    jax.jit,
    static_argnames=(
        "num_searches", "num_parts", "quantum", "push_rows",
        "stack_capacity", "report_capacity", "key_words", "max_iterations",
    ),
)
def _workqueue_search(
    index,
    patterns,  # int32 [S, L] padded
    seed_class,  # int32 [S]
    scheme_start,  # int32 [num_classes, num_searches, num_parts]
    scheme_end,
    scheme_direction,
    scheme_lower,
    scheme_upper,
    num_searches: int,
    num_parts: int,
    quantum: int,
    push_rows: int,
    stack_capacity: int,
    report_capacity: int,
    key_words: int,
    max_iterations: int,
):
    """Returns (reports [R, 6 + KW], num_reports, overflow scalar,
    iterations).

    Report row: (lb, lb_rev, length, errors, seed, search, key0..kKW-1).
    Reports are in COMPLETION order — the caller must sort by
    (seed, search, keys) to recover host-DFS order (sort_reports)."""
    num_seeds = patterns.shape[0]
    K = quantum
    P = push_rows
    CAP = stack_capacity
    R = report_capacity
    KW = key_words
    F = _NUM_SCALARS + KW
    from .index.device_index import index_size

    n = index_size(index.fwd)

    # fused scheme-row table, one [T, 8] row per (class, search, part)
    # (same construction as search_device._frontier_block)
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

    # ---- initial stack: one state per (seed, search) ----
    init_count = num_seeds * num_searches
    init_overflow = init_count > CAP
    init_fill = min(init_count, CAP)
    # seed-major, search-minor, REVERSED so seed 0 / search 0 sits at the
    # TOP of the stack (popped first) — not required for correctness (keys
    # fix report order) but keeps device completion vaguely aligned with
    # host order, which makes debugging dumps readable
    lin = jnp.arange(init_fill, dtype=jnp.int32)
    rev = jnp.asarray(init_count - 1, dtype=jnp.int32) - lin
    seed0 = rev // num_searches
    search0 = rev % num_searches
    cls0 = seed_class[seed0]
    dir0 = scheme_direction[cls0, search0, 0]
    first_pos = scheme_start[cls0, search0, 0] * (dir0 > 0) + (
        scheme_end[cls0, search0, 0] - 1
    ) * (dir0 < 0)

    stack0 = jnp.zeros((CAP + P, F), dtype=jnp.int32)
    init_rows = jnp.zeros((init_fill, F), dtype=jnp.int32)
    init_rows = init_rows.at[:, _F_LEN].set(n)
    init_rows = init_rows.at[:, _F_POS].set(first_pos)
    init_rows = init_rows.at[:, _F_OP].set(_OP_M)
    init_rows = init_rows.at[:, _F_SEARCH].set(search0)
    init_rows = init_rows.at[:, _F_SEED].set(seed0)
    stack0 = stack0.at[:init_fill].set(init_rows)

    reports0 = jnp.zeros((R + K, 6 + KW), dtype=jnp.int32)

    def body(carry, *, K, P):
        # K/P are bound per phase (functools.partial): the main loop runs
        # the full quantum; once the stack drains below the tail
        # threshold a second while_loop continues with a small quantum so
        # the final subtree drains don't pay full-window gather costs
        # (~40-80 trickle iterations at the end of a chunk)
        stack, top, reports, num_reports, overflow, it = carry

        # ---- peek the top-K window (contiguous slice) ----
        start = jnp.maximum(top - K, 0)
        win = jax.lax.dynamic_slice(stack, (start, jnp.int32(0)), (K, F))
        # window position j holds stack row start + j; valid rows are the
        # ones below the current top
        j_iota = jnp.arange(K, dtype=jnp.int32)
        row_ids = start + j_iota
        present = row_ids < top

        lb = win[:, _F_LB]
        lb_rev = win[:, _F_LBREV]
        length = win[:, _F_LEN]
        pos = win[:, _F_POS]
        errors = win[:, _F_ERR]
        last_op = win[:, _F_OP]
        part_raw = win[:, _F_PART]
        search = win[:, _F_SEARCH]
        seed = win[:, _F_SEED]
        depth = win[:, _F_DEPTH]
        keys = [win[:, _NUM_SCALARS + w] for w in range(KW)]

        cls = seed_class[jnp.clip(seed, 0, num_seeds - 1)]
        part = jnp.clip(part_raw, 0, num_parts - 1)
        fused_idx = (cls * num_searches + search) * num_parts + part
        row = scheme_fused[fused_idx]  # [K, 8]
        direction = row[:, 0]
        p_start = row[:, 1]
        p_end = row[:, 2]
        lower = row[:, 3]
        upper = row[:, 4]

        at_boundary = jnp.where(
            direction > 0, pos >= p_end, pos < p_start
        ) & present

        meets_lower = errors >= lower
        finished = at_boundary & meets_lower & (part_raw == num_parts - 1)
        advancing = at_boundary & meets_lower & ~finished

        next_first = jnp.where(row[:, 5] > 0, row[:, 6], row[:, 7] - 1)

        expanding = present & ~at_boundary

        # ---- rank gathers (the per-node HBM cost) ----
        base_fwd = jnp.where(expanding, lb, 0)
        base_rev = jnp.where(expanding, lb_rev, 0)
        left = direction < 0
        base = jnp.where(left, base_fwd, base_rev)
        if getattr(index, "rank_rows", None) is not None:
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
        else:
            lo_s = [lo[:, s] for s in range(SIGMA)]
            hi_s = [hi[:, s] for s in range(SIGMA)]
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

        pattern_symbol = patterns[
            jnp.clip(seed, 0, num_seeds - 1),
            jnp.clip(pos, 0, patterns.shape[1] - 1),
        ]
        budget_left = errors < upper

        def select_by_symbol(per_symbol):
            out = per_symbol[0]
            for s in range(1, SIGMA):
                out = jnp.where(pattern_symbol == s, per_symbol[s], out)
            return out

        match_lb = select_by_symbol(child_lb_s)
        match_lb_rev = select_by_symbol(child_lb_rev_s)
        match_count = select_by_symbol(counts_s)

        # ---- candidate kinds, host-DFS edge order (kind index IS the
        # DFS key nibble; search_device._frontier_block column comment) ---
        # kind 0: boundary advance (single child, no nibble)
        zeros = jnp.zeros((K,), dtype=jnp.int32)
        child_defs = [
            dict(
                valid=advancing,
                lb=lb, lb_rev=lb_rev, length=length,
                pos=next_first, errors=errors, last_op=last_op,
                part=part_raw + 1, bump=False,
            ),
            dict(
                valid=expanding & (match_count > 0),
                lb=match_lb, lb_rev=match_lb_rev, length=match_count,
                pos=pos + direction, errors=errors,
                last_op=zeros + _OP_M, part=part_raw, bump=True,
            ),
        ]
        for symbol in _EDIT_SYMBOLS:
            child_defs.append(
                dict(
                    valid=(
                        expanding & budget_left
                        & (pattern_symbol != symbol)
                        & (counts_s[symbol] > 0)
                    ),
                    lb=child_lb_s[symbol], lb_rev=child_lb_rev_s[symbol],
                    length=counts_s[symbol], pos=pos + direction,
                    errors=errors + 1, last_op=zeros + _OP_M,
                    part=part_raw, bump=True,
                )
            )
        for symbol in _EDIT_SYMBOLS:
            child_defs.append(
                dict(
                    valid=(
                        expanding & budget_left
                        & (counts_s[symbol] > 0)
                        & (last_op != _OP_D)
                    ),
                    lb=child_lb_s[symbol], lb_rev=child_lb_rev_s[symbol],
                    length=counts_s[symbol], pos=pos,
                    errors=errors + 1, last_op=zeros + _OP_I,
                    part=part_raw, bump=True,
                )
            )
        child_defs.append(
            dict(
                valid=expanding & budget_left & (last_op != _OP_I),
                lb=lb, lb_rev=lb_rev, length=length,
                pos=pos + direction, errors=errors + 1,
                last_op=zeros + _OP_D, part=part_raw, bump=True,
            )
        )
        num_kinds = len(child_defs)  # 13

        # ---- expansion suffix: expand the deepest rows whose exact child
        # count fits the push block; the rest stay on the stack ----
        child_count = zeros
        for c in child_defs:
            child_count = child_count + c["valid"].astype(jnp.int32)
        # suffix cumsum: children of rows j..K-1 (row K-1 = stack top)
        suffix = jnp.cumsum(child_count[::-1])[::-1]
        fits = suffix <= P
        # the report compaction gather is sized P_REP << K (finishers are
        # a small fraction of any window); the same suffix-fit trick
        # bounds them — rows whose finisher prefix would overflow simply
        # stay on the stack for the next iteration
        P_REP = max(K // 4, 256)
        suffix_rep = jnp.cumsum(finished[::-1].astype(jnp.int32))[::-1]
        fits = fits & (suffix_rep <= P_REP)
        # rows j with fits[j] True form a suffix (both suffix cumsums are
        # monotone decreasing in j); n_exp = number of expanded rows
        n_exp = jnp.sum(fits & present)
        take = fits & present
        n_children = jnp.sum(jnp.where(take, child_count, 0))

        # ---- report rows: finished states among the expanded suffix ----
        rep_valid = finished & take
        rep_csum = jnp.cumsum(rep_valid.astype(jnp.int32))
        n_rep = rep_csum[-1]
        # scatter row ids at output offsets + cummax (repeat-by-counts)
        rep_ind = jnp.zeros((P_REP,), dtype=jnp.int32).at[
            jnp.where(rep_valid, rep_csum - 1, P_REP + 1)
        ].set(j_iota + 1, mode="drop")
        rep_src = jnp.maximum(jax.lax.cummax(rep_ind) - 1, 0)
        rep_fields = jnp.stack(
            [lb, lb_rev, length, errors, seed, search] + keys, axis=1
        )  # [K, 6 + KW]
        rep_rows = jnp.where(
            (jnp.arange(P_REP)[:, None] < n_rep), rep_fields[rep_src], 0
        )
        reports = jax.lax.dynamic_update_slice(
            reports, rep_rows, (jnp.minimum(num_reports, R), jnp.int32(0))
        )
        overflow = overflow | (num_reports + n_rep > R)
        num_reports = jnp.minimum(num_reports + n_rep, R)

        # ---- push-stream compaction (scatter+cummax over [K*13]) ----
        valid_k = [c["valid"] & take for c in child_defs]
        local_excl = []
        row_count = zeros
        for k in range(num_kinds):
            local_excl.append(row_count)
            row_count = row_count + valid_k[k].astype(jnp.int32)
        row_offset_incl = jnp.cumsum(row_count)
        row_offset_excl = row_offset_incl - row_count
        total = row_offset_incl[-1]  # == n_children

        ind = jnp.zeros((P,), dtype=jnp.int32).at[
            jnp.where(row_count > 0, row_offset_excl, P + 1)
        ].set(j_iota + 1, mode="drop")
        row_for_j = jnp.maximum(jax.lax.cummax(ind) - 1, 0)  # [P]
        # parent-side lookup fused into ONE [P]-row gather: per-row
        # gathers are latency-bound (~30 ns/row) and row width is nearly
        # free, so (offset | local prefixes | valid flags) ride one wide
        # row instead of three separate gathers
        parent_table = jnp.stack(
            [row_offset_excl]
            + local_excl
            + [v.astype(jnp.int32) for v in valid_k],
            axis=1,
        )  # [K, 1 + 13 + 13]
        parent_rows = parent_table[row_for_j]  # [P, 27]
        slot_for_j = jnp.arange(P, dtype=jnp.int32) - parent_rows[:, 0]
        local_rows = parent_rows[:, 1 : 1 + num_kinds]
        valid_rows = parent_rows[:, 1 + num_kinds :] > 0
        k_match = (local_rows == slot_for_j[:, None]) & valid_rows
        k_for_j = jnp.argmax(k_match, axis=1).astype(jnp.int32)
        src = jnp.minimum(
            row_for_j * num_kinds + k_for_j, K * num_kinds - 1
        )

        def stack_kinds(name):
            return jnp.stack([c[name] for c in child_defs], axis=1)

        # child key/depth: bump rows write their kind nibble at the
        # parent depth (earlier depth = more significant bits of earlier
        # words => uint32 word sequence compares lexicographically)
        bump = jnp.stack(
            [
                jnp.full((K,), 1 if c["bump"] else 0, dtype=jnp.int32)
                for c in child_defs
            ],
            axis=1,
        )
        kind_iota = jnp.arange(num_kinds, dtype=jnp.int32)[None, :]
        nib_shift = (4 * (7 - (depth % 8)))[:, None]  # [K, 1]
        word_of_depth = (depth // 8)[:, None]  # [K, 1]
        key_cols = []
        for w in range(KW):
            base_w = keys[w][:, None]
            updated = base_w | (kind_iota << nib_shift)
            key_cols.append(
                jnp.where((word_of_depth == w) & (bump > 0), updated, base_w)
            )
        child_depth = depth[:, None] + bump  # [K, 13]
        overflow = overflow | jnp.any(
            (child_depth >= 8 * KW)
            & jnp.stack(valid_k, axis=1)
            & (bump > 0)
        )

        fields = jnp.stack(
            [
                stack_kinds("lb"),
                stack_kinds("lb_rev"),
                stack_kinds("length"),
                stack_kinds("pos"),
                stack_kinds("errors"),
                stack_kinds("last_op"),
                stack_kinds("part"),
                jnp.broadcast_to(search[:, None], (K, num_kinds)),
                jnp.broadcast_to(seed[:, None], (K, num_kinds)),
                child_depth,
            ]
            + [
                jnp.broadcast_to(col, (K, num_kinds)) for col in key_cols
            ],
            axis=2,
        ).reshape(K * num_kinds, F)
        push_block = jnp.where(
            (jnp.arange(P)[:, None] < total), fields[src], 0
        )  # [P, F]

        new_top_base = top - n_exp
        stack = jax.lax.dynamic_update_slice(
            stack, push_block, (new_top_base, jnp.int32(0))
        )
        new_top = new_top_base + total
        overflow = overflow | (new_top > CAP)

        return stack, new_top, reports, num_reports, overflow, it + 1

    import functools

    K_TAIL = min(K, 1 << 13)
    P_TAIL = min(P, (P // K) * K_TAIL)

    def cond_main(carry):
        _stack, top, _reports, _nr, overflow, it = carry
        # hand off to the tail loop once a tail window covers the stack
        return (top > K_TAIL) & ~overflow & (it < max_iterations)

    def cond_tail(carry):
        _stack, top, _reports, _nr, overflow, it = carry
        return (top > 0) & ~overflow & (it < max_iterations)

    carry = (
        stack0,
        jnp.int32(init_fill),
        reports0,
        jnp.int32(0),
        jnp.asarray(init_overflow),
        jnp.int32(0),
    )
    carry = jax.lax.while_loop(
        cond_main, functools.partial(body, K=K, P=P), carry
    )
    # tail drain: small quantum; a tail burst can push the stack back
    # above the threshold, in which case the tail loop simply keeps
    # draining in small windows (suffix-fit keeps it correct at any size)
    _stack, _top, reports, num_reports, overflow, its = jax.lax.while_loop(
        cond_tail, functools.partial(body, K=K_TAIL, P=P_TAIL), carry
    )
    return reports[:R], num_reports, overflow, its


def sort_reports(raw: np.ndarray) -> np.ndarray:
    """Sort downloaded report rows [n, 6 + KW] into host-DFS order:
    primary seed, then search index, then the DFS path key words (word 0
    most significant; nibbles within a word already ordered
    most-significant-first by the kernel). Returns the sorted rows."""
    if raw.shape[0] == 0:
        return raw
    kw = raw.shape[1] - 6
    cols = [raw[:, 6 + w].astype(np.uint32) for w in range(kw)]
    # np.lexsort: LAST key is primary
    order = np.lexsort(tuple(reversed(cols)) + (raw[:, 5], raw[:, 4]))
    return raw[order]


def make_runner(device_index, max_errors: int):
    """Adapter with search_seeds_device's `runner` signature: returns
    (reports [n, 5] = (lb, lb_rev, length, errors, seed) in host-DFS
    order, num_reports, overflow flags [num_seeds])."""

    def runner(padded, seed_class, tables, _frontier_cap, report_cap,
               _max_iter):
        rows, overflow = workqueue_runner(
            device_index,
            padded,
            seed_class,
            tables,
            report_cap,
            padded.shape[1],
            max_errors,
        )
        reports = rows[:, :5].astype(np.int32)
        flags = np.full(padded.shape[0], overflow, dtype=bool)
        return reports, reports.shape[0], flags

    return runner


def workqueue_runner(
    index,
    padded: np.ndarray,
    seed_class: np.ndarray,
    tables,
    report_capacity: int,
    max_len: int,
    max_errors: int,
):
    """Dispatch one work-queue search; returns (sorted report rows
    [n, 6 + KW] in host-DFS order, overflow: bool).

    Stack capacity: the LIFO backlog stays near the initial state count
    (deepest-first drains subtrees before widening), so 2x init + the
    burst allowance is generous; overflow retries once at 4x before the
    caller concedes to the host redo."""
    num_seeds = padded.shape[0]
    init = num_seeds * tables.num_searches
    K = QUANTUM
    P = PUSH_FACTOR * K
    KW = key_words_needed(max_len, max_errors)
    # a path visits <= len + errors + parts expansion steps; pops per
    # state is 1, so iterations ~ total_work / K with a tail of small
    # windows; the bound only guards runaway loops
    max_iterations = int(_os.environ.get("FLOXER_TPU_WQ_MAX_ITER", 1 << 16))

    def quantize(value, floor=1 << 12):
        value = max(int(value), floor)
        granule = 1 << max(0, value.bit_length() - 2)
        return -(-value // granule) * granule

    cap = quantize(2 * init + P + K)
    r_cap = quantize(report_capacity, 1 << 12)
    for _attempt in range(2):
        reports, num_reports, overflow, iterations = _workqueue_search(
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
            K,
            P,
            cap,
            r_cap,
            KW,
            max_iterations,
        )
        if not bool(np.asarray(overflow)):
            break
        cap *= 4
        r_cap *= 4
    count = int(np.asarray(num_reports))
    import logging

    logging.getLogger("floxer-tpu").debug(
        "workqueue search: %d seeds, %d reports, %d iterations (K=%d)",
        num_seeds, count, int(np.asarray(iterations)), K,
    )
    n_pad = 1
    while n_pad < max(count, 1):
        n_pad *= 2
    n_pad = min(n_pad, r_cap)
    raw = np.asarray(reports[:n_pad])[:count]
    return sort_reports(raw), bool(np.asarray(overflow))
