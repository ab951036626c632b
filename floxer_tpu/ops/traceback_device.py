"""On-device banded CIGAR traceback for accepted PEX roots.

The device counterpart of native/traceback.cpp (itself the banded
rebuild of the reference's full-matrix traceback, alignment.cpp:147-180):
for each accepted root the device recomputes the |j - i - (end_col - m)|
<= distance band around the optimal path's diagonal and emits a per-cell
2-bit DIRECTION code (the move the host walk would take at that cell
under the reference's tie preference: vertical I, then diagonal, then
horizontal D), then walks the direction bitmap back from (m, end_col) on
device as a batched scan. The host receives only (begin, op codes) and
does string formatting (reverse + run-length encode) — no DP on the host
critical path.

Both stages are vectorized over a task batch [T] and the band dimension
[W_pad] — a row-scan forward (the horizontal dependency is a min-plus
prefix scan, log-depth on the VPU) and a lock-step walk scan. Buckets are
padded to (m_pad, W_pad) shape quanta so the jit cache stays small.

Byte-exactness contract: directions are derived from the same band-cell
equalities the host walk tests (dp_reference.banded_cigar_traceback,
native/traceback.cpp walk loop), including band-edge big-value inflation,
so the op sequence — and therefore the CIGAR — is identical for every
input (tests/test_traceback_device.py fuzzes this against the native
engine)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

BIG = np.int32(1 << 20)

# direction codes (2 bits): the walk's move at a band cell
DIR_I = 0  # vertical: consume a pattern char (insertion vs reference)
DIR_EQ = 1  # diagonal match
DIR_X = 2  # diagonal substitution
DIR_D = 3  # horizontal: consume a reference char (deletion vs pattern)

_OP_CHARS = {DIR_I: "I", DIR_EQ: "=", DIR_X: "X", DIR_D: "D"}


@functools.partial(jax.jit, static_argnames=("m_pad", "w_pad", "n_pad"))
def _banded_directions_and_walk(
    windows,  # int32 [T, n_pad] reference rank chars (garbage past n)
    patterns,  # int32 [T, m_pad] pattern rank chars (garbage past m)
    n_lens,  # int32 [T]
    m_lens,  # int32 [T]
    end_cols,  # int32 [T]
    distances,  # int32 [T]
    m_pad: int,
    w_pad: int,
    n_pad: int,
):
    """Returns (ops [L, T] int8 walk moves in reverse order with -1 padding,
    num_ops [T], begin_cols [T])."""
    T = windows.shape[0]
    big = jnp.int32(BIG)

    center = end_cols - m_lens  # [T]
    half = jnp.maximum(distances, 0)
    width = 2 * half + 1  # true band width per task (<= w_pad)
    d_idx = jnp.arange(w_pad, dtype=jnp.int32)[None, :]  # [1, w_pad]
    base = (center - half)[:, None]  # [T, 1]

    # row 0: dp[0][j] = 0 for valid j (free leading reference gaps)
    cols0 = base + d_idx
    valid0 = (
        (cols0 >= 0) & (cols0 <= n_lens[:, None]) & (d_idx < width[:, None])
    )
    dp0 = jnp.where(valid0, jnp.int32(0), big)

    neg_ar = -d_idx.astype(jnp.int32)  # the min-plus scan offset

    def row_step(prev, i):
        # i is the 1-based pattern row
        cols = i + base + d_idx  # [T, w_pad]
        valid = (
            (cols >= 0)
            & (cols <= n_lens[:, None])
            & (d_idx < width[:, None])
        )
        ref_chars = jnp.take_along_axis(
            windows, jnp.clip(cols - 1, 0, n_pad - 1), axis=1
        )
        pat_char = jnp.take_along_axis(
            patterns, jnp.full((T, 1), i - 1).astype(jnp.int32), axis=1
        )
        sub = (ref_chars != pat_char).astype(jnp.int32)

        # diagonal predecessor dp[i-1][j-1] = prev[d]
        diag = jnp.where(cols >= 1, prev + sub, big)
        # vertical predecessor dp[i-1][j] = prev[d+1]
        up = (
            jnp.concatenate(
                [prev[:, 1:], jnp.full((T, 1), big)], axis=1
            )
            + 1
        )
        best = jnp.minimum(diag, up)
        # horizontal dp[i][j-1]: min-plus prefix scan within the row
        scan_in = jnp.where(valid, best, big) + neg_ar
        row = (
            jax.lax.associative_scan(jnp.minimum, scan_in, axis=1) - neg_ar
        )
        dp = jnp.where(valid, jnp.minimum(best, row), big)

        # direction = the host walk's move at (i, d): I first, then diag,
        # then D (dp_reference._traceback tie preference)
        is_i = dp == up
        diag_ok = dp == diag
        dirs = jnp.where(
            is_i,
            jnp.int8(DIR_I),
            jnp.where(
                diag_ok,
                jnp.where(sub == 1, jnp.int8(DIR_X), jnp.int8(DIR_EQ)),
                jnp.int8(DIR_D),
            ),
        )
        return dp, dirs

    _, dirs_stacked = jax.lax.scan(
        row_step, dp0, jnp.arange(1, m_pad + 1, dtype=jnp.int32)
    )  # dirs_stacked: [m_pad, T, w_pad]
    dirs_flat = jnp.transpose(dirs_stacked, (1, 0, 2)).reshape(
        T, m_pad * w_pad
    )

    # ---- walk: lock-step over tasks, ops emitted walk-order (reversed) ----
    L = m_pad + w_pad

    def walk_step(carry, _):
        i, d, count = carry
        active = i > 0
        flat = jnp.clip((i - 1) * w_pad + d, 0, m_pad * w_pad - 1)
        code = jnp.take_along_axis(dirs_flat, flat[:, None], axis=1)[:, 0]
        code = code.astype(jnp.int32)
        is_i = code == DIR_I
        is_diag = (code == DIR_EQ) | (code == DIR_X)
        new_i = jnp.where(active & (is_i | is_diag), i - 1, i)
        new_d = jnp.where(
            active,
            d + jnp.where(is_i, 1, jnp.where(is_diag, 0, -1)),
            d,
        )
        op = jnp.where(active, code.astype(jnp.int8), jnp.int8(-1))
        return (new_i, new_d, count + active.astype(jnp.int32)), op

    init = (m_lens, half, jnp.zeros((T,), jnp.int32))
    (end_i, end_d, num_ops), ops = jax.lax.scan(
        walk_step, init, None, length=L
    )
    begin_cols = (center - half) + end_d  # j at i == 0
    return ops, num_ops, begin_cols


def _pad_quantum(value: int, quantum: int) -> int:
    return -(-max(value, 1) // quantum) * quantum


def banded_cigar_traceback_device_batch(
    tasks: list[tuple[np.ndarray, np.ndarray, int, int]],
    m_quantum: int = 2048,
    w_quantum: int = 256,
    batch: int = 8,
) -> list[tuple[int, list[tuple[int, str]]]]:
    """Batched device reconstruction of (begin, cigar_rle) per task.

    tasks: (reference_window, pattern, end_col, distance) — the same
    arguments as dp_reference.banded_cigar_traceback; returns the same
    (begin, [(count, op_char), ...]) per task, byte-identical."""
    results: list = [None] * len(tasks)

    # bucket by padded shape so jit keys are bounded
    buckets: dict[tuple[int, int, int], list[int]] = {}
    for t, (window, pattern, end_col, distance) in enumerate(tasks):
        m_pad = _pad_quantum(len(pattern), m_quantum)
        w_pad = _pad_quantum(2 * max(int(distance), 0) + 1, w_quantum)
        n_pad = _pad_quantum(len(window), m_quantum)
        buckets.setdefault((m_pad, w_pad, n_pad), []).append(t)

    for (m_pad, w_pad, n_pad), idxs in buckets.items():
        for b0 in range(0, len(idxs), batch):
            chunk = idxs[b0 : b0 + batch]
            T = len(chunk)
            windows = np.zeros((T, n_pad), dtype=np.int32)
            patterns = np.zeros((T, m_pad), dtype=np.int32)
            n_lens = np.zeros(T, dtype=np.int32)
            m_lens = np.zeros(T, dtype=np.int32)
            end_cols = np.zeros(T, dtype=np.int32)
            distances = np.zeros(T, dtype=np.int32)
            for s, t in enumerate(chunk):
                window, pattern, end_col, distance = tasks[t]
                windows[s, : len(window)] = window
                patterns[s, : len(pattern)] = pattern
                n_lens[s] = len(window)
                m_lens[s] = len(pattern)
                end_cols[s] = end_col
                distances[s] = distance
            ops, num_ops, begin_cols = _banded_directions_and_walk(
                jnp.asarray(windows),
                jnp.asarray(patterns),
                jnp.asarray(n_lens),
                jnp.asarray(m_lens),
                jnp.asarray(end_cols),
                jnp.asarray(distances),
                m_pad=m_pad,
                w_pad=w_pad,
                n_pad=n_pad,
            )
            ops = np.asarray(ops)  # [L, T]
            num_ops = np.asarray(num_ops)
            begin_cols = np.asarray(begin_cols)
            for s, t in enumerate(chunk):
                results[t] = (
                    int(begin_cols[s]),
                    _rle_from_reversed_ops(ops[: int(num_ops[s]), s]),
                )
    return results


def _rle_from_reversed_ops(codes: np.ndarray) -> list[tuple[int, str]]:
    """Walk-order (reversed) op codes -> forward run-length CIGAR list.
    Host work is exactly this: flip, find run boundaries, format."""
    if codes.shape[0] == 0:
        return []
    forward = codes[::-1]
    change = np.flatnonzero(forward[1:] != forward[:-1])
    starts = np.concatenate([[0], change + 1])
    ends = np.concatenate([change + 1, [forward.shape[0]]])
    return [
        (int(e - s), _OP_CHARS[int(forward[s])])
        for s, e in zip(starts, ends)
    ]
