"""Batched semi-global edit distance on device (JAX).

Device replacement for the reference's per-anchor seqan3 DP calls
(alignment.cpp:83-181): instead of one thread aligning one (node query,
reference window) pair at a time, whole batches of padded pairs run as one
jitted computation — existence checks and score+end for every PEX tree level
of every anchor in a read batch at once.

Formulation: column DP over the text (reference window), vectorized over the
batch and the pattern dimension. The in-column horizontal dependency
    C_new[i] = min(C[i-1] + sub, C[i] + 1, C_new[i-1] + 1)
is resolved with the min-plus prefix-scan identity
    C_new = cummin(tmp - iota) + iota,
which XLA lowers to a log-depth scan on the VPU; the text dimension is a
single lax.scan. Padding is masked so results are exact for ragged batches:
pattern padding rows are forced to +inf past the true pattern length, and
text padding columns never update the running optimum.

The optimum matches ops/dp_reference.py: rightmost minimal end column among
columns 0..n-1 where n is the true text length (see dp_reference docstring
for why the flush column is excluded — parity with the reference aligner).

For CIGARs (roots only, verification.cpp:206-213) the host reconstructs the
path with a banded traceback around the device-reported end column
(ops/dp_reference.align_semi_global); only accepted roots pay that cost.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# plain int: a jnp constant here would initialize the backend at import time
BIG = 1 << 20


@partial(jax.jit, static_argnames=("max_pattern_length",))
def batched_semi_global_distance(
    patterns: jax.Array,  # int8/int32 [B, M] padded with any value
    pattern_lengths: jax.Array,  # int32 [B]
    texts: jax.Array,  # int8/int32 [B, N] padded
    text_lengths: jax.Array,  # int32 [B]
    max_pattern_length: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Returns (distance, end_col) per batch row.

    distance[b] = min edit distance of patterns[b] against any substring of
    texts[b] ending at a column < text_lengths[b]; end_col[b] = the rightmost
    such column achieving it.
    """
    B, M = patterns.shape
    N = texts.shape[1]
    patterns = patterns.astype(jnp.int32)
    texts = texts.astype(jnp.int32)
    pattern_lengths = pattern_lengths.astype(jnp.int32)
    text_lengths = text_lengths.astype(jnp.int32)

    rows = jnp.arange(M + 1, dtype=jnp.int32)  # [M+1]
    # valid rows: 0..len inclusive; padding rows forced to BIG
    row_valid = rows[None, :] <= pattern_lengths[:, None]  # [B, M+1]
    last_row_idx = pattern_lengths  # [B]

    init_col = jnp.where(row_valid, rows[None, :], BIG)  # C[i] = i

    def step(carry, j):
        col, best, best_end = carry
        text_char = texts[:, j]  # [B]
        sub = (patterns != text_char[:, None]).astype(jnp.int32)  # [B, M]
        # candidates without the vertical in-column dependency; row 0 is the
        # free-leading-reference-gaps boundary dp[0][j] = 0
        tmp = jnp.concatenate(
            [
                jnp.zeros((B, 1), dtype=jnp.int32),
                jnp.minimum(col[:, :-1] + sub, col[:, 1:] + 1),
            ],
            axis=1,
        )
        # resolve C_new[i-1] + 1 dependency: cummin(tmp - i) + i
        new_col = (
            jax.lax.cummin(tmp - rows[None, :], axis=1) + rows[None, :]
        )
        new_col = jnp.where(row_valid, new_col, BIG)

        # score at the last pattern row for end column j+1
        score = jnp.take_along_axis(
            new_col, last_row_idx[:, None], axis=1
        ).squeeze(1)
        # eligible ends: columns 1..text_len-1 (flush column text_len excluded;
        # column 0 handled by the initial best below)
        eligible = (j + 1) < text_lengths
        improves = eligible & (score <= best)
        best = jnp.where(improves, score, best)
        best_end = jnp.where(improves, j + 1, best_end)
        return (new_col, best, best_end), None

    init_best = jnp.take_along_axis(
        init_col, last_row_idx[:, None], axis=1
    ).squeeze(1)  # end col 0: distance = pattern length
    init_end = jnp.zeros((B,), dtype=jnp.int32)

    (final_col, best, best_end), _ = jax.lax.scan(
        step, (init_col, init_best, init_end), jnp.arange(N, dtype=jnp.int32)
    )
    del final_col
    return best, best_end


def batched_exists(
    patterns, pattern_lengths, texts, text_lengths, num_allowed_errors
) -> jax.Array:
    """Existence-only mode (alignment.hpp:54): distance <= budget per row."""
    distance, _ = batched_semi_global_distance(
        patterns, pattern_lengths, texts, text_lengths
    )
    return distance <= jnp.asarray(num_allowed_errors, dtype=jnp.int32)


def pad_batch(
    sequences: list[np.ndarray], pad_to: int | None = None, multiple: int = 128
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side ragged->padded packing: [B, L] uint8 + lengths [B].

    Pads to a multiple of `multiple` lanes so XLA tiles cleanly on the VPU.
    """
    lengths = np.array([len(s) for s in sequences], dtype=np.int32)
    longest = int(lengths.max()) if len(sequences) else 1
    target = pad_to if pad_to is not None else longest
    target = max(target, 1)
    target = -(-target // multiple) * multiple
    out = np.zeros((len(sequences), target), dtype=np.uint8)
    for i, s in enumerate(sequences):
        out[i, : len(s)] = s
    return out, lengths
