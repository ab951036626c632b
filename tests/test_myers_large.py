"""Carry-scan Myers (large patterns) vs the unrolled kernel and DP oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from floxer_tpu.ops.device_dp import pad_batch
from floxer_tpu.ops.dp_reference import _rightmost_argmin, semi_global_dp_matrix
from floxer_tpu.ops.myers import (
    build_peq_vectorized,
    myers_batched,
    myers_batched_large,
)


def oracle(pattern, text):
    dp = semi_global_dp_matrix(text, pattern)
    last = dp[-1]
    end = _rightmost_argmin(last)
    return int(last[end]), end


def _run(kernel, patterns, texts):
    pat, plen = pad_batch(patterns)
    txt, tlen = pad_batch(texts)
    peq = build_peq_vectorized(pat, plen)
    d, e = kernel(
        jnp.asarray(peq),
        jnp.asarray(plen),
        jnp.asarray(txt.astype(np.int32)),
        jnp.asarray(tlen),
        num_words=peq.shape[2],
    )
    return np.asarray(d), np.asarray(e)


@pytest.mark.parametrize(
    "seed,max_m,min_m,max_extra",
    [
        (0, 100, 40, 120),
        (1, 400, 40, 120),
        (2, 900, 40, 120),
        # shorter patterns and overhangs
        (0, 60, 20, 60),
        (1, 200, 20, 60),
    ],
    ids=["0-100", "1-400", "2-900", "0-60-short", "1-200-short"],
)
def test_large_kernel_matches_oracle(seed, max_m, min_m, max_extra):
    rng = np.random.default_rng(seed)
    patterns, texts = [], []
    for _ in range(6):
        m = int(rng.integers(min_m, max_m))
        n = int(rng.integers(m, m + max_extra))
        text = rng.integers(1, 5, size=n).astype(np.uint8)
        start = int(rng.integers(0, max(1, n - m)))
        pattern = text[start : start + m].copy()
        for _ in range(int(rng.integers(0, 8))):
            pos = int(rng.integers(0, len(pattern)))
            pattern[pos] = 1 + (pattern[pos] % 4)
        patterns.append(pattern)
        texts.append(text)

    d, e = _run(myers_batched_large, patterns, texts)
    for i, (pattern, text) in enumerate(zip(patterns, texts)):
        want_d, want_e = oracle(pattern, text)
        assert d[i] == want_d, f"row {i}"
        assert e[i] == want_e, f"row {i}"


def test_both_kernels_agree():
    rng = np.random.default_rng(5)
    patterns = [rng.integers(1, 5, size=200).astype(np.uint8) for _ in range(4)]
    texts = [rng.integers(1, 5, size=300).astype(np.uint8) for _ in range(4)]
    d1, e1 = _run(myers_batched, patterns, texts)
    d2, e2 = _run(myers_batched_large, patterns, texts)
    assert np.array_equal(d1, d2)
    assert np.array_equal(e1, e2)
