"""Myers bit-parallel kernel vs the DP oracle, including multi-word patterns."""

import numpy as np
import pytest

from floxer_tpu.ops.device_dp import pad_batch
from floxer_tpu.ops.dp_reference import _rightmost_argmin, semi_global_dp_matrix
from floxer_tpu.ops.myers import build_peq, build_peq_vectorized, myers_distance


def oracle(pattern, text):
    dp = semi_global_dp_matrix(text, pattern)
    last = dp[-1]
    end = _rightmost_argmin(last)
    return int(last[end]), end


def test_peq_builders_agree():
    rng = np.random.default_rng(0)
    patterns, lengths = pad_batch(
        [rng.integers(1, 6, size=int(rng.integers(1, 70))).astype(np.uint8)
         for _ in range(9)]
    )
    assert np.array_equal(
        build_peq(patterns, lengths), build_peq_vectorized(patterns, lengths)
    )


@pytest.mark.parametrize(
    "seed,max_m,rows,max_extra,mutated_share",
    [
        (0, 30, 13, 60, 0.7),
        (1, 30, 13, 60, 0.7),
        (2, 100, 13, 60, 0.7),
        (3, 200, 13, 60, 0.7),
        # few rows, short overhangs, every pattern a mutated text slice
        (0, 30, 7, 40, 1.0),
        (1, 90, 7, 40, 1.0),
    ],
    ids=["0-30", "1-30", "2-100", "3-200", "0-30-few-rows", "1-90-few-rows"],
)
def test_myers_matches_oracle(seed, max_m, rows, max_extra, mutated_share):
    rng = np.random.default_rng(seed)
    patterns = []
    texts = []
    for _ in range(rows):
        m = int(rng.integers(2, max_m))
        n = int(rng.integers(m, m + max_extra))
        text = rng.integers(1, 5, size=n).astype(np.uint8)
        if rng.random() < mutated_share:
            start = int(rng.integers(0, max(1, n - m)))
            pattern = text[start : start + m].copy()
            for _ in range(int(rng.integers(0, 4))):
                pos = int(rng.integers(0, len(pattern)))
                pattern[pos] = 1 + (pattern[pos] % 4)
        else:
            pattern = rng.integers(1, 5, size=m).astype(np.uint8)
        patterns.append(pattern)
        texts.append(text)

    pat, pat_len = pad_batch(patterns)
    txt, txt_len = pad_batch(texts)
    distance, end = myers_distance(pat, pat_len, txt, txt_len)
    distance = np.asarray(distance)
    end = np.asarray(end)

    for i, (pattern, text) in enumerate(zip(patterns, texts)):
        want_distance, want_end = oracle(pattern, text)
        assert distance[i] == want_distance, f"row {i}"
        assert end[i] == want_end, f"row {i} end"
