"""Banded Myers kernel (ops/banded.py) vs the word-level mirror and the
full DP oracle; the choice between its CUDA and plain-XLA implementations;
the CUDA wrapper's shapes; and, on a GPU, the CUDA kernel itself."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from floxer_tpu.ops import banded, banded_cuda
from floxer_tpu.ops.banded import (
    _banded_xla,
    myers_banded_device,
    pack_nibbles,
    prepare_banded_batch,
)
from floxer_tpu.ops.device_dp import pad_batch
from floxer_tpu.ops.dp_reference import _rightmost_argmin, semi_global_dp_matrix
from floxer_tpu.ops.myers_banded import band_store_bits, myers_banded_np


def full_oracle(pattern, text):
    dp = semi_global_dp_matrix(text, pattern)
    last = dp[-1]
    end = _rightmost_argmin(last)
    return int(last[end]), end


def run_batch(patterns, texts, budgets):
    txt, tlen = pad_batch(texts)
    band_bits = max(
        band_store_bits(len(p), len(t), int(k))
        for p, t, k in zip(patterns, texts, budgets)
    )
    band_words = -(-band_bits // 32)
    band_words = -(-band_words // 128) * 128
    return myers_banded_device(
        patterns, txt, tlen, np.asarray(budgets), band_words
    )


@pytest.mark.parametrize("seed", range(3))
def test_matches_mirror_and_oracle(seed):
    rng = np.random.default_rng(seed)
    patterns, texts, budgets = [], [], []
    for _ in range(10):
        m = int(rng.integers(60, 500))
        budget = int(rng.integers(1, max(2, m // 5)))
        extra = int(rng.integers(0, budget + 2))
        n = m + 2 * budget + 1 + extra
        text = rng.integers(1, 5, size=n).astype(np.uint8)
        start = int(rng.integers(0, n - m))
        pattern = text[start : start + m].copy()
        for _ in range(int(rng.integers(0, budget + 2))):
            op = rng.integers(0, 3)
            pos = int(rng.integers(0, len(pattern)))
            if op == 0:
                pattern[pos] = 1 + (pattern[pos] % 4)
            elif op == 1 and len(pattern) > 10:
                pattern = np.delete(pattern, pos)
            else:
                pattern = np.insert(pattern, pos, rng.integers(1, 5))
        if budget >= len(pattern):
            continue
        patterns.append(pattern)
        texts.append(text)
        budgets.append(budget)

    dist, end = run_batch(patterns, texts, budgets)
    for i, (pattern, text, budget) in enumerate(
        zip(patterns, texts, budgets)
    ):
        want = myers_banded_np(pattern, text, budget)
        got = (int(dist[i]), int(end[i]))
        # the kernel freezes the band at row m instead of sliding past it,
        # so it can only be MORE exact than the mirror; both must satisfy
        # the full-DP contract
        full_d, full_e = full_oracle(pattern, text)
        if full_d <= budget:
            assert got == (full_d, full_e), f"row {i}"
            assert want == (full_d, full_e), f"mirror row {i}"
        else:
            assert got[0] > budget, f"row {i} false accept"


def test_mixed_band_sizes_one_bucket():
    """Tasks with different m, n, budget share one padded call."""
    rng = np.random.default_rng(7)
    patterns, texts, budgets = [], [], []
    for m, budget in [(70, 3), (300, 20), (512, 33), (130, 1), (95, 12)]:
        n = m + 2 * budget + 1 + int(rng.integers(0, 30))
        text = rng.integers(1, 5, size=n).astype(np.uint8)
        start = int(rng.integers(0, n - m))
        pattern = text[start : start + m].copy()
        for _ in range(budget // 2):
            pos = int(rng.integers(0, m))
            pattern[pos] = 1 + (pattern[pos] % 4)
        patterns.append(pattern)
        texts.append(text)
        budgets.append(budget)
    dist, end = run_batch(patterns, texts, budgets)
    for i, (pattern, text, budget) in enumerate(
        zip(patterns, texts, budgets)
    ):
        full_d, full_e = full_oracle(pattern, text)
        assert full_d <= budget
        assert (int(dist[i]), int(end[i])) == (full_d, full_e), f"row {i}"


def _random_tasks(rng, count, min_m, max_m):
    patterns, texts, budgets = [], [], []
    for _ in range(count):
        m = int(rng.integers(min_m, max_m))
        budget = int(rng.integers(1, max(2, m // 5)))
        n = m + 2 * budget + 1 + int(rng.integers(-budget, budget + 40))
        text = rng.integers(1, 5, size=n).astype(np.uint8)
        start = int(rng.integers(0, max(1, n - m)))
        pattern = text[start : start + m].copy()
        if len(pattern) < m:
            pattern = rng.integers(1, 5, size=m).astype(np.uint8)
        for _ in range(int(rng.integers(0, budget + 2))):
            pos = int(rng.integers(0, m))
            pattern[pos] = 1 + (pattern[pos] % 4)
        patterns.append(pattern)
        texts.append(text)
        budgets.append(budget)
    return patterns, texts, budgets


def _prepared(patterns, texts, budgets, band_words):
    """Device inputs of banded.banded_call for host-side tasks."""
    num_text = -(-max(len(t) for t in texts) // 8) * 8
    vp0, planes0, stream, scalars = prepare_banded_batch(
        patterns, np.asarray(budgets), band_words, num_text
    )
    scalars[0][:, 0] = [len(t) for t in texts]
    chars = np.zeros((len(texts), num_text), dtype=np.uint8)
    for i, text in enumerate(texts):
        chars[i, : len(text)] = text
    args = (
        jnp.asarray(vp0),
        jnp.asarray(planes0),
        jnp.asarray(pack_nibbles(chars)),
        jnp.asarray(stream),
        tuple(jnp.asarray(s) for s in scalars),
    )
    return args, num_text


@pytest.mark.parametrize(
    "platform,band_words,want",
    [
        ("gpu", 128, "cuda"),
        ("gpu", 1024, "cuda"),
        ("gpu", 1152, "xla"),
        ("cpu", 128, "xla"),
        ("cpu", 256, "xla"),
    ],
)
def test_implementation_choice(monkeypatch, platform, band_words, want):
    """The CUDA kernel on a GPU for the bands it holds in registers, the
    plain-XLA formulation everywhere else."""
    from floxer_tpu import backend

    monkeypatch.setattr(backend, "ensure_backend", lambda: platform)
    assert banded.implementation(band_words) == want


def test_gpu_without_cuda_library_raises(monkeypatch, tmp_path):
    """On a GPU a kernel library that cannot be built is an error, never a
    quiet switch to the plain-XLA kernel."""
    from floxer_tpu import backend

    monkeypatch.setattr(backend, "ensure_backend", lambda: "gpu")
    monkeypatch.setattr(banded_cuda, "_library", None)
    monkeypatch.setattr(banded_cuda, "LIBRARY", tmp_path / "missing.so")
    monkeypatch.setattr(banded_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(banded_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(
        banded_cuda, "NVCC_FALLBACK", str(tmp_path / "no-nvcc")
    )
    rng = np.random.default_rng(0)
    args, num_text = _prepared(*_random_tasks(rng, 4, 40, 80), 128)
    with pytest.raises(RuntimeError, match="nvcc"):
        banded.banded_call(*args, band_words=128, num_text=num_text)


@pytest.mark.parametrize("num_tasks,band_words", [(1, 128), (13, 256)])
def test_cuda_wrapper_shapes(monkeypatch, num_tasks, band_words):
    """The FFI call's operands and results: scalars packed to [T, 6] in
    kernel order, (dist, end) int32 [T, 1] each."""
    monkeypatch.setattr(banded_cuda, "ensure_registered", lambda: None)
    T = num_tasks
    scalars = tuple(
        jnp.full((T, 1), i + 1, dtype=jnp.int32) for i in range(6)
    )
    packed = np.asarray(banded_cuda.pack_scalars(scalars))
    assert packed.shape == (T, 6) and packed.dtype == np.int32
    np.testing.assert_array_equal(packed[0], np.arange(1, 7))
    dist, end = jax.eval_shape(
        banded_cuda.banded_cuda_call,
        jax.ShapeDtypeStruct((T, band_words), jnp.uint32),
        jax.ShapeDtypeStruct((T, 4, band_words), jnp.uint32),
        jax.ShapeDtypeStruct((T, 128), jnp.uint32),
        jax.ShapeDtypeStruct((T, 128), jnp.uint32),
        scalars,
    )
    for out in (dist, end):
        assert out.shape == (T, 1) and out.dtype == jnp.int32


@pytest.mark.parametrize("band_words", [96, 1152])
def test_cuda_wrapper_rejects_unsupported_bands(band_words):
    scalars = tuple(jnp.zeros((2, 1), dtype=jnp.int32) for _ in range(6))
    with pytest.raises(ValueError, match="band_words"):
        banded_cuda.banded_cuda_call(
            jnp.zeros((2, band_words), jnp.uint32),
            jnp.zeros((2, 4, band_words), jnp.uint32),
            jnp.zeros((2, 8), jnp.uint32),
            jnp.zeros((2, 8), jnp.uint32),
            scalars,
        )


def test_xla_short_and_empty_windows():
    """Text lengths 0 and 1 score no column: distance m, end 0."""
    rng = np.random.default_rng(3)
    patterns, texts, budgets = _random_tasks(rng, 3, 40, 120)
    args, num_text = _prepared(patterns, texts, budgets, 128)
    *inputs, scalars = args
    scalars = (jnp.asarray([[0], [1], [len(texts[2])]], jnp.int32),) + (
        scalars[1:]
    )
    dist, end = _banded_xla(
        *inputs, scalars, band_words=128, num_text=num_text
    )
    assert [int(d) for d in dist[:2, 0]] == [len(p) for p in patterns[:2]]
    assert [int(e) for e in end[:2, 0]] == [0, 0]
    want = full_oracle(patterns[2], texts[2])
    if want[0] <= budgets[2]:
        assert (int(dist[2, 0]), int(end[2, 0])) == want


@pytest.mark.gpu
@pytest.mark.parametrize("band_words", [128, 256, 384, 1024])
def test_cuda_kernel_matches_xla(gpu, band_words):
    """The Hopper kernel against the plain-XLA formulation, exact on every
    task, including frozen bands (m >= band bits) and tasks whose band is
    wider than they need."""
    from floxer_tpu.ops.banded_cuda import banded_cuda_call

    rng = np.random.default_rng(band_words)
    patterns, texts, budgets = _random_tasks(rng, 37, 60, 1500)
    long_m = band_words * 32 + 300
    more = _random_tasks(rng, 5, long_m, long_m + 400)
    patterns += more[0]
    texts += more[1]
    budgets += [min(b, 200) for b in more[2]]
    keep = [
        i for i, (p, t, k) in enumerate(zip(patterns, texts, budgets))
        if band_store_bits(len(p), len(t), k) <= band_words * 32
    ]
    patterns = [patterns[i] for i in keep]
    texts = [texts[i] for i in keep]
    budgets = [budgets[i] for i in keep]
    args, num_text = _prepared(patterns, texts, budgets, band_words)
    got = jax.jit(banded_cuda_call)(*args)
    want = _banded_xla(*args, band_words=band_words, num_text=num_text)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
