"""Compile, check and time every device kernel of the verification path.

    python -m floxer_tpu.tools.kernel_check [--out FILE]

For each kernel at the widths the aligner runs it at:

  - banded (ops/banded.py) at the PEX-root shape of a 20 kb read at
    p = 0.08: 256 tasks, pattern 20,600, window 24,800, budget 1,442,
    band 256 words; both implementations, the CUDA kernel (on a GPU) and
    the plain-XLA formulation;
  - small full-state (ops/myers.myers_batched): 128 tasks, m <= 200,
    n <= 1,536;
  - large full-state (ops/myers.myers_batched_large): 8 tasks, m = 2,000,
    n = 3,072.

Each is compiled ahead of time (compile seconds and
`compiled.memory_analysis()` printed), run once warm, then timed over a
few calls that each end in block_until_ready. Its (distance, end column)
must equal the plain references exactly: the native host engine
(myers_host.cpp, full Myers) for every task, and for a few tasks the
numpy banded mirror (ops/myers_banded.py) and the full DP matrix
(ops/dp_reference.py). The references run in CPU worker processes while
the device kernels run. One `KERNEL {json}` line per kernel and
implementation; exit status 1 on any mismatch.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import statistics
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

ROOT_SHAPE = dict(tasks=256, m=20_600, n=24_800, budget=1_442, band_words=256)
SMALL_SHAPE = dict(tasks=128, max_m=200, max_n=1_536)
LARGE_SHAPE = dict(tasks=8, m=2_000, n=3_072)
SAMPLED_TASKS = 4  # tasks checked against the mirror and the DP matrix
TIMED_CALLS = 3  # warm calls timed per kernel (the median is reported)


def _root_tasks(seed: int = 0):
    """PEX-root verification tasks: a pattern cut from its window with 5%
    substitutions, so every task is within budget."""
    rng = np.random.default_rng(seed)
    T, M, N = ROOT_SHAPE["tasks"], ROOT_SHAPE["m"], ROOT_SHAPE["n"]
    texts = rng.integers(1, 5, size=(T, N)).astype(np.uint8)
    patterns = []
    for t in range(T):
        start = int(rng.integers(0, N - M))
        pattern = texts[t, start : start + M].copy()
        positions = rng.integers(0, M, size=M // 20)
        pattern[positions] = 1 + (pattern[positions] % 4)
        patterns.append(pattern)
    return patterns, [texts[t] for t in range(T)]


def _full_tasks(seed: int, tasks: int, min_m: int, max_m: int, max_n: int):
    rng = np.random.default_rng(seed)
    patterns, texts = [], []
    for _ in range(tasks):
        m = int(rng.integers(min_m, max_m + 1))
        n = int(rng.integers(m, max_n + 1))
        text = rng.integers(1, 5, size=n).astype(np.uint8)
        start = int(rng.integers(0, n - m + 1))
        pattern = text[start : start + m].copy()
        positions = rng.integers(0, m, size=max(1, m // 15))
        pattern[positions] = 1 + (pattern[positions] % 4)
        patterns.append(pattern)
        texts.append(text)
    return patterns, texts


# --- references, run in CPU worker processes --------------------------------


def _worker_init() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"


def _dp_reference(pattern, text):
    from floxer_tpu.ops.dp_reference import (
        _rightmost_argmin,
        semi_global_dp_matrix,
    )

    last = semi_global_dp_matrix(text, pattern)[-1]
    end = _rightmost_argmin(last)
    return int(last[end]), int(end)


def _mirror(pattern, text, budget):
    from floxer_tpu.ops.myers_banded import myers_banded_np

    distance, end = myers_banded_np(pattern, text, budget)
    return int(distance), int(end)


def _host_engine(patterns, texts):
    from floxer_tpu.native import native_myers_distance_batch

    result = native_myers_distance_batch(
        texts, patterns, num_threads=min(8, os.cpu_count() or 1)
    )
    if result is None:
        raise RuntimeError("the native host engine is unavailable")
    return result[0].astype(np.int64), result[1].astype(np.int64)


# --- device side --------------------------------------------------------------


def _time_compiled(fn, args, iters: int):
    """(compile seconds, memory analysis, outputs, per-call seconds)."""
    import jax

    started = time.perf_counter()
    compiled = fn.lower(*args).compile()
    compile_s = time.perf_counter() - started
    analysis = compiled.memory_analysis()
    memory = {
        name: int(getattr(analysis, name))
        for name in (
            "argument_size_in_bytes",
            "output_size_in_bytes",
            "temp_size_in_bytes",
            "generated_code_size_in_bytes",
        )
        if analysis is not None and hasattr(analysis, name)
    }
    outputs = jax.block_until_ready(compiled(*args))  # warm
    times = []
    for _ in range(iters):
        started = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - started)
    return compile_s, memory, outputs, times


def _banded_device_inputs(patterns, texts):
    import jax.numpy as jnp

    from floxer_tpu.ops.banded import pack_nibbles, prepare_banded_batch

    T = len(patterns)
    num_text = -(-ROOT_SHAPE["n"] // 8) * 8
    budgets = np.full(T, ROOT_SHAPE["budget"], dtype=np.int64)
    vp0, planes0, stream, scalars = prepare_banded_batch(
        patterns, budgets, ROOT_SHAPE["band_words"], num_text
    )
    scalars[0][:, 0] = [len(t) for t in texts]
    chars = np.zeros((T, num_text), dtype=np.uint8)
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


def _report(record: dict, out) -> None:
    line = "KERNEL " + json.dumps(record, sort_keys=True)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


def _banded_contract(got, want, budget):
    """ops/myers_banded.py contract: exact when the full distance is within
    budget, else a distance above budget."""
    dist, end = got
    full_dist, full_end = want
    if full_dist <= budget:
        return (int(dist), int(end)) == (int(full_dist), int(full_end))
    return int(dist) > budget


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also append the KERNEL lines here")
    args = parser.parse_args(argv)

    import functools

    import jax

    from floxer_tpu.backend import ensure_backend
    from floxer_tpu.native import get_library
    from floxer_tpu.ops import banded
    from floxer_tpu.ops.myers import (
        build_peq_vectorized,
        myers_batched,
        myers_batched_large,
    )
    from floxer_tpu.ops.device_dp import pad_batch

    platform = ensure_backend()
    device = jax.devices()[0]
    print(
        f"kernel_check: platform={platform} device_kind={device.device_kind} "
        f"count={len(jax.devices())} banded implementation at "
        f"{ROOT_SHAPE['band_words']} words: "
        f"{banded.implementation(ROOT_SHAPE['band_words'])}",
        flush=True,
    )
    get_library()  # build the native host engine before the workers need it

    root_patterns, root_texts = _root_tasks()
    small_patterns, small_texts = _full_tasks(
        1, SMALL_SHAPE["tasks"], 2, SMALL_SHAPE["max_m"], SMALL_SHAPE["max_n"]
    )
    large_patterns, large_texts = _full_tasks(
        2, LARGE_SHAPE["tasks"], LARGE_SHAPE["m"], LARGE_SHAPE["m"],
        LARGE_SHAPE["n"],
    )
    sampled = range(SAMPLED_TASKS)
    budget = ROOT_SHAPE["budget"]

    context = multiprocessing.get_context("spawn")
    workers = min(2 * SAMPLED_TASKS + 3, os.cpu_count() or 1)
    with ProcessPoolExecutor(
        max_workers=workers, mp_context=context, initializer=_worker_init
    ) as pool:
        pending = {
            "root_host": pool.submit(_host_engine, root_patterns, root_texts),
            "small_host": pool.submit(
                _host_engine, small_patterns, small_texts
            ),
            "large_host": pool.submit(
                _host_engine, large_patterns, large_texts
            ),
        }
        for i in sampled:
            pending[("root_mirror", i)] = pool.submit(
                _mirror, root_patterns[i], root_texts[i], budget
            )
            pending[("root_dp", i)] = pool.submit(
                _dp_reference, root_patterns[i], root_texts[i]
            )
            pending[("small_dp", i)] = pool.submit(
                _dp_reference, small_patterns[i], small_texts[i]
            )
            pending[("large_dp", i)] = pool.submit(
                _dp_reference, large_patterns[i], large_texts[i]
            )

        results = []  # (record, outputs)

        # banded: every implementation available on this platform
        root_args, num_text = _banded_device_inputs(root_patterns, root_texts)
        band_words = ROOT_SHAPE["band_words"]
        implementations = {
            "xla": jax.jit(
                functools.partial(
                    banded._banded_xla,
                    band_words=band_words,
                    num_text=num_text,
                )
            )
        }
        if platform == "gpu":
            from floxer_tpu.ops.banded_cuda import banded_cuda_call

            implementations = {
                "cuda": jax.jit(banded_cuda_call), **implementations
            }
        band_rows = min(
            ROOT_SHAPE["n"] - ROOT_SHAPE["m"] + 2 * budget + 1, ROOT_SHAPE["m"]
        )
        band_cells = ROOT_SHAPE["tasks"] * band_rows * ROOT_SHAPE["n"]
        for name, fn in implementations.items():
            compile_s, memory, outputs, times = _time_compiled(
                fn, root_args, TIMED_CALLS
            )
            seconds = statistics.median(times)
            results.append((
                {
                    "kernel": "banded",
                    "implementation": name,
                    "shape": dict(ROOT_SHAPE),
                    "compile_s": compile_s,
                    "memory": memory,
                    "call_s": times,
                    "band_cells_per_s": band_cells / seconds,
                },
                (np.asarray(outputs[0])[:, 0], np.asarray(outputs[1])[:, 0]),
            ))

        # full-state kernels
        for name, kernel, patterns, texts in (
            ("small", myers_batched, small_patterns, small_texts),
            ("large", myers_batched_large, large_patterns, large_texts),
        ):
            pat, plen = pad_batch(patterns)
            txt, tlen = pad_batch(texts)
            peq = build_peq_vectorized(pat, plen)
            fn = jax.jit(functools.partial(kernel, num_words=peq.shape[2]))
            device_args = (
                jax.numpy.asarray(peq),
                jax.numpy.asarray(plen, dtype=jax.numpy.int32),
                jax.numpy.asarray(txt),
                jax.numpy.asarray(tlen, dtype=jax.numpy.int32),
            )
            compile_s, memory, outputs, times = _time_compiled(
                fn, device_args, TIMED_CALLS
            )
            cells = int(sum(len(p) * len(t) for p, t in zip(patterns, texts)))
            results.append((
                {
                    "kernel": name,
                    "implementation": "xla",
                    "shape": SMALL_SHAPE if name == "small" else LARGE_SHAPE,
                    "compile_s": compile_s,
                    "memory": memory,
                    "call_s": times,
                    "cells_per_s": cells / statistics.median(times),
                },
                (np.asarray(outputs[0]), np.asarray(outputs[1])),
            ))

        refs = {key: future.result() for key, future in pending.items()}

    out = open(args.out, "a") if args.out else None
    ok = True
    for record, (dist, end) in results:
        kernel = record["kernel"]
        host_key = "root_host" if kernel == "banded" else f"{kernel}_host"
        host_dist, host_end = refs[host_key]
        if kernel == "banded":
            host_ok = all(
                _banded_contract(
                    (dist[i], end[i]), (host_dist[i], host_end[i]), budget
                )
                for i in range(len(dist))
            )
            mirror_ok = all(
                _banded_contract(
                    refs[("root_mirror", i)], refs[("root_dp", i)], budget
                )
                for i in sampled
            )
            dp_ok = all(
                _banded_contract(
                    (dist[i], end[i]), refs[("root_dp", i)], budget
                )
                for i in sampled
            )
            record["tasks_within_budget"] = int(np.sum(host_dist <= budget))
        else:
            host_ok = bool(
                np.array_equal(dist, host_dist) and np.array_equal(end, host_end)
            )
            mirror_ok = None
            dp_ok = all(
                (int(dist[i]), int(end[i])) == refs[(f"{kernel}_dp", i)]
                for i in sampled
            )
        record["matches"] = {
            "host_engine_all_tasks": host_ok,
            "numpy_mirror_sampled": mirror_ok,
            "dp_reference_sampled": dp_ok,
        }
        record["device_kind"] = device.device_kind
        record["platform"] = platform
        _report(record, out)
        ok = ok and host_ok and dp_ok and mirror_ok is not False
    if len({
        (tuple(d), tuple(e))
        for record, (d, e) in results if record["kernel"] == "banded"
    }) != 1:
        print("kernel_check: banded implementations disagree", flush=True)
        ok = False
    if out is not None:
        out.close()
    print(f"kernel_check: {'ok' if ok else 'MISMATCH'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
