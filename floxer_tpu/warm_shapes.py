"""Self-learning kernel-shape pre-warmer.

The FIRST execution of each compiled program in a process pays its
compile, or its load from the persistent jax compilation cache, before
any work. The bucket shapes are heavily quantized (powers of two / tile
multiples — see verify_batch._TaskBatcher.run), so a given workload class
touches a SMALL closed set of programs that is identical across runs.

This module records every device bucket shape the batcher dispatches and
replays the set at startup inside the device warmup thread (pipeline.run
starts it before the index build, so the replay overlaps the GIL-free
build/load phase instead of stalling the first verification wave).
Replayed dummy tasks carry window length 1, so the kernels' dynamic column
bounds exit after one block: the replay pays only the per-program
first-execution cost, microseconds of kernel time.

The reference has no analogue — its engines are host code with no
program-load step. This is device-runtime plumbing in the same spirit as
the jax persistent compilation cache it complements. Whether it still
pays for itself beside that cache on the GPU is not measured yet.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from pathlib import Path

logger = logging.getLogger("floxer-tpu")

_LOCK = threading.Lock()
_SESSION: set[tuple] = set()  # shapes dispatched this process
_LOADED: list | None = None
_MAX_ENTRIES = 96


def _store_path() -> Path:
    base = os.environ.get("FLOXER_TPU_WARM_SHAPES")
    if base:
        return Path(base)
    from .backend import CACHE_DIR

    return CACHE_DIR / "warm_shapes.json"


def _load() -> list:
    global _LOADED
    if _LOADED is None:
        try:
            _LOADED = json.loads(_store_path().read_text())
            assert isinstance(_LOADED, list)
        except Exception:  # noqa: BLE001 - missing/corrupt file: start fresh
            _LOADED = []
    return _LOADED


def record_shape(desc: tuple) -> None:
    """Note a dispatched device-bucket shape; appended to the store once
    per process (first new shape flushes eagerly — long runs should leave
    a warm file even if killed)."""
    with _LOCK:
        if desc in _SESSION:
            return
        _SESSION.add(desc)
        known = _load()
        entry = list(desc)
        if entry in known:
            return
        known.append(entry)
        del known[:-_MAX_ENTRIES]
        try:
            path = _store_path()
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".tmp{os.getpid()}")
            tmp.write_text(json.dumps(known))
            os.replace(tmp, path)
        except Exception as error:  # noqa: BLE001 - best-effort persistence
            logger.debug("warm-shape store write failed: %s", error)


def _dummy_bank(flat_len: int):
    """A stand-in with the only attribute the resident entry points use:
    a device-resident uint32 array of exactly the recorded size (the size
    is part of the jit cache key)."""
    import jax.numpy as jnp

    class _Bank:
        flat = jnp.zeros(flat_len, dtype=jnp.uint32)

    return _Bank()


def _replay_one(desc: list):
    import numpy as np

    kind = desc[0]
    if kind == "banded_resident":
        _, band_words, num_text, T, ref_len, query_len = desc
        from .ops.resident import myers_banded_resident

        return myers_banded_resident(
            _dummy_bank(ref_len), _dummy_bank(query_len),
            np.zeros(T, dtype=np.int64), np.ones(T, dtype=np.int64),
            np.zeros(T, dtype=np.int64), np.full(T, 2, dtype=np.int64),
            np.ones(T, dtype=np.int64),
            band_words=band_words, num_text=num_text, sync=False,
        )
    if kind == "full_resident":
        _, m_bucket, num_text, T, ref_len, query_len = desc
        from .ops.resident import myers_full_resident

        return myers_full_resident(
            _dummy_bank(ref_len), _dummy_bank(query_len),
            np.zeros(T, dtype=np.int64), np.ones(T, dtype=np.int64),
            np.zeros(T, dtype=np.int64), np.ones(T, dtype=np.int64),
            m_bucket=m_bucket, num_text=num_text, sync=False,
        )
    if kind == "banded_host":
        _, band_words, n_bucket, b_bucket = desc
        from .ops.banded import myers_banded_device

        patterns = [np.zeros(2, dtype=np.uint8)] * b_bucket
        texts = np.zeros((b_bucket, n_bucket), dtype=np.uint8)
        return myers_banded_device(
            patterns, texts,
            np.ones(b_bucket, dtype=np.int64),
            np.ones(b_bucket, dtype=np.int64),
            band_words=band_words, sync=False,
        )
    if kind == "fused":
        _, plan, num_walks, ref_len, query_len = desc
        from .ops.fused_verify import replay_plan

        return replay_plan(plan, num_walks, ref_len, query_len)
    if kind == "full_host":
        _, m_bucket, n_bucket, b_bucket = desc
        from .ops.myers import myers_distance

        pat = np.zeros((b_bucket, m_bucket), dtype=np.uint8)
        txt = np.zeros((b_bucket, n_bucket), dtype=np.uint8)
        return myers_distance(
            pat, np.ones(b_bucket, dtype=np.int32),
            txt, np.ones(b_bucket, dtype=np.int32),
        )
    return None


def replay(should_abort=None) -> tuple[int, int]:
    """Execute every recorded shape once with trivial dummy inputs.
    Returns (programs_ok, fused_plans_ok) — the caller reports readiness
    from the fused count (VERDICT r4 item 2: engagement must be provable
    before the align phase starts).

    Dispatches everything asynchronously first, then syncs, so the
    program loads overlap instead of paying one round trip each. Called
    from the device warmup thread on a GPU only. `should_abort` (zero-arg
    callable) is polled between programs so process shutdown stops the
    replay instead of waiting for it."""
    import time as _time

    import numpy as np

    shapes = list(_load())
    if not shapes:
        return (0, 0)
    # fused plans first, newest first: they are the production dispatch
    # path, the most recently recorded plan is the converged template
    # (earlier ones are its growth steps), and the align loop's device
    # routing waits for warmup readiness — a long tail of stale shapes
    # must not starve it. The budget caps the whole replay.
    shapes = [d for d in reversed(shapes) if d[0] == "fused"] + [
        d for d in shapes if d[0] != "fused"
    ]
    budget_s = float(os.environ.get("FLOXER_TPU_WARM_BUDGET_S", "90"))
    t0 = _time.monotonic()
    pending = []
    for desc in shapes:
        if should_abort is not None and should_abort():
            break
        if _time.monotonic() - t0 > budget_s:
            logger.debug("warm-shape replay budget reached; stopping")
            break
        try:
            out = _replay_one(desc)
            if out is not None:
                pending.append((desc, out))
        except Exception as error:  # noqa: BLE001 - stale/corrupt entries
            logger.debug("warm-shape replay dispatch %s: %s", desc, error)
    ok = fused_ok = 0
    for desc, out in pending:
        if should_abort is not None and should_abort():
            break
        try:
            np.asarray(out[0])
            ok += 1
            if desc[0] == "fused":
                fused_ok += 1
        except Exception as error:  # noqa: BLE001
            logger.debug("warm-shape replay sync %s: %s", desc, error)
    logger.debug(
        "warm-shape replay: %d/%d programs (%d fused plans) in %.1fs",
        ok, len(shapes), fused_ok, _time.monotonic() - t0,
    )
    return (ok, fused_ok)
