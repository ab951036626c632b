"""Batched PEX verification: level-synchronous device execution with
sequential bookkeeping.

Replaces the per-anchor thread-pool verification (parallelization.cpp:193-293)
with a two-phase scheme shaped for a batched device:

  PHASE A (batched compute): every anchor's hierarchical walk is unrolled
  level-synchronously — all inner-node (node query, reference window) pairs
  of one level across the whole read batch run as ONE padded Myers-kernel
  call (ops/myers); survivors advance to their parent level; root tasks get
  score + end column (forward for CIGAR mode, reversed for the
  begin-from-reversed-end trick, alignment.cpp:115-145) and accepted roots
  get a host banded traceback. Duplicate (window, node) tasks — shifted
  anchors verifying the same span — are deduplicated before kernel launch,
  the batch-level counterpart of the reference's verified_intervals.

  PHASE B (sequential bookkeeping): anchors replay IN ORDER against the
  per-(reference, orientation) interval caches, reproducing the reference's
  single-thread semantics byte-for-byte: cache-skip before the walk
  (verification.cpp:119-136), span-size statistics only for levels actually
  walked, root interval insertion after every root alignment attempt
  (verification.cpp:106-109), alignment recording for accepted roots.

Output equality with verify.QueryVerifier is asserted by the test suite on
randomized workloads.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .intervals import VerifiedIntervals

_TRACEBACK_POOL = None


def _traceback_pool():
    global _TRACEBACK_POOL
    if _TRACEBACK_POOL is None:
        import os
        from concurrent.futures import ThreadPoolExecutor

        _TRACEBACK_POOL = ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            thread_name_prefix="traceback",
        )
    return _TRACEBACK_POOL

from .cigar import Cigar
from .ops import dp_reference
from .ops.dp_reference import Orientation, QueryAlignment


def _cigar_value(cigar):
    """Cigar containers are immutable — share them; plain op lists are
    defensively copied (they may be memo-shared across alignments)."""
    return cigar if isinstance(cigar, Cigar) else list(cigar)
from .ops.myers import myers_distance
from .pex import PexNode, PexTree
from .search_host import Anchor, SearchResult
from .verify import (
    QueryAlignments,
    SpanConfig,
    VerificationKind,
    compute_reference_span,
)

# device-routing threshold in useful DP cells per full-state bucket:
# smaller buckets run on the native host Myers engine (myers_host.cpp),
# which finishes them before a device dispatch and download would. The
# value is not yet measured against the card's dispatch cost.
MIN_DEVICE_CELLS = int(
    __import__("os").environ.get("FLOXER_TPU_MIN_DEVICE_CELLS", "1000000000")
)

# test hook: route every eligible task through the banded kernel even when
# its band is not narrower than the full state (exercises the banded batch
# path with small shapes)
_FORCE_BANDED = bool(
    __import__("os").environ.get("FLOXER_TPU_FORCE_BANDED", "")
)

# kill switch for the device-resident gather path (A/B measurements)
_NO_RESIDENT = bool(
    __import__("os").environ.get("FLOXER_TPU_NO_RESIDENT", "")
)

# kill switch for the one-dispatch fused wave path (A/B measurements); and
# a test hook forcing it regardless of backend (the CPU runs the plain-XLA
# kernels)
_NO_FUSED = bool(__import__("os").environ.get("FLOXER_TPU_NO_FUSED", ""))
_FORCE_FUSED = bool(
    __import__("os").environ.get("FLOXER_TPU_FORCE_FUSED", "")
)

# Latency-adaptive banded routing: WHERE a bucket should run is decided by
# comparing the estimated host time (band cells over the native
# lane-parallel banded engine's rate, myers_host.cpp) with the estimated
# device time (a per-call overhead plus padded band cells over the device
# kernel's rate). The overhead term starts from a measured round-trip
# probe and is updated by an EWMA of observed call times, so compile
# spikes push routing toward the host automatically.
# Self-calibrating band rates: the env values are only the STARTING
# estimates; as real waves run, observed (cells, seconds) samples update
# an EWMA so the cost model reflects the actual card and host. An env
# override PINS the rate (calibration off) for reproducible tests.
_BAND_RATES = {
    # PHYSICAL band cells/s per host thread (engine scales ~linearly to 4):
    # updated only from banded-bucket calls whose cell count is the cells
    # the engine actually computed. Used to route banded buckets.
    "host": float(
        __import__("os").environ.get("FLOXER_TPU_HOST_BAND_GCELLS", "26")
    ) * 1e9,
    # EFFECTIVE chain cells/s per host thread: the fused-wave split router
    # estimates FULL-chain band cells while the host engine early-exits
    # broken chains, so this rate is workload-dependent and can run
    # hundreds of times past physical on early-exit-heavy waves. Kept
    # SEPARATE from the physical rate (advisor r4) so it can never misroute
    # banded buckets, and decayed toward the physical rate per routing
    # decision (VERDICT r4 item 8) so a stretch of early-exit waves cannot
    # permanently price the device out once composition shifts back.
    "host_effective": float(
        __import__("os").environ.get("FLOXER_TPU_HOST_BAND_GCELLS", "26")
    ) * 1e9,
    # padded band cells/s of the device banded kernel (ops/banded.py):
    # the CUDA kernel's rate at the PEX-root shape, measured with
    # floxer_tpu.tools.kernel_check on an H100 80GB HBM3 at 700 W
    "device": float(
        __import__("os").environ.get("FLOXER_TPU_DEVICE_BAND_GCELLS", "3876")
    ) * 1e9,
    "host_pinned": "FLOXER_TPU_HOST_BAND_GCELLS" in __import__("os").environ,
    "device_pinned": (
        "FLOXER_TPU_DEVICE_BAND_GCELLS" in __import__("os").environ
    ),
}


def _host_band_rate() -> float:
    return _BAND_RATES["host"]


def _host_chain_rate() -> float:
    """Effective per-thread chain rate for the fused-wave split router.

    De-hysteresis is by CONTINUOUS OBSERVATION, not decay: fully-host
    waves feed effective samples too (the callers of _try_fused_wave
    observe their fallback computes), so the EWMA tracks the live wave
    composition in both directions. An unconditional decay toward the
    physical rate was tried first (round 5) and backfired on hg38: the
    inflation IS the correct signal on early-exit-heavy workloads, and
    decaying it re-engaged the device every few waves at a measured 2x
    end-to-end loss (93-101 s vs 50 s CPU on the hg38 2k-read job)."""
    if _BAND_RATES["host_pinned"]:
        return _BAND_RATES["host"]  # env pin disables calibration dynamics
    return _BAND_RATES["host_effective"]


def _device_band_rate() -> float:
    return _BAND_RATES["device"]


def _observe_host_band_rate(
    cells: float, seconds: float, threads: int, effective: bool = False
):
    """EWMA-update a host band rate from a timed native banded call.

    effective=False (banded bucket path): `cells` are the cells the engine
    actually computed — updates the PHYSICAL rate, clamped to a physical
    range. effective=True (fused-wave host share): `cells` is the router's
    FULL-chain estimate while the engine early-exits broken chains — an
    EFFECTIVE rate that legitimately runs far past physical (measured on
    hg38-scale roots: 210 walks estimated at 57 Gcells computed in
    0.41 s), which is exactly the signal the split router needs. The
    effective EWMA blends in log space so multi-order-of-magnitude
    composition swings track symmetrically. Only clearly-broken samples
    (timer glitches) are dropped."""
    if _BAND_RATES["host_pinned"] or seconds <= 1e-4 or cells < 1e7:
        return
    sample = cells / seconds / max(threads, 1)
    if effective:
        if not (1e9 <= sample <= 1e15):
            return
        import math

        old = _BAND_RATES["host_effective"]
        _BAND_RATES["host_effective"] = math.exp(
            0.7 * math.log(old) + 0.3 * math.log(sample)
        )
    else:
        if not (1e9 <= sample <= 1e12):
            return
        _BAND_RATES["host"] = 0.7 * _BAND_RATES["host"] + 0.3 * sample


def _observe_device_band_rate(padded_cells: float, kernel_seconds: float):
    """EWMA-update the device band rate from an observed kernel execution
    (overhead already removed by the caller's estimate)."""
    if (
        _BAND_RATES["device_pinned"]
        or kernel_seconds <= 1e-4
        or padded_cells < 1e8
    ):
        return
    sample = padded_cells / kernel_seconds
    if not (1e9 <= sample <= 1e14):
        return
    _BAND_RATES["device"] = 0.7 * _BAND_RATES["device"] + 0.3 * sample
_PROBE_MIN_HOST_S = 0.01  # don't init the backend for < 10 ms of host work
# below this many useful band cells a wave always stays on the host: the
# native engine finishes a cascade that small before a dispatch returns
_FUSED_MIN_DEVICE_CELLS = float(
    __import__("os").environ.get("FLOXER_TPU_FUSED_MIN_CELLS", "4e9")
)
# a never-compiled plan is only worth its multi-second compile for waves
# of at least this many device walks
_FUSED_NEW_PLAN_MIN_WALKS = int(
    __import__("os").environ.get("FLOXER_TPU_FUSED_NEW_PLAN_WALKS", "64")
)

_DEVICE_OVERHEAD = {"rtt": None, "ewma": None}


def _device_call_overhead() -> float:
    """Estimated seconds of fixed cost per device batcher call.

    First use measures a tiny jitted round trip (warm call, so compile is
    excluded); afterwards an EWMA of observed (dispatch+download) minus the
    modeled kernel time tracks the true per-call cost, including per-shape
    retrace/compile amortization as it actually occurs in this process."""
    import os
    import time as _time

    pinned = os.environ.get("FLOXER_TPU_DEVICE_OVERHEAD_S")
    if pinned:
        return float(pinned)
    state = _DEVICE_OVERHEAD
    if state["ewma"] is not None:
        return state["ewma"]
    import jax
    import jax.numpy as jnp

    fn = jax.jit(lambda x: x + 1)
    x = jnp.zeros(8, jnp.int32)
    np.asarray(fn(x))  # trace + compile, excluded from the measurement
    t0 = _time.monotonic()
    np.asarray(fn(x))
    rtt = _time.monotonic() - t0
    state["rtt"] = rtt
    # a real batcher call moves more data and makes several transfers
    # (upload, dispatch, download); start pessimistic at 4x rtt
    state["ewma"] = max(4.0 * rtt, 0.004)
    return state["ewma"]


def _observe_device_call(observed_s: float, modeled_kernel_s: float) -> None:
    state = _DEVICE_OVERHEAD
    sample = max(observed_s - modeled_kernel_s, 0.0)
    floor = 0.25 * (state["rtt"] or 0.0)
    if state["ewma"] is None:
        state["ewma"] = max(sample, floor)
    else:
        state["ewma"] = max(0.7 * state["ewma"] + 0.3 * sample, floor)


# fixed per-dispatch cost of the FUSED wave program (ops/fused_verify.py):
# one executable, several kernels, one download. Tracked separately from
# the bucketed path — its fixed cost is a single round trip plus the
# program's internal launches.
_FUSED_OVERHEAD = {"ewma": None}


def _fused_call_overhead() -> float:
    import os

    pinned = os.environ.get("FLOXER_TPU_FUSED_OVERHEAD_S")
    if pinned:
        return float(pinned)
    if _FUSED_OVERHEAD["ewma"] is not None:
        return _FUSED_OVERHEAD["ewma"]
    return 2.0 * _device_call_overhead()


def _observe_fused_call(observed_s: float, modeled_kernel_s: float) -> None:
    sample = max(observed_s - modeled_kernel_s, 0.0)
    state = _FUSED_OVERHEAD
    if state["ewma"] is None:
        state["ewma"] = sample
    else:
        state["ewma"] = 0.7 * state["ewma"] + 0.3 * sample


@dataclass
class _WalkLevel:
    span: SpanConfig
    node: PexNode
    exists: bool = False
    # root-only results
    distance: int = -1
    begin: int = -1
    cigar: list = field(default_factory=list)
    end_col: int = -1  # DP end column (lazy-traceback input)


@dataclass
class _AnchorWalk:
    query_index: int
    orientation: Orientation
    anchor: Anchor
    chain: list[PexNode]
    root_span: SpanConfig
    levels: list[_WalkLevel] = field(default_factory=list)


@dataclass
class _QueryItem:
    query_record: object  # io.sequence_io.QueryRecord
    pex_tree: PexTree
    forward_result: SearchResult
    rc_result: SearchResult


class _WalkTable:
    """SoA walk storage: per-walk scalars in numpy arrays, walk objects
    materialized lazily via __getitem__ (only walks that actually compute
    ever need Python objects/levels). Indexing-compatible with the walks
    list the legacy path uses."""

    def __init__(
        self,
        query_index: np.ndarray,  # int64 [n]
        orientation: np.ndarray,  # uint8 [n] (0 fwd, 1 rc)
        ref_id: np.ndarray,  # int64 [n]
        position: np.ndarray,  # int64 [n]
        leaf_index: np.ndarray,  # int64 [n]
        root_start: np.ndarray,  # int64 [n]
        root_len: np.ndarray,  # int64 [n]
        extra: np.ndarray,  # int64 [n]
        chains_per_item: list,  # per item: list of chains by leaf index
    ):
        self.query_index = query_index
        self.orientation = orientation
        self.ref_id = ref_id
        self.position = position
        self.leaf_index = leaf_index
        self.root_start = root_start
        self.root_len = root_len
        self.extra = extra
        self.chains_per_item = chains_per_item
        self._objs: dict[int, _AnchorWalk] = {}

        # trimmed root intervals (trim_from_both_sides semantics: shrink by
        # extra on both ends, keep >= 1 element — intervals.cpp:48-58)
        ins_lo = root_start
        ins_hi = root_start + root_len
        he = np.where(extra > ins_hi, 0, ins_hi - extra)
        self.trim_hi = np.maximum(ins_lo + 1, he)
        self.trim_lo = np.minimum(self.trim_hi - 1, ins_lo + extra)
        self.ins_lo = ins_lo
        self.ins_hi = ins_hi

    def __len__(self) -> int:
        return self.query_index.shape[0]

    def __getitem__(self, walk_id: int) -> _AnchorWalk:
        walk = self._objs.get(walk_id)
        if walk is None:
            item_index = int(self.query_index[walk_id])
            leaf = int(self.leaf_index[walk_id])
            walk = _AnchorWalk(
                item_index,
                (
                    Orientation.FORWARD
                    if self.orientation[walk_id] == 0
                    else Orientation.REVERSE_COMPLEMENT
                ),
                Anchor(
                    pex_leaf_index=leaf,
                    reference_id=int(self.ref_id[walk_id]),
                    reference_position=int(self.position[walk_id]),
                    num_errors=0,  # unused downstream of search
                ),
                self.chains_per_item[item_index][leaf],
                SpanConfig(
                    int(self.root_start[walk_id]),
                    int(self.root_len[walk_id]),
                    int(self.extra[walk_id]),
                ),
            )
            self._objs[walk_id] = walk
        return walk


_BATCH_TIMERS = {
    "pack": 0.0, "kernel": 0.0, "numpy": 0.0, "calls": 0, "fused": 0,
}


class _TaskBatcher:
    """Collects unique (pattern, window) pairs and runs them in one padded
    batched Myers call; duplicates share one slot.

    use_device may be a bool or a zero-arg callable resolved lazily the
    first time a bucket actually qualifies for device dispatch — so tiny
    workloads (e.g. the e2e test data) never initialize an accelerator
    backend at all."""

    def __init__(self, use_device, resident=None):
        self.use_device = use_device
        # resident: (ref_bank, query_bank) ResidentBank pair enabling the
        # on-device gather path (ops/resident.py) — per-task slice copies
        # are replaced by offsets into device-resident packed banks
        self.resident = resident
        self._device_resolved: bool | None = None
        self.keys: dict = {}
        self.patterns: list[np.ndarray] = []
        self.windows: list[np.ndarray] = []
        self.owners: list[list[int]] = []
        self.budgets: list[int] = []
        self.pat_addrs: list[int] = []
        self.win_addrs: list[int] = []

    def add(
        self,
        key,
        pattern: np.ndarray,
        window: np.ndarray,
        owner: int,
        budget: int = -1,
        pat_addr: int = -1,
        win_addr: int = -1,
    ):
        slot = self.keys.get(key)
        if slot is None:
            slot = len(self.patterns)
            self.keys[key] = slot
            self.patterns.append(pattern)
            self.windows.append(window)
            self.budgets.append(budget)
            self.pat_addrs.append(pat_addr)
            self.win_addrs.append(win_addr)
            self.owners.append([])
        self.owners[slot].append(owner)
        return slot

    def _device(self) -> bool:
        if self._device_resolved is None:
            self._device_resolved = (
                self.use_device()
                if callable(self.use_device)
                else bool(self.use_device)
            )
        return self._device_resolved

    def _try_resident(self, tag, m_bucket, n_bucket, slots, b_bucket):
        """Dispatch one device bucket through the resident-gather path
        (ops/resident.py): offsets into device-resident banks instead of
        per-task host slice uploads. Returns (dist, end) device arrays of
        length >= b_bucket, or None when the path does not apply (no banks,
        or a slot without addresses, e.g. the reversed root batch)."""
        if self.resident is None:
            return None
        if any(
            self.pat_addrs[i] < 0 or self.win_addrs[i] < 0 for i in slots
        ):
            return None
        from .ops.resident import myers_banded_resident, myers_full_resident

        ref_bank, query_bank = self.resident
        if tag == "banded":
            from .ops.banded import GROUP as group
        else:
            from .ops.myers import FULL_GROUP as group
        T = max(b_bucket, group)
        T = -(-T // group) * group

        win_starts = np.zeros(T, dtype=np.int64)
        win_lens = np.ones(T, dtype=np.int64)
        pat_starts = np.zeros(T, dtype=np.int64)
        pat_lens = np.ones(T, dtype=np.int64)
        for row, i in enumerate(slots):
            win_starts[row] = self.win_addrs[i]
            win_lens[row] = len(self.windows[i])
            pat_starts[row] = self.pat_addrs[i]
            pat_lens[row] = len(self.patterns[i])

        from .warm_shapes import record_shape

        if tag == "banded":
            # pad rows: m=2, budget=1 satisfies 0 < budget < m
            pat_lens[len(slots):] = 2
            budgets = np.ones(T, dtype=np.int64)
            budgets[: len(slots)] = [self.budgets[i] for i in slots]
            record_shape((
                "banded_resident", m_bucket, n_bucket, T,
                int(ref_bank.flat.shape[0]), int(query_bank.flat.shape[0]),
            ))
            return myers_banded_resident(
                ref_bank, query_bank,
                win_starts, win_lens, pat_starts, pat_lens, budgets,
                band_words=m_bucket, num_text=n_bucket, sync=False,
            )
        record_shape((
            "full_resident", m_bucket, n_bucket, T,
            int(ref_bank.flat.shape[0]), int(query_bank.flat.shape[0]),
        ))
        return myers_full_resident(
            ref_bank, query_bank,
            win_starts, win_lens, pat_starts, pat_lens,
            m_bucket=m_bucket, num_text=n_bucket, sync=False,
        )

    def run(self) -> tuple[np.ndarray, np.ndarray]:
        """Returns (distances, end_cols) per unique slot.

        Slots are grouped into power-of-two (pattern, window) shape buckets
        so the jitted kernels see a bounded set of shapes; tiny buckets
        where jit dispatch would dominate use the numpy DP instead."""
        count = len(self.patterns)
        distances = np.zeros(count, dtype=np.int64)
        ends = np.zeros(count, dtype=np.int64)
        if count == 0:
            return distances, ends

        def bucket_at_least(x, floor):
            # tiered geometric buckets aligned to 128: coarse steps for the
            # cheap mid sizes (fewer compiled kernel shapes per process),
            # tight steps at root scale where cells dominate
            size = floor
            while size < x:
                if size <= 1536:
                    grown = size * 5 // 4 + 1
                elif size <= 16384:
                    grown = size * 8 // 5 + 1
                else:
                    grown = size * 23 // 20 + 1
                size = -(-grown // 128) * 128
            return size

        def banded_words_for(i):
            """Band tile count (in 128-word units) when the banded kernel
            applies to slot i, else None. Banded is exact whenever
            downstream reads the result (ops/myers_banded.py); it wins when
            its band state is strictly narrower than the full pattern
            state at tile granularity (PEX roots, large inner nodes)."""
            budget = self.budgets[i]
            m = len(self.patterns[i])
            n = len(self.windows[i])
            if budget <= 0 or budget >= m:
                return None
            if n < m - budget:  # too truncated to ever accept: full kernel
                return None
            band_tiles = -(-(n - m + 2 * budget + 1) // (128 * 32))
            full_tiles = -(-(-(-m // 32)) // 128)
            if band_tiles < full_tiles or _FORCE_BANDED:
                return band_tiles * 128
            return None

        def window_bucket(n):
            # with the resident gather path the per-task window transfer is
            # offsets-only and the kernels' dynamic column bounds make the
            # n padding compute-free, so quantize coarsely (power of two):
            # far fewer compiled shapes per process
            if self.resident is not None:
                size = 256
                while size < n:
                    size *= 2
                return size
            return bucket_at_least(n, 256)

        buckets: dict[tuple, list[int]] = {}
        for i, (pattern, window) in enumerate(zip(self.patterns, self.windows)):
            bw = banded_words_for(i)
            if bw is not None:
                key = ("banded", bw, window_bucket(len(window)))
            else:
                key = (
                    "full",
                    bucket_at_least(len(pattern), 128),
                    window_bucket(len(window)),
                )
            buckets.setdefault(key, []).append(i)

        # merge all small full-kernel buckets into one: a dispatch costs
        # more than the padding waste at these sizes (tasks <= ~1.5k x 1.5k)
        SMALL = 1536
        small_keys = [
            key
            for key in buckets
            if key[0] == "full" and key[1] <= SMALL and key[2] <= SMALL
        ]
        if len(small_keys) > 1:
            merged_key = (
                "full",
                max(key[1] for key in small_keys),
                max(key[2] for key in small_keys),
            )
            merged_slots: list[int] = []
            for key in small_keys:
                merged_slots.extend(buckets.pop(key))
            buckets[merged_key] = (
                buckets.get(merged_key, []) + merged_slots
            )

        # sort slots by window length so a batch's tasks are homogeneous
        # (the plain-XLA kernels stop at the batch's longest window).
        # Result placement is order-independent (distances[slots]
        # scatters).
        for slots in buckets.values():
            slots.sort(key=lambda i: len(self.windows[i]), reverse=True)

        import logging as _logging
        import time as _time

        from .ops.device_dp import pad_batch

        # device buckets are SUBMITTED first (sync=False keeps results on
        # device) and downloaded after the last dispatch, so the remote
        # backend pipelines the transfers/launches instead of paying one
        # full round trip per bucket
        pending = []  # (slots, b_bucket, m_bucket, n_bucket, dist, end, t)
        for (tag, m_bucket, n_bucket), slots in buckets.items():
            # route on USEFUL cells — the native host engine computes only
            # those, so padding waste must not push a bucket onto the device
            cells = sum(
                len(self.patterns[i]) * len(self.windows[i]) for i in slots
            )
            modeled_kernel_s = 0.0
            if tag == "banded":
                # time-model routing (see _device_call_overhead): both
                # engines compute the same band, so compare estimated wall
                # time. Host computes useful band cells on min(4, slots)
                # threads; device computes the padded band and pays a
                # per-call overhead that adapts to the attachment latency.
                band_cells = 0
                for i in slots:
                    m = len(self.patterns[i])
                    n = len(self.windows[i])
                    rows = min(n - m + 2 * self.budgets[i] + 1, m)
                    band_cells += max(rows, 1) * n
                host_s = band_cells / (
                    _host_band_rate() * min(4, len(slots))
                )
                if self.use_device is True:
                    # --engine device / direct construction: hard override,
                    # the caller wants the device path exercised
                    on_device = self._device()
                elif host_s <= _PROBE_MIN_HOST_S or not self._device():
                    on_device = False
                else:
                    b_pad = 1
                    while b_pad < len(slots):
                        b_pad *= 2
                    modeled_kernel_s = (
                        m_bucket * 32 * n_bucket * b_pad
                    ) / _device_band_rate()
                    device_s = _device_call_overhead() + modeled_kernel_s
                    on_device = device_s < host_s
                    _logging.getLogger("floxer-tpu").debug(
                        "banded route: %d slots band=%.0fMcells host %.0fms"
                        " device %.0fms (overhead %.0fms) -> %s",
                        len(slots), band_cells / 1e6, host_s * 1e3,
                        device_s * 1e3,
                        _device_call_overhead() * 1e3,
                        "device" if on_device else "host",
                    )
            else:
                size_qualifies = cells > MIN_DEVICE_CELLS
                on_device = size_qualifies and self._device()
            if not on_device:
                t0 = _time.monotonic()
                from .native import native_myers_distance_batch

                native = native_myers_distance_batch(
                    [self.windows[i] for i in slots],
                    [self.patterns[i] for i in slots],
                    num_threads=min(4, len(slots)),
                    budgets=[self.budgets[i] for i in slots],
                )
                if native is not None:
                    dist_arr, end_arr = native
                    distances[slots] = dist_arr
                    ends[slots] = end_arr
                    if tag == "banded":
                        _observe_host_band_rate(
                            band_cells,
                            _time.monotonic() - t0,
                            min(4, len(slots)),
                        )
                else:
                    for i in slots:
                        dp = dp_reference.semi_global_dp_matrix(
                            self.windows[i], self.patterns[i]
                        )
                        last = dp[-1]
                        end = dp_reference._rightmost_argmin(last)
                        distances[i] = last[end]
                        ends[i] = end
                _BATCH_TIMERS["numpy"] += _time.monotonic() - t0
                continue
            # pad the batch dimension to a power of two as well, so the
            # jitted kernel sees a bounded set of (B, M, N) shapes — a fresh
            # compile per wave would dominate. Min 1: big single-task
            # buckets (roots) must not pay 8x padding.
            t0 = _time.monotonic()
            b_bucket = 1
            while b_bucket < len(slots):
                b_bucket *= 2
            resident_result = self._try_resident(
                tag, m_bucket, n_bucket, slots, b_bucket
            )
            if resident_result is not None:
                t1 = _time.monotonic()
                _BATCH_TIMERS["pack"] += t1 - t0
                _BATCH_TIMERS["calls"] += 1
                pending.append(
                    (slots, b_bucket, m_bucket, n_bucket,
                     resident_result[0], resident_result[1], t1 - t0,
                     modeled_kernel_s)
                )
                continue
            dummy = np.zeros(1, dtype=np.uint8)
            batch_patterns = [self.patterns[i] for i in slots]
            batch_windows = [self.windows[i] for i in slots]
            while len(batch_patterns) < b_bucket:
                batch_patterns.append(dummy)
                batch_windows.append(dummy)
            from .warm_shapes import record_shape

            if tag == "banded":
                from .ops.banded import myers_banded_device

                record_shape(("banded_host", m_bucket, n_bucket, b_bucket))
                txt, tlen = pad_batch(batch_windows, pad_to=n_bucket)
                budgets = np.ones(b_bucket, dtype=np.int64)
                budgets[: len(slots)] = [self.budgets[i] for i in slots]
                # pad rows: m=2, budget=1, n=1 satisfies 0 < budget < m
                batch_patterns = batch_patterns[: len(slots)] + [
                    np.zeros(2, dtype=np.uint8)
                ] * (b_bucket - len(slots))
                t1 = _time.monotonic()
                bucket_distances, bucket_ends = myers_banded_device(
                    batch_patterns,
                    txt,
                    tlen,
                    budgets,
                    band_words=m_bucket,
                    sync=False,
                )
                t2 = _time.monotonic()
            else:
                record_shape(("full_host", m_bucket, n_bucket, b_bucket))
                pat, plen = pad_batch(batch_patterns, pad_to=m_bucket)
                txt, tlen = pad_batch(batch_windows, pad_to=n_bucket)
                t1 = _time.monotonic()
                bucket_distances, bucket_ends = myers_distance(
                    pat, plen, txt, tlen
                )
                t2 = _time.monotonic()
            _BATCH_TIMERS["pack"] += t1 - t0
            _BATCH_TIMERS["calls"] += 1
            pending.append(
                (slots, b_bucket, m_bucket, n_bucket,
                 bucket_distances, bucket_ends, t2 - t1, modeled_kernel_s)
            )

        log = _logging.getLogger("floxer-tpu")
        # start all device->host copies before waiting on any, so the
        # downloads overlap instead of paying one round trip each
        for *_rest, dist, end, _t, _mk in pending:
            for arr in (dist, end):
                copy_async = getattr(arr, "copy_to_host_async", None)
                if copy_async is not None:
                    try:
                        copy_async()
                    except Exception:  # noqa: BLE001 - best-effort prefetch
                        pass
        for (
            slots, b_bucket, m_bucket, n_bucket, dist, end, t_disp, mk_s
        ) in pending:
            t1 = _time.monotonic()
            distances[slots] = np.asarray(dist)[: len(slots)]
            ends[slots] = np.asarray(end)[: len(slots)]
            t2 = _time.monotonic()
            _BATCH_TIMERS["kernel"] += t2 - t1
            if mk_s:
                _observe_device_call(t_disp + (t2 - t1), mk_s)
            useful = sum(
                len(self.patterns[i]) * len(self.windows[i]) for i in slots
            )
            padded = b_bucket * m_bucket * n_bucket
            log.debug(
                "batcher call: %d slots (pad %d) m=%d n=%d -> disp %.2fs "
                "wait %.2fs useful=%.2fMcells padded=%.2fMcells fill=%.1f%% "
                "%.1fGCUPS",
                len(slots), b_bucket, m_bucket, n_bucket, t_disp, t2 - t1,
                useful / 1e6, padded / 1e6, 100.0 * useful / padded,
                padded / max(t2 - t1, 1e-9) / 1e9,
            )

        return distances, ends


class _DeviceTb:
    """Placeholder for one device-batched traceback task: future-compatible
    (`.result()`) once resolve_deferred() fills `value` from the batch."""

    __slots__ = ("index", "value")

    def __init__(self, index: int):
        self.index = index
        self.value = None

    def result(self):
        assert self.value is not None, "resolve_deferred not called"
        return self.value


class VerificationTimeout(Exception):
    """Raised between waves when the caller's deadline has passed — the
    wave-shaped analogue of the reference's per-task `threads_should_stop`
    checks (parallelization.cpp:66, 203): a long chunk aborts at the next
    wave boundary instead of running minutes past --timeout."""


class BatchVerifier:
    def __init__(
        self,
        references,
        kind: VerificationKind,
        extra_verification_ratio: float,
        without_cigar: bool,
        use_interval_optimization: bool,
        use_device: bool = True,
        resident_ref=None,
        defer_finalize: bool = False,
        deadline_check=None,
    ):
        self.references = references
        # defer_finalize=True: process() may return alignments whose root
        # begin/CIGAR are still being computed on the traceback pool; the
        # caller must call resolve_deferred() before consuming them (the
        # pipeline overlaps that wait with the next chunk's verification)
        self.defer_finalize = defer_finalize
        # optional zero-arg callable; True => abort at the next wave
        # boundary by raising VerificationTimeout
        self.deadline_check = deadline_check
        self.kind = kind
        self.extra_verification_ratio = extra_verification_ratio
        self.without_cigar = without_cigar
        self.use_interval_optimization = use_interval_optimization
        self.use_device = use_device
        # per-run device-resident reference bank (ops/resident.py); the
        # per-chunk query bank is built in process()
        self.resident_ref = None if _NO_RESIDENT else resident_ref
        self._resident = None
        # deferred root tracebacks: futures submitted during the wave loop;
        # resolve_deferred() (cheap, callable from a later pipeline stage)
        # patches begin/cigar into the affected levels and alignment records
        self._deferred: list = []  # (future-or-_DeviceTb, level)
        self._patches: list = []  # (QueryAlignment, level)
        # device-traceback accumulation: recorded-root tasks queued during
        # the record pass, dispatched as batched direction-bitmap kernels in
        # resolve_deferred() (ops/traceback_device.py)
        self._device_tb_tasks: list = []
        self._device_tb_enabled: bool | None = None

    # ------------------------------------------------------------------

    def _chain_for(self, tree: PexTree, leaf: PexNode) -> list[PexNode]:
        """Nodes visited by the hierarchical walk (leaf's parent ... root),
        or [leaf] when the tree is a single root, or [root] for direct_full."""
        if self.kind == VerificationKind.DIRECT_FULL:
            return [tree.root]
        if leaf.is_root:
            return [leaf]
        chain = []
        node = tree.parent_of(leaf)
        while True:
            chain.append(node)
            if node.is_root:
                return chain
            node = tree.parent_of(node)

    def _chains_for_tree(self, tree: PexTree):
        """Per-leaf walk chains as a lazy ChainTable, memoized on the tree
        (trees are shared across same-length queries via cached_pex_tree;
        only walks that actually compute ever materialize node objects)."""
        from .pex import ChainTable

        cache = getattr(tree, "_chain_cache", None)
        if cache is None:
            cache = tree._chain_cache = {}
        chains = cache.get(self.kind)
        if chains is None:
            chains = ChainTable(
                tree, self.kind == VerificationKind.DIRECT_FULL
            )
            cache[self.kind] = chains
        return chains

    @staticmethod
    def _leaf_offsets_for_tree(tree: PexTree, extra: int) -> np.ndarray:
        """leaf anchor -> root-span start offset per leaf, memoized on the
        tree (pure function of the tree shape and the extra margin)."""
        cache = getattr(tree, "_leaf_offset_cache", None)
        if cache is None:
            cache = tree._leaf_offset_cache = {}
        offsets = cache.get(extra)
        if offsets is None:
            root_row = (
                tree.inner_arr[0] if tree.num_inner_nodes else tree.leaf_arr[0]
            )
            offsets = (
                tree.leaf_arr[:, 1] - int(root_row[1]) + int(root_row[3]) + extra
            )
            cache[extra] = offsets
        return offsets

    def process(self, items: list[_QueryItem]) -> list[QueryAlignments]:
        """Wave loop: an optimistic cache simulation picks the anchors the
        sequential reference would actually verify (everything else is
        interval-cache-skipped, verification.cpp:119-136), only those walks
        run on device, and the loop repeats for anchors whose skip turned
        out wrong (an assumed root insertion didn't happen because an inner
        level failed). The final bookkeeping pass is the authoritative exact
        replay — output is byte-identical to the sequential verifier, but
        with --interval-optimization the device computes ~one walk per
        distinct locus instead of one per anchor.

        Two implementations: the SoA path keeps all per-walk scalars in
        numpy arrays, runs the cache simulation natively (cachescan.cpp),
        and materializes walk objects only for the few walks that actually
        compute; the legacy object path remains as the semantics oracle and
        the fallback without the native library."""
        import os

        from .native import get_library

        self._soa_active = get_library() is not None and not os.environ.get(
            "FLOXER_TPU_LEGACY_VERIFY"
        )
        if self._soa_active:
            result = self._process_soa(items)
        else:
            result = self._process_legacy(items)
        if not self.defer_finalize:
            self.resolve_deferred()
        return result

    def _setup_chunk_state(self, items: list[_QueryItem]) -> None:
        self._task_cache = {}
        self._root_memo = {}
        if self.resident_ref is not None:
            from .ops.resident import ResidentBank

            # chunk query bank: forward and reverse-complement rank
            # sequences of every read, addressed 2*query_index + strand
            seqs = []
            for item in items:
                seqs.append(item.query_record.rank_sequence)
                seqs.append(
                    item.query_record.reverse_complement_rank_sequence
                )
            self._resident = (self.resident_ref, ResidentBank(seqs))

    def _build_walk_table(self, items: list[_QueryItem]) -> _WalkTable:
        from .utils.mathutils import float_aware_ceil

        ref_lengths = np.array(
            [len(r.rank_sequence) for r in self.references], dtype=np.int64
        )
        cols: dict[str, list] = {
            k: []
            for k in ("qi", "ori", "ref", "pos", "leaf", "start", "len", "ex")
        }
        chains_per_item = []
        for query_index, item in enumerate(items):
            root = item.pex_tree.root
            base_length = (
                root.length_of_query_span + 2 * root.num_errors + 1
            )
            extra = float_aware_ceil(
                base_length * self.extra_verification_ratio
            )
            full_length = base_length + 2 * extra
            chains_per_item.append(self._chains_for_tree(item.pex_tree))
            leaf_offsets = self._leaf_offsets_for_tree(item.pex_tree, extra)
            for ori_code, result in (
                (0, item.forward_result),
                (1, item.rc_result),
            ):
                leaf_arr, ref_arr, pos_arr = result.flat_arrays()
                count = leaf_arr.shape[0]
                if not count:
                    continue
                starts = pos_arr - leaf_offsets[leaf_arr]
                np.maximum(starts, 0, out=starts)
                lens = np.minimum(full_length, ref_lengths[ref_arr] - starts)
                cols["qi"].append(np.full(count, query_index, np.int64))
                cols["ori"].append(np.full(count, ori_code, np.uint8))
                cols["ref"].append(ref_arr.astype(np.int64, copy=False))
                cols["pos"].append(pos_arr.astype(np.int64, copy=False))
                cols["leaf"].append(leaf_arr.astype(np.int64, copy=False))
                cols["start"].append(starts)
                cols["len"].append(lens)
                cols["ex"].append(np.full(count, extra, np.int64))

        def cat(name, dtype):
            parts = cols[name]
            if not parts:
                return np.zeros(0, dtype=dtype)
            return np.concatenate(parts)

        return _WalkTable(
            cat("qi", np.int64),
            cat("ori", np.uint8),
            cat("ref", np.int64),
            cat("pos", np.int64),
            cat("leaf", np.int64),
            cat("start", np.int64),
            cat("len", np.int64),
            cat("ex", np.int64),
            chains_per_item,
        )

    def _walk_is_broken(self, walk: _AnchorWalk, depth=None) -> bool:
        """A pre-root level failed (its optimistic root insertion never
        happened in the sequential replay)."""
        levels = walk.levels if depth is None else walk.levels[:depth]
        for level in levels:
            if level.node.is_root:
                return False
            if not level.exists:
                return True
        return False

    def _process_soa(self, items: list[_QueryItem]) -> list[QueryAlignments]:
        import logging
        import os
        import time as _time

        from .native import native_cache_scan

        log = logging.getLogger("floxer-tpu")
        t0 = _time.monotonic()
        self._setup_chunk_state(items)
        table = self._build_walk_table(items)
        n = len(table)
        alignments = [QueryAlignments(len(self.references)) for _ in items]
        self.last_stats_events = []
        self.last_avoided_lengths = np.zeros(0, dtype=np.int64)
        if n == 0:
            return alignments

        enabled = self.use_interval_optimization
        num_refs = len(self.references)
        kcode = (
            table.query_index * 2 + table.orientation
        ) * num_refs + table.ref_id
        order = np.argsort(kcode, kind="stable").astype(np.int64)
        sorted_codes = kcode[order]
        boundary = np.empty(n, dtype=bool)
        boundary[0] = True
        np.not_equal(sorted_codes[1:], sorted_codes[:-1], out=boundary[1:])
        key_begin = np.nonzero(boundary)[0].astype(np.int64)
        key_end = np.append(key_begin[1:], n).astype(np.int64)
        num_keys = key_begin.shape[0]
        key_of_sorted = np.cumsum(boundary) - 1
        key_of_walk = np.empty(n, dtype=np.int64)
        key_of_walk[order] = key_of_sorted

        state = np.zeros(n, dtype=np.uint8)
        sim_flag = np.full(n, 2, dtype=np.uint8)
        dirty = np.ones(num_keys, dtype=bool)
        t_build = _time.monotonic()

        waves = 0
        need_total = 0
        CHECK_DEPTH = 3
        t_sim = 0.0
        t_flat = 0.0

        # targeted cascade speculation: when a walk breaks, the walks its
        # optimistic root insertion was covering become needed — and they
        # are the next uncomputed walks of the same segment in scan order.
        # Pre-computing the next CHAIN_K of them per break advances a
        # dependency chain of depth D in ~D/CHAIN_K waves instead of D
        # (each wave costs device round trips; chr21 repetitive loci showed
        # chains 35-50 deep). Bulk-speculating ALL at-risk walks instead
        # was measured slower — the at-risk pool is ~100x the true chain.
        inv_order = np.empty(n, dtype=np.int64)
        inv_order[order] = np.arange(n, dtype=np.int64)
        CHAIN_K = int(os.environ.get("FLOXER_TPU_CHAIN_K", "8"))
        # fused waves resolve walks at full depth in ONE dispatch and a
        # broken walk's masked deep levels cost ~nothing, so chains can be
        # speculated much deeper — each avoided wave is an avoided round
        # trip
        CHAIN_K_FUSED = int(os.environ.get("FLOXER_TPU_CHAIN_K_FUSED", "32"))
        chain_k = [CHAIN_K]
        self._fused_dispatches = 0
        spec_pending: list[int] = []

        def classify_prescreened(wid: int) -> bool:
            """Apply the 3-level prescreen outcome to one walk: pending-ok
            (all checked levels exist), broken (state 3 + cascade), or
            computed-complete. Returns True when the walk failed."""
            walk = table[wid]
            if all(
                level.exists for level in walk.levels[:CHECK_DEPTH]
            ):
                state[wid] = 1  # pending-ok
                return False
            if self._walk_is_broken(walk, depth=CHECK_DEPTH):
                state[wid] = 3
                dirty[key_of_walk[wid]] = True
                chain_victims(wid)
            else:
                state[wid] = 2
            return True

        def chain_victims(wid: int) -> None:
            key = int(key_of_walk[wid])
            p = int(inv_order[wid]) + 1
            end = int(key_end[key])
            found = 0
            while p < end and found < chain_k[0]:
                w2 = int(order[p])
                # only at-risk walks (flag 4: avoided, but every covering
                # interval is still optimistic) can become needed when a
                # coverer breaks; confidently-avoided walks (flag 0) never
                # do — speculating them computed ~15x the sequential
                # truth's root alignments at reference-evaluation scale
                if state[w2] == 0 and sim_flag[w2] == 4:
                    spec_pending.append(w2)
                    found += 1
                p += 1

        while True:
            while True:
                t0_sim = _time.monotonic()
                if dirty.any():
                    segs = np.nonzero(dirty)[0]
                    scan = native_cache_scan(
                        key_begin[segs], key_end[segs], order,
                        table.trim_lo, table.trim_hi,
                        table.ins_lo, table.ins_hi, state, enabled,
                    )
                    assert scan is not None
                    _, flags = scan
                    scanned = flags != 255
                    sim_flag[scanned] = flags[scanned]
                    dirty[:] = False
                need_ids = np.nonzero((sim_flag == 1) & (state == 0))[0]
                t_sim += _time.monotonic() - t0_sim
                if need_ids.size == 0:
                    break
                waves += 1
                if self.deadline_check is not None and self.deadline_check():
                    raise VerificationTimeout()
                need_total += need_ids.size
                need_list = [int(w) for w in need_ids]
                # small re-verify cascades (walks whose cache-skip turned
                # out wrong) are computed at FULL depth right away: each
                # extra wave costs device round trips, which outweigh the
                # cells saved by 3-level prescreening at this size
                full = need_ids.size <= 64
                spec = []
                if spec_pending:
                    need_set = set(need_list)
                    spec = [w for w in dict.fromkeys(spec_pending)
                            if state[w] == 0 and w not in need_set]
                    spec_pending.clear()
                    need_total += len(spec)
                t0_flat = _time.monotonic()
                # one-dispatch fused wave: need walks at FULL depth +
                # speculation at prescreen depth, together in ONE device
                # dispatch. Need walks resolve terminally (no pending
                # state), so chains advance a full CHAIN_K per round trip.
                fused_done = self._try_fused_wave(
                    table, items, need_list,
                    spec=spec, spec_depth=CHECK_DEPTH,
                )
                any_failed = False
                if fused_done:
                    if self.use_device is True or _FORCE_FUSED:
                        # forced all-device: every cascade wave is one
                        # dispatch, so deep speculation is nearly free.
                        # Cost-model runs keep the host default — their
                        # cascades route to the native engine, where bulk
                        # speculation measured slower (round 2).
                        chain_k[0] = CHAIN_K_FUSED
                    t_flat += _time.monotonic() - t0_flat
                    passed_fused: set[int] = set()
                    for wid in spec:
                        key = int(key_of_walk[wid])
                        if key in passed_fused:
                            continue  # next sim decides
                        if classify_prescreened(wid):
                            any_failed = True
                        elif state[wid] == 1:
                            passed_fused.add(key)
                    for wid in need_list:
                        if self._walk_is_broken(table[wid]):
                            state[wid] = 3
                            dirty[key_of_walk[wid]] = True
                            any_failed = True
                            chain_victims(wid)
                        else:
                            state[wid] = 2
                    if not any_failed:
                        break
                    continue
                t0_host = _time.monotonic()
                self._compute_walks_flat(
                    table, items, need_list,
                    max_depth=None if full else CHECK_DEPTH,
                )
                if full:
                    # full-depth fallback: comparable to the split path's
                    # host share, so its timing is an effective-rate
                    # sample (depth-limited prescreens are not)
                    self._observe_host_wave(_time.monotonic() - t0_host)
                if spec:
                    # speculation runs at prescreen depth only: a breaking
                    # walk (the chr21 repetitive-locus cascade) is detected
                    # in its first levels, while a passing walk means its
                    # root insertion will cover the rest of the chain — so
                    # computing past it (let alone its root) is the 15x
                    # overcompute the sequential stats exposed
                    self._compute_walks_flat(
                        table, items, spec, max_depth=CHECK_DEPTH
                    )
                t_flat += _time.monotonic() - t0_flat
                passed_segments: set[int] = set()
                for wid in spec:
                    key = int(key_of_walk[wid])
                    if key in passed_segments:
                        continue  # stays uncomputed; the next sim decides
                    if classify_prescreened(wid):
                        any_failed = True
                    elif state[wid] == 1:
                        passed_segments.add(key)
                for wid in need_list:
                    walk = table[wid]
                    if full:
                        if self._walk_is_broken(walk):
                            state[wid] = 3
                            dirty[key_of_walk[wid]] = True
                            any_failed = True
                            chain_victims(wid)
                        else:
                            state[wid] = 2
                        continue
                    if classify_prescreened(wid):
                        any_failed = True
                if not any_failed:
                    break
            pending_ids = np.nonzero(state == 1)[0]
            if pending_ids.size == 0:
                break
            # settle which pendings the sequential replay actually
            # verifies: a pending covered by an earlier interval never
            # computes its deep levels (its prescreen result is enough for
            # the final scan, which treats state 1 as insert-if-uncovered).
            # A flag-4 pending is covered only by another pending's
            # optimistic insertion — its (flag-2) coverer computes this
            # round and either confirms the cover or breaks and dirties
            # the segment, so skipping it here always makes progress.
            t0_sim = _time.monotonic()
            scan = native_cache_scan(
                key_begin, key_end, order,
                table.trim_lo, table.trim_hi,
                table.ins_lo, table.ins_hi, state, enabled,
            )
            assert scan is not None
            _, pflags = scan
            scanned = pflags != 255
            sim_flag[scanned] = pflags[scanned]
            t_sim += _time.monotonic() - t0_sim
            batch_list = [
                int(w) for w in pending_ids if pflags[w] not in (0, 4)
            ]
            if not batch_list:
                break
            t0_flat = _time.monotonic()
            if not self._try_fused_wave(table, items, batch_list):
                t0_host = _time.monotonic()
                self._compute_walks_flat(table, items, batch_list)
                self._observe_host_wave(_time.monotonic() - t0_host)
            t_flat += _time.monotonic() - t0_flat
            for wid in batch_list:
                if self._walk_is_broken(table[wid]):
                    state[wid] = 3
                    dirty[key_of_walk[wid]] = True
                    chain_victims(wid)
                else:
                    state[wid] = 2
        t_waves = _time.monotonic()

        # final authoritative replay: the native scan settles which walks
        # the sequential verifier would have cache-skipped; only computed
        # walks are replayed in Python (stats events + alignment records)
        scan = native_cache_scan(
            key_begin, key_end, order,
            table.trim_lo, table.trim_hi,
            table.ins_lo, table.ins_hi, state, enabled,
        )
        assert scan is not None
        leftover, flags = scan
        assert not leftover, "uncomputed walks survived the wave loop"
        avoided = flags == 0
        self.last_avoided_lengths = table.root_len[avoided]
        stats_events = []
        for wid in np.nonzero(~avoided)[0]:
            walk = table[int(wid)]
            for level in walk.levels:
                if level.node.is_root:
                    stats_events.append(("aligned_root", level.span.length))
                    if level.exists:
                        if level.begin is None and not self.without_cigar:
                            # lazy traceback: only recorded walks get one
                            self._submit_traceback(walk, level, items)
                        pending = level.begin is None
                        alignment = QueryAlignment(
                            start_in_reference=level.begin,
                            num_errors=level.distance,
                            orientation=walk.orientation,
                            cigar=(
                                None if pending else _cigar_value(level.cigar)
                            ),
                        )
                        if pending:
                            # traceback still in flight (deferred); filled
                            # in by resolve_deferred()
                            self._patches.append((alignment, level))
                        alignments[walk.query_index].insert(
                            alignment,
                            walk.anchor.reference_id,
                        )
                    break
                stats_events.append(("aligned_inner", level.span.length))
                if not level.exists:
                    break
        self.last_stats_events = stats_events
        log.debug(
            "verify batch (soa): %d walks, %d waves (%d walks computed, "
            "%d walks replayed, %d fused dispatches); build %.2fs waves "
            "%.2fs (sim %.2fs flat %.2fs) record %.2fs",
            n,
            waves,
            need_total,
            int(np.count_nonzero(~avoided)),
            self._fused_dispatches,
            t_build - t0,
            t_waves - t_build,
            t_sim,
            t_flat,
            _time.monotonic() - t_waves,
        )
        return alignments

    def _process_legacy(self, items: list[_QueryItem]) -> list[QueryAlignments]:
        import logging
        import time as _time

        log = logging.getLogger("floxer-tpu")
        t0 = _time.monotonic()

        walks = self._build_walks(items)
        computed: set[int] = set()
        self._task_cache: dict = {}
        self._root_memo: dict = {}
        if self.resident_ref is not None:
            from .ops.resident import ResidentBank

            # chunk query bank: forward and reverse-complement rank
            # sequences of every read, addressed 2*query_index + strand.
            # Layout is eager (cheap); the packed upload happens lazily on
            # the first resident bucket dispatch.
            seqs = []
            for item in items:
                seqs.append(item.query_record.rank_sequence)
                seqs.append(
                    item.query_record.reverse_complement_rank_sequence
                )
            self._resident = (self.resident_ref, ResidentBank(seqs))
        t_build = _time.monotonic()

        # prescreen: cheap batched passes over every walk's first few levels
        # (the smallest spans) resolve junk anchors immediately — their
        # walks can never reach the root, so the wave loop's optimistic
        # cache simulation won't wrongly shadow other anchors behind them
        # and trigger repair waves
        # depth 0 disables the prescreen: with flat single-dispatch waves,
        # letting the wave loop resolve mis-predicted walks is cheaper than
        # prescreening the (mostly cache-skipped) full anchor set
        prescreen_depth = int(
            __import__("os").environ.get("FLOXER_TPU_PRESCREEN_DEPTH", "0")
        )
        if prescreen_depth > 0:
            all_ids = list(range(len(walks)))
            self._compute_walks(
                walks, items, all_ids, max_depth=prescreen_depth
            )
            for walk_id in all_ids:
                walk = walks[walk_id]
                prescreened = walk.levels[:prescreen_depth]
                if prescreened and not all(
                    level.exists for level in prescreened
                ):
                    computed.add(walk_id)
        t_prescreen = _time.monotonic()

        waves = 0
        need_total = 0
        CHECK_DEPTH = 3

        # the optimistic cache simulation is exact per (query, orientation,
        # reference) — interval caches never cross those keys — so only
        # keys whose predictions turned out wrong need re-simulation.
        # A failed optimistic root insertion can only UNCOVER other walks
        # (more need, never less), so survivors of the cheap check are
        # always safe to compute in the same wave.
        walks_by_key: dict = {}
        for walk_id, walk in enumerate(walks):
            key = (walk.query_index, walk.orientation, walk.anchor.reference_id)
            walks_by_key.setdefault(key, []).append(walk_id)
        need_by_key = {}
        dirty = set(walks_by_key)
        t_sim = 0.0  # host time inside the cache simulation
        t_flat = 0.0  # host+device time inside _compute_walks_flat

        def key_of(walk_id):
            walk = walks[walk_id]
            return (walk.query_index, walk.orientation, walk.anchor.reference_id)

        def mark_broken(batch):
            """Keys whose walks failed before reaching the root: their
            optimistic root insertion never happened, so re-simulate."""
            for walk_id in batch:
                for level in walks[walk_id].levels:
                    if level.node.is_root:
                        break
                    if not level.exists:
                        dirty.add(key_of(walk_id))
                        break

        # checked-OK walks whose full-size levels haven't run yet; the
        # simulation treats them exactly like its optimistic assumption
        pending_ok: set[int] = set()
        while True:
            # inner: stabilize junk anchors on the cheap first levels only
            # (small batches, fast dispatches) before any full-size work
            while True:
                t0_sim = _time.monotonic()
                for key in dirty:
                    need_by_key[key] = self._simulate_key(
                        walks, walks_by_key[key], computed, pending_ok
                    )
                dirty.clear()
                need = sorted(
                    walk_id
                    for ids in need_by_key.values()
                    for walk_id in ids
                    if walk_id not in computed and walk_id not in pending_ok
                )
                t_sim += _time.monotonic() - t0_sim
                if not need:
                    break
                waves += 1
                if self.deadline_check is not None and self.deadline_check():
                    raise VerificationTimeout()
                need_total += len(need)
                t0_flat = _time.monotonic()
                self._compute_walks_flat(
                    walks, items, need, max_depth=CHECK_DEPTH
                )
                t_flat += _time.monotonic() - t0_flat
                failed = set(
                    walk_id
                    for walk_id in need
                    if not all(
                        level.exists
                        for level in walks[walk_id].levels[:CHECK_DEPTH]
                    )
                )
                pending_ok.update(w for w in need if w not in failed)
                if not failed:
                    break
                computed.update(failed)
                mark_broken(failed)
            if not pending_ok:
                break
            # all levels of every checked-OK walk as ONE flat batch: the
            # early-exit is only a compute saving, never a dependency, and
            # dispatch rounds cost more than the extra cells
            batch = sorted(pending_ok)
            t0_flat = _time.monotonic()
            self._compute_walks_flat(walks, items, batch)
            t_flat += _time.monotonic() - t0_flat
            computed.update(batch)
            pending_ok.clear()
            mark_broken(batch)
        t_waves = _time.monotonic()

        alignments = [QueryAlignments(len(self.references)) for _ in items]
        leftover = self._scan(walks, items, computed, record=alignments)
        assert not leftover
        log.debug(
            "batcher timers: pack %.2fs kernel %.2fs numpy %.2fs calls %d",
            _BATCH_TIMERS["pack"],
            _BATCH_TIMERS["kernel"],
            _BATCH_TIMERS["numpy"],
            _BATCH_TIMERS["calls"],
        )
        log.debug(
            "verify batch: %d walks, %d waves (%d walks computed); "
            "build %.2fs prescreen %.2fs waves %.2fs (sim %.2fs flat %.2fs) "
            "record %.2fs",
            len(walks),
            waves,
            need_total,
            t_build - t0,
            t_prescreen - t_build,
            t_waves - t_prescreen,
            t_sim,
            t_flat,
            _time.monotonic() - t_waves,
        )
        return alignments

    def _simulate_key(
        self,
        walks: list[_AnchorWalk],
        key_walk_ids: list[int],
        computed: set[int],
        pending_ok: set[int] = frozenset(),
    ) -> list[int]:
        """Optimistic cache simulation for ONE (query, orientation,
        reference) key — the exact non-recording logic of _scan restricted
        to the walks sharing one interval cache. Walks in pending_ok have
        passed the cheap check but not run their full levels yet; they get
        the optimistic insertion without being re-listed as need."""
        cache = VerifiedIntervals(self.use_interval_optimization)
        need: list[int] = []
        for walk_id in key_walk_ids:
            walk = walks[walk_id]
            trimmed = (
                walk.root_span.as_half_open_interval().trim_from_both_sides(
                    walk.root_span.applied_extra_verification_length_per_side
                )
            )
            if cache.contains(trimmed):
                continue
            if walk_id in pending_ok:
                cache.insert(walk.root_span.as_half_open_interval())
                continue
            if walk_id not in computed:
                need.append(walk_id)
                cache.insert(walk.root_span.as_half_open_interval())
                continue
            for level in walk.levels:
                if level.node.is_root:
                    cache.insert(level.span.as_half_open_interval())
                    break
                if not level.exists:
                    break
        return need

    def _scan(
        self,
        walks: list[_AnchorWalk],
        items: list[_QueryItem],
        computed: set[int],
        record: list[QueryAlignments] | None,
    ) -> list[int]:
        """One pass over all walks in anchor order with fresh caches.

        For computed walks, replays the actual outcome; for uncomputed
        non-skipped walks, optimistically assumes the walk reaches the root
        (so its interval lands in the cache) and reports it as needed.
        When `record` is given this is the authoritative bookkeeping pass:
        alignments and statistics are emitted.
        """
        caches = {}
        stats_events = [] if record is not None else None
        need: list[int] = []

        for walk_id, walk in enumerate(walks):
            key = (walk.query_index, walk.orientation, walk.anchor.reference_id)
            cache = caches.get(key)
            if cache is None:
                cache = VerifiedIntervals(self.use_interval_optimization)
                caches[key] = cache

            trimmed = (
                walk.root_span.as_half_open_interval().trim_from_both_sides(
                    walk.root_span.applied_extra_verification_length_per_side
                )
            )
            if cache.contains(trimmed):
                if stats_events is not None:
                    stats_events.append(("avoided_root", walk.root_span.length))
                continue

            if walk_id not in computed:
                need.append(walk_id)
                # optimistic: assume the walk reaches the root
                cache.insert(walk.root_span.as_half_open_interval())
                continue

            for level in walk.levels:
                if level.node.is_root:
                    if stats_events is not None:
                        stats_events.append(("aligned_root", level.span.length))
                    cache.insert(level.span.as_half_open_interval())
                    if level.exists and record is not None:
                        if level.begin is None and not self.without_cigar:
                            # lazy traceback: only recorded walks get one
                            self._submit_traceback(walk, level, items)
                        pending = level.begin is None
                        alignment = QueryAlignment(
                            start_in_reference=level.begin,
                            num_errors=level.distance,
                            orientation=walk.orientation,
                            cigar=(
                                None if pending else _cigar_value(level.cigar)
                            ),
                        )
                        if pending:
                            self._patches.append((alignment, level))
                        record[walk.query_index].insert(
                            alignment,
                            walk.anchor.reference_id,
                        )
                    break
                if stats_events is not None:
                    stats_events.append(("aligned_inner", level.span.length))
                if not level.exists:
                    break

        if stats_events is not None:
            self.last_stats_events = stats_events
        return need

    # ---------------- phase A ----------------

    def _build_walks(self, items: list[_QueryItem]) -> list[_AnchorWalk]:
        """Builds every walk with its root span (needed by the cache
        simulation for ALL walks) but defers per-level span construction
        to _ensure_levels — only the few percent of walks that actually
        compute ever need their inner levels."""
        from .utils.mathutils import float_aware_ceil

        ref_lengths = [len(r.rank_sequence) for r in self.references]
        walks = []
        for query_index, item in enumerate(items):
            # per-tree invariants of the root span math
            # (verification.cpp:157-184): base length and extra depend only
            # on the root node, the leaf offset term only on the leaf
            root = item.pex_tree.root
            base_length = (
                root.length_of_query_span + 2 * root.num_errors + 1
            )
            extra = float_aware_ceil(
                base_length * self.extra_verification_ratio
            )
            full_length = base_length + 2 * extra
            chains = {}
            leaf_offsets = {}
            for leaf_index, leaf in enumerate(item.pex_tree.leaves):
                chains[leaf_index] = self._chain_for(item.pex_tree, leaf)
                leaf_offsets[leaf_index] = (
                    leaf.query_index_from
                    - root.query_index_from
                    + root.num_errors
                    + extra
                )
            for orientation, result in (
                (Orientation.FORWARD, item.forward_result),
                (Orientation.REVERSE_COMPLEMENT, item.rc_result),
            ):
                for anchor in result.iter_anchors():
                    start = anchor.reference_position - leaf_offsets[
                        anchor.pex_leaf_index
                    ]
                    if start < 0:
                        start = 0
                    ref_len = ref_lengths[anchor.reference_id]
                    length = full_length
                    if length > ref_len - start:
                        length = ref_len - start
                    walks.append(
                        _AnchorWalk(
                            query_index,
                            orientation,
                            anchor,
                            chains[anchor.pex_leaf_index],
                            SpanConfig(start, length, extra),
                        )
                    )
        return walks

    def _ensure_levels(
        self, walk: _AnchorWalk, item: _QueryItem, upto: int | None = None
    ) -> None:
        """Materialize walk levels up to `upto` (default: the full chain).
        Levels are built incrementally — most computed walks are spurious
        anchors that die in their 3-level prescreen, and building all ~9
        span/level objects for each was a measured chunk cost."""
        target = (
            len(walk.chain) if upto is None else min(upto, len(walk.chain))
        )
        if len(walk.levels) >= target:
            return
        leaf = item.pex_tree.leaves[walk.anchor.pex_leaf_index]
        reference = self.references[walk.anchor.reference_id]
        for node in walk.chain[len(walk.levels) : target]:
            span = (
                walk.root_span
                if node.is_root
                else compute_reference_span(
                    walk.anchor,
                    node,
                    leaf.query_index_from,
                    len(reference.rank_sequence),
                    0.0,
                )
            )
            walk.levels.append(_WalkLevel(span, node))

    def _oriented_query(self, item: _QueryItem, orientation: Orientation):
        return (
            item.query_record.rank_sequence
            if orientation == Orientation.FORWARD
            else item.query_record.reverse_complement_rank_sequence
        )

    def _addrs(self, walk: _AnchorWalk, level: _WalkLevel) -> tuple[int, int]:
        """Global char offsets of (pattern, window) in the resident banks,
        or (-1, -1) when the resident path is off."""
        if self._resident is None:
            return -1, -1
        ref_bank, query_bank = self._resident
        strand = 0 if walk.orientation == Orientation.FORWARD else 1
        pat_addr = (
            query_bank.base(2 * walk.query_index + strand)
            + level.node.query_index_from
        )
        win_addr = (
            ref_bank.base(walk.anchor.reference_id) + level.span.offset
        )
        return pat_addr, win_addr

    @staticmethod
    def _level_key(walk: _AnchorWalk, level: _WalkLevel) -> tuple:
        return (
            walk.query_index,
            walk.orientation,
            walk.anchor.reference_id,
            level.node.query_index_from,
            level.node.query_index_to,
            level.span.offset,
            level.span.length,
        )

    def _observe_host_wave(self, seconds: float) -> None:
        """Feed a fully-host wave's timing to the effective host chain
        rate using the estimate stashed by _try_fused_wave's routing
        pass. This is the de-hysteresis mechanism (VERDICT r4 item 8):
        every full host wave re-normalizes the EWMA, so a composition
        shift moves the rate within a few waves in EITHER direction —
        no artificial decay needed (see _host_chain_rate)."""
        est = getattr(self, "_host_wave_estimate", 0.0)
        if est and seconds > 0:
            self._host_wave_estimate = 0.0
            # normalized at the router's half-pool pricing so its host_s
            # prediction for an identical wave equals the observed wall
            _observe_host_band_rate(est, seconds, 2, effective=True)

    def _try_fused_wave(
        self,
        walks,
        items,
        subset: list[int],
        spec: list[int] | None = None,
        spec_depth: int | None = None,
    ) -> bool:
        """Run one wave of walks as a single fused device dispatch
        (ops/fused_verify.py): `subset` walks at FULL depth, `spec` walks
        (chain speculation) only to `spec_depth` levels — a passing
        speculated walk means its root insertion covers the rest of its
        chain, so computing past the prescreen (let alone its root) is the
        measured 15x root overcompute. Returns False when the wave should
        run on the host/bucketed hybrid instead — no resident banks, kill
        switch, device off, or the cost model picks the host (the native
        engine finishes small cascade waves before a dispatch returns).

        Semantics contract with the host path: every computed level's
        `exists` is exact; levels past a walk's first failure keep their
        default exists=False and their (masked, sentinel) kernel results
        are never cached — another walk sharing the same task key may be
        alive and must not read a masked sentinel; accepted roots are
        finalized exactly like the host path (begin/CIGAR via
        _finalize_roots)."""
        import logging
        import time as _time

        # cleared on entry; set at host-routing returns so the caller's
        # fallback compute can feed an effective-rate sample
        self._host_wave_estimate = 0.0
        if self._resident is None or _NO_FUSED or not subset:
            return False
        if not (_FORCE_FUSED or self._device_resolved_lazy()):
            return False
        from .ops.fused_verify import FusedBatch

        ref_bank, query_bank = self._resident
        cache = self._task_cache
        batch = FusedBatch(ref_bank, query_bank)
        staged = []  # (walk_id, [(level, key, ("cached",res)|("task",ref))])
        useful_band_cells = 0
        t0 = _time.monotonic()

        # same-wave dedup, restricted to GUARANTEED-ALIVE producers: a
        # task staged as its walk's first in-flight level always computes
        # a real result (aliveness can only drop at a failed in-flight
        # level), so other walks sharing the key may read it. Deeper
        # tasks can be masked to a sentinel and must not be shared.
        wave_shared: dict[tuple, tuple] = {}

        def stage_walk(walk_id: int, depth_limit: int | None) -> None:
            nonlocal useful_band_cells
            walk = walks[walk_id]
            item = items[walk.query_index]
            self._ensure_levels(walk, item, upto=depth_limit)
            plan = []
            staged_in_flight = 0
            levels = (
                walk.levels
                if depth_limit is None
                else walk.levels[:depth_limit]
            )
            for level in levels:
                key = self._level_key(walk, level)
                hit = cache.get(key)
                if hit is not None:
                    plan.append((level, key, ("cached", hit)))
                    if hit[0] > level.node.num_errors:
                        break  # cached failure: nothing deeper can run
                    continue
                shared = wave_shared.get(key)
                if shared is not None:
                    plan.append((level, key, ("task", shared)))
                    staged_in_flight += 1
                    continue
                pat_addr, win_addr = self._addrs(walk, level)
                m = (
                    level.node.query_index_to
                    - level.node.query_index_from
                    + 1
                )
                n = level.span.length
                budget = level.node.num_errors
                ref = batch.add_task(
                    walk_id, win_addr, n, pat_addr, m, budget
                )
                if staged_in_flight == 0:
                    wave_shared[key] = ref
                plan.append((level, key, ("task", ref)))
                staged_in_flight += 1
                useful_band_cells += (
                    max(min(n - m + 2 * budget + 1, m), 1) * n
                )
            staged.append((walk_id, plan))

        # resident addressing is all-or-nothing per chunk: the banks are
        # built from every read and reference (_setup_chunk_state), so
        # _addrs cannot be partial when self._resident is set

        def walk_cells_estimate(walk_id: int) -> int:
            """Useful band cells of one walk's full chain, without
            materializing level/span objects (routing input only)."""
            walk = walks[walk_id]
            total = 0
            for node in walk.chain:
                m = node.length_of_query_span
                b = node.num_errors
                n = (
                    walk.root_span.length
                    if node.is_root
                    else m + 2 * b + 1
                )
                total += max(min(n - m + 2 * b + 1, m), 1) * n
            return total

        log = logging.getLogger("floxer-tpu")
        host_set: list[int] = []
        if self.use_device is True or _FORCE_FUSED:
            device_set = list(subset)
            spec_device = list(spec or [])
        else:
            # SPLIT routing: the fastest wave may use BOTH the card and
            # the 4-thread native engine — the fused dispatch is
            # asynchronous, the host engine computes its
            # share concurrently, and the device's wait hides under the
            # host work. Balance X (device share) so modeled device time
            # (overhead + padded cells) equals modeled host time; host
            # threads priced at half the pool (the next chunk's FM search
            # runs concurrently on the same cores).
            estimates = [walk_cells_estimate(w) for w in subset]
            total_cells = float(sum(estimates))
            host_threads = max(1, min(4, max(len(subset), 1)) // 2)
            host_rate = _host_chain_rate() * host_threads
            if (
                total_cells / host_rate <= _PROBE_MIN_HOST_S
                or not self._device_resolved_lazy()
            ):
                return False
            overhead = _fused_call_overhead()
            pad_factor = 1.5  # segment padding over useful cells, typical
            denom = total_cells * (
                pad_factor / _device_band_rate() + 1.0 / host_rate
            )
            x_device = (total_cells / host_rate - overhead) / max(
                denom, 1e-9
            )
            x_device = min(max(x_device, 0.0), 1.0)
            # absolute floor: cascade-sized waves stay on the host
            # regardless of what the (noisy at small C) balance says —
            # and must never trigger a fresh plan compile
            if total_cells < _FUSED_MIN_DEVICE_CELLS:
                x_device = 0.0
            if x_device < 0.25:
                # slow decay while routing host: a compile spike can
                # inflate the overhead EWMA for the lifetime of a server
                # process; decaying it on host-routed waves lets the
                # router re-probe the device instead of staying priced
                # out forever
                if _FUSED_OVERHEAD["ewma"] is not None:
                    _FUSED_OVERHEAD["ewma"] *= 0.98
                # the caller computes this wave on the host — hand it the
                # chain estimate so its timing becomes an effective-rate
                # sample (continuous composition tracking, see
                # _host_chain_rate)
                self._host_wave_estimate = total_cells
                log.debug(
                    "fused route: %d walks %.0fM cells -> host "
                    "(device share %.2f)",
                    len(subset), total_cells / 1e6, x_device,
                )
                return False
            device_set, host_set = [], []
            budget_cells = x_device * total_cells
            acc = 0.0
            for walk_id, cells in zip(subset, estimates):
                if acc < budget_cells:
                    device_set.append(walk_id)
                    acc += cells
                else:
                    host_set.append(walk_id)
            spec_device = []
            log.debug(
                "fused route: split %d walks -> %d device + %d host "
                "(device share %.2f of %.0fM cells)",
                len(subset), len(device_set), len(host_set),
                x_device, total_cells / 1e6,
            )

        for walk_id in device_set:
            stage_walk(walk_id, None)
        for walk_id in spec_device:
            stage_walk(walk_id, spec_depth)

        if (
            self.use_device is not True
            and not _FORCE_FUSED
            and batch.num_tasks
        ):
            plan, already_compiled = batch.plan_preview()
            if (
                not already_compiled
                and len(device_set) < _FUSED_NEW_PLAN_MIN_WALKS
            ):
                # dispatching a never-seen plan compiles a fresh
                # multi-second program (observed 13 s mid-job); only
                # wave-1-scale waves can amortize that — smaller waves
                # fall back to the host and leave the template unchanged
                self._host_wave_estimate = total_cells
                log.debug(
                    "fused route: %d walks -> host (new plan, wave too "
                    "small to amortize its compile)", len(subset),
                )
                return False

        modeled_kernel_s = batch.padded_cells() / _device_band_rate()
        t_staged = _time.monotonic()
        dispatched = batch.num_tasks > 0 and batch.run_async()
        t_disp = _time.monotonic()
        # host share runs WHILE the device executes (native engine
        # releases the GIL; the device sync happens in collect below)
        if host_set:
            t_hs = _time.monotonic()
            self._compute_walks_flat(walks, items, host_set, max_depth=None)
            cells_by_walk = dict(zip(subset, estimates)) if host_set else {}
            _observe_host_band_rate(
                sum(cells_by_walk.get(w, 0) for w in host_set),
                _time.monotonic() - t_hs,
                max(1, min(4, max(len(subset), 1)) // 2),
                effective=True,
            )
        if spec and not spec_device:
            self._compute_walks_flat(
                walks, items, list(spec), max_depth=spec_depth
            )
        t_host_done = _time.monotonic()
        results = batch.collect() if dispatched else {}
        t1 = _time.monotonic()
        if dispatched:
            # observe only the UNHIDDEN device cost (the dispatch call +
            # residual wait after the host share finished) — hidden time
            # is free, and host-side staging Python is not device cost.
            # In SPLIT mode the kernel time is supposed to hide under the
            # concurrent host share, so the whole unhidden cost is
            # overhead (subtracting modeled kernel time there made
            # net-losing splits look cheap and kept the router engaging
            # through windows with slow dispatches — measured -20% on the
            # 10k-read ladder). Only an all-device wave subtracts its
            # modeled kernel time.
            unhidden = (t_disp - t_staged) + (t1 - t_host_done)
            _observe_fused_call(
                unhidden, modeled_kernel_s if not host_set else 0.0
            )
            if not host_set:
                # all-device wave: the residual wait minus the estimated
                # per-call overhead is real kernel execution — calibrate
                # the device band rate from it
                _observe_device_band_rate(
                    batch.padded_cells(),
                    (t1 - t_host_done) - _fused_call_overhead(),
                )
            self._fused_dispatches += 1
            _BATCH_TIMERS["fused"] += 1
            _BATCH_TIMERS["calls"] += 1
            _BATCH_TIMERS["kernel"] += t1 - t_host_done

        root_tasks = []
        for walk_id, plan in staged:
            for level, key, how in plan:
                if how[0] == "cached":
                    distance, end = how[1]
                else:
                    distance, end = results[how[1]]
                exists = distance <= level.node.num_errors
                level.exists = exists
                if how[0] == "task":
                    # results below a failure are masked sentinels — only
                    # levels reached while the walk was alive are real
                    cache[key] = (distance, end)
                if level.node.is_root:
                    if exists:
                        root_tasks.append((walk_id, level, distance, end))
                    break
                if not exists:
                    break
        log.debug(
            "fused wave: %d walks (%d device / %d host) %d device tasks "
            "(%d segments) in %.2fs (dispatch %.2fs, host share %.2fs, "
            "residual device wait %.2fs), %.0fM device band cells",
            len(subset), len(device_set), len(host_set), batch.num_tasks,
            sum(len(stage) for stage in batch.stages),
            _time.monotonic() - t0, t_disp - t0, t_host_done - t_disp,
            t1 - t_host_done, useful_band_cells / 1e6,
        )
        t0_roots = _time.monotonic()
        self._finalize_roots(root_tasks, walks, items, lazy_tracebacks=True)
        if root_tasks:
            log.debug(
                "finalize roots (fused): %d tasks in %.2fs",
                len(root_tasks), _time.monotonic() - t0_roots,
            )
        return True

    def _batcher_use_device(self):
        """use_device for the host/bucketed batchers: when the fused wave
        path owns device work (SoA loop + resident banks), a host-routed
        wave must stay on the host instead of round-tripping its big
        buckets to the chip one by one (the pre-fused behavior). The
        legacy object path never reaches _try_fused_wave, so it keeps the
        round-2 bucketed-device behavior."""
        if (
            getattr(self, "_soa_active", False)
            and self._resident is not None
            and not _NO_FUSED
        ):
            return False
        return self.use_device

    def _device_resolved_lazy(self) -> bool:
        if getattr(self, "_device_flag", None) is None:
            self._device_flag = (
                self.use_device()
                if callable(self.use_device)
                else bool(self.use_device)
            )
        return self._device_flag

    def _compute_walks(
        self,
        walks: list[_AnchorWalk],
        items: list[_QueryItem],
        subset: list[int],
        max_depth: int | None = None,
    ):
        for w in subset:
            self._ensure_levels(walks[w], items[walks[w].query_index])
        limit = max((len(walks[w].levels) for w in subset), default=0)
        if max_depth is not None:
            limit = min(limit, max_depth)
        active = list(subset)
        cache = getattr(self, "_task_cache", None)
        if cache is None:
            cache = self._task_cache = {}

        for depth in range(limit):
            batcher = _TaskBatcher(
                self._batcher_use_device(), resident=self._resident
            )
            slot_of_walk = {}
            cached_of_walk = {}
            for walk_id in active:
                walk = walks[walk_id]
                if depth >= len(walk.levels):
                    continue
                level = walk.levels[depth]
                item = items[walk.query_index]
                query = self._oriented_query(item, walk.orientation)
                reference = self.references[walk.anchor.reference_id]
                key = (
                    walk.query_index,
                    walk.orientation,
                    walk.anchor.reference_id,
                    level.node.query_index_from,
                    level.node.query_index_to,
                    level.span.offset,
                    level.span.length,
                )
                hit = cache.get(key)
                if hit is not None:
                    cached_of_walk[walk_id] = hit
                    continue
                pattern = query[
                    level.node.query_index_from : level.node.query_index_to + 1
                ]
                window = reference.rank_sequence[
                    level.span.offset : level.span.offset + level.span.length
                ]
                pat_addr, win_addr = self._addrs(walk, level)
                slot_of_walk[walk_id] = (
                    batcher.add(
                        key, pattern, window, walk_id,
                        budget=level.node.num_errors,
                        pat_addr=pat_addr, win_addr=win_addr,
                    ),
                    key,
                )

            distances, ends = batcher.run()

            next_active = []
            root_tasks = []  # (walk_id, level, distance, end)
            for walk_id in active:
                walk = walks[walk_id]
                if depth >= len(walk.levels):
                    continue
                level = walk.levels[depth]
                if walk_id in cached_of_walk:
                    distance, end = cached_of_walk[walk_id]
                else:
                    slot, key = slot_of_walk[walk_id]
                    distance = int(distances[slot])
                    end = int(ends[slot])
                    cache[key] = (distance, end)
                level.exists = distance <= level.node.num_errors
                if level.node.is_root:
                    if level.exists:
                        root_tasks.append((walk_id, level, distance, end))
                elif level.exists and depth + 1 < len(walk.levels):
                    next_active.append(walk_id)

            self._finalize_roots(root_tasks, walks, items)
            active = next_active

    def _compute_walks_flat(
        self,
        walks: list[_AnchorWalk],
        items: list[_QueryItem],
        subset: list[int],
        max_depth: int | None = None,
    ):
        """Hybrid level computation. The cheap level prefix of every walk
        (node span <= FLOXER_TPU_FLAT_DEEP_SPAN, default 4096) runs as ONE
        batcher pass — a single dispatch round for the levels where
        round-trip latency dominates and a failed level's "wasted" sibling
        cells are negligible. The deep suffix — which holds ~95% of the DP
        cells at 20 kb reads (the root alone ~80%) — then advances
        level-synchronously with early exit, so a walk that already broke
        never computes its expensive levels. The previous always-flat
        policy computed every broken walk's root: 4.5x the sequential
        replay's root alignments at the reference-evaluation scale."""
        import os

        deep_span = int(
            os.environ.get("FLOXER_TPU_FLAT_DEEP_SPAN", "4096")
        )
        cache = getattr(self, "_task_cache", None)
        if cache is None:
            cache = self._task_cache = {}

        level_key = self._level_key

        def enqueue(batcher, walk, walk_id, level, key):
            item = items[walk.query_index]
            query = self._oriented_query(item, walk.orientation)
            reference = self.references[walk.anchor.reference_id]
            pattern = query[
                level.node.query_index_from : level.node.query_index_to + 1
            ]
            window = reference.rank_sequence[
                level.span.offset : level.span.offset + level.span.length
            ]
            pat_addr, win_addr = self._addrs(walk, level)
            return batcher.add(
                key, pattern, window, walk_id,
                budget=level.node.num_errors,
                pat_addr=pat_addr, win_addr=win_addr,
            )

        root_tasks = []

        def apply_result(walk_id, level, distance, end):
            level.exists = distance <= level.node.num_errors
            if level.node.is_root and level.exists:
                root_tasks.append((walk_id, level, distance, end))

        # phase 1: one flat pass over every walk's cheap level prefix
        batcher = _TaskBatcher(
            self._batcher_use_device(), resident=self._resident
        )
        pending = []  # (walk_id, depth, key, slot_or_None)
        limits = {}  # walk_id -> (prefix levels taken, level limit)
        for walk_id in subset:
            walk = walks[walk_id]
            chain = walk.chain
            limit = (
                len(chain)
                if max_depth is None
                else min(max_depth, len(chain))
            )
            take = 0
            while (
                take < limit
                and chain[take].length_of_query_span <= deep_span
            ):
                take += 1
            self._ensure_levels(walk, items[walk.query_index], upto=take)
            for depth in range(take):
                level = walk.levels[depth]
                key = level_key(walk, level)
                if key in cache:
                    pending.append((walk_id, depth, key, None))
                    continue
                slot = enqueue(batcher, walk, walk_id, level, key)
                pending.append((walk_id, depth, key, slot))
            limits[walk_id] = (take, limit)

        distances, ends = batcher.run()
        for walk_id, depth, key, slot in pending:
            if slot is None:
                distance, end = cache[key]
            else:
                distance = int(distances[slot])
                end = int(ends[slot])
                cache[key] = (distance, end)
            apply_result(walk_id, walks[walk_id].levels[depth], distance, end)

        # phase 2: deep levels, level-synchronous with early exit
        active = []
        depth_of = {}
        for walk_id in subset:
            take, limit = limits[walk_id]
            if take >= limit:
                continue
            walk = walks[walk_id]
            if all(walk.levels[d].exists for d in range(take)):
                active.append(walk_id)
                depth_of[walk_id] = take
        while active:
            batcher = _TaskBatcher(
                self._batcher_use_device(), resident=self._resident
            )
            round_pending = []  # (walk_id, level, key, slot_or_None)
            for walk_id in active:
                walk = walks[walk_id]
                self._ensure_levels(
                    walk,
                    items[walk.query_index],
                    upto=depth_of[walk_id] + 1,
                )
                level = walk.levels[depth_of[walk_id]]
                key = level_key(walk, level)
                if key in cache:
                    round_pending.append((walk_id, level, key, None))
                    continue
                slot = enqueue(batcher, walk, walk_id, level, key)
                round_pending.append((walk_id, level, key, slot))
            distances, ends = batcher.run()
            next_active = []
            for walk_id, level, key, slot in round_pending:
                if slot is None:
                    distance, end = cache[key]
                else:
                    distance = int(distances[slot])
                    end = int(ends[slot])
                    cache[key] = (distance, end)
                apply_result(walk_id, level, distance, end)
                depth_of[walk_id] += 1
                if (
                    level.exists
                    and not level.node.is_root
                    and depth_of[walk_id] < limits[walk_id][1]
                ):
                    next_active.append(walk_id)
            active = next_active

        import logging
        import time as _time

        t0_roots = _time.monotonic()
        self._finalize_roots(root_tasks, walks, items, lazy_tracebacks=True)
        if root_tasks:
            logging.getLogger("floxer-tpu").debug(
                "finalize roots: %d tasks in %.2fs",
                len(root_tasks),
                _time.monotonic() - t0_roots,
            )

    def _finalize_roots(self, root_tasks, walks, items, lazy_tracebacks=False):
        """Begin/CIGAR for accepted roots; memoized per unique task."""
        if not root_tasks:
            return

        if self.without_cigar:
            # reversed-sequence trick: batch the reversed alignments
            batcher = _TaskBatcher(self._batcher_use_device())
            per_task_slot = []
            for walk_id, level, distance, _ in root_tasks:
                walk = walks[walk_id]
                item = items[walk.query_index]
                query = self._oriented_query(item, walk.orientation)
                reference = self.references[walk.anchor.reference_id]
                pattern = query[
                    level.node.query_index_from : level.node.query_index_to + 1
                ][::-1]
                window = reference.rank_sequence[
                    level.span.offset : level.span.offset + level.span.length
                ][::-1]
                key = (
                    "rev",
                    walk.query_index,
                    walk.orientation,
                    walk.anchor.reference_id,
                    level.node.query_index_from,
                    level.span.offset,
                    level.span.length,
                )
                per_task_slot.append(
                    batcher.add(
                        key, pattern, window, walk_id,
                        budget=level.node.num_errors,
                    )
                )
            distances, ends = batcher.run()
            for (walk_id, level, distance, _), slot in zip(
                root_tasks, per_task_slot
            ):
                level.distance = int(distances[slot])
                level.begin = level.span.offset + (
                    level.span.length - int(ends[slot])
                )
                level.cigar = []
            return

        memo = getattr(self, "_root_memo", None)
        if memo is None:
            memo = self._root_memo = {}

        def key_and_slices(walk_id, level):
            walk = walks[walk_id]
            item = items[walk.query_index]
            query = self._oriented_query(item, walk.orientation)
            reference = self.references[walk.anchor.reference_id]
            key = (
                walk.query_index,
                walk.orientation,
                walk.anchor.reference_id,
                level.node.query_index_from,
                level.span.offset,
                level.span.length,
            )
            pattern = query[
                level.node.query_index_from : level.node.query_index_to + 1
            ]
            window = reference.rank_sequence[
                level.span.offset : level.span.offset + level.span.length
            ]
            return key, pattern, window

        if lazy_tracebacks:
            # SoA path: tracebacks are only consumed for walks the final
            # authoritative scan actually records — speculatively computed
            # or later-cache-avoided walks never need one. Stash the DP
            # result; the record pass submits tracebacks for recorded
            # walks only (_submit_traceback).
            for walk_id, level, distance, end in root_tasks:
                level.distance = distance
                level.end_col = end
                level.begin = None
                level.cigar = None
            return

        # legacy/oracle path: submit eagerly for every accepted root. The
        # banded tracebacks run in the native library (ctypes drops the
        # GIL), so unique roots fan out across host threads; they are not
        # awaited here — resolve_deferred() collects them. memo values are
        # either (begin, cigar) tuples or still-pending futures.
        pool = _traceback_pool()
        for walk_id, level, distance, end in root_tasks:
            key, pattern, window = key_and_slices(walk_id, level)
            if key not in memo:
                memo[key] = pool.submit(
                    dp_reference.banded_cigar_traceback,
                    window, pattern, end, distance,
                )

        for walk_id, level, distance, end in root_tasks:
            key, _, _ = key_and_slices(walk_id, level)
            level.distance = distance
            entry = memo[key]
            if isinstance(entry, tuple):
                begin, cigar = entry
                level.begin = level.span.offset + begin
                level.cigar = cigar
            else:
                level.begin = None
                level.cigar = None
                self._deferred.append((entry, level))

    def _use_device_traceback(self) -> bool:
        """Route recorded-root CIGAR tracebacks to the device direction-
        bitmap kernel (ops/traceback_device.py) instead of the host pool.
        Opt-in via FLOXER_TPU_DEVICE_TRACEBACK=1: its per-shape compiles
        and row-scan dispatches are not yet measured against the
        overlapped host C++ band walk, so the host pool stays the
        default."""
        if self._device_tb_enabled is None:
            import os

            env = os.environ.get("FLOXER_TPU_DEVICE_TRACEBACK")
            self._device_tb_enabled = env not in (None, "", "0")
        return self._device_tb_enabled

    def _submit_traceback(self, walk, level, items) -> None:
        """Submit the banded CIGAR traceback for one recorded root level
        (lazy mode); begin/cigar resolve in resolve_deferred()."""
        memo = getattr(self, "_root_memo", None)
        if memo is None:
            memo = self._root_memo = {}
        key = (
            walk.query_index,
            walk.orientation,
            walk.anchor.reference_id,
            level.node.query_index_from,
            level.span.offset,
            level.span.length,
        )
        entry = memo.get(key)
        if entry is None:
            item = items[walk.query_index]
            query = self._oriented_query(item, walk.orientation)
            reference = self.references[walk.anchor.reference_id]
            pattern = query[
                level.node.query_index_from : level.node.query_index_to + 1
            ]
            window = reference.rank_sequence[
                level.span.offset : level.span.offset + level.span.length
            ]
            if self._use_device_traceback():
                entry = memo[key] = _DeviceTb(len(self._device_tb_tasks))
                self._device_tb_tasks.append(
                    (window, pattern, level.end_col, level.distance)
                )
            else:
                entry = memo[key] = _traceback_pool().submit(
                    dp_reference.banded_cigar_traceback,
                    window, pattern, level.end_col, level.distance,
                )
        if isinstance(entry, tuple):
            begin, cigar = entry
            level.begin = level.span.offset + begin
            level.cigar = cigar
        else:
            self._deferred.append((entry, level))

    def resolve_deferred(self) -> None:
        """Await the deferred root tracebacks and patch begin/CIGAR into
        their levels and the alignment records built from them."""
        memo = getattr(self, "_root_memo", None)
        if self._device_tb_tasks:
            # one batched device dispatch set for every traceback queued
            # since the last resolve: direction-bitmap forward + walk on
            # device, run-length formatting on host
            from .ops.traceback_device import (
                banded_cigar_traceback_device_batch,
            )

            results = banded_cigar_traceback_device_batch(
                self._device_tb_tasks
            )
            if memo:
                for entry in memo.values():
                    if isinstance(entry, _DeviceTb) and entry.value is None:
                        entry.value = results[entry.index]
            self._device_tb_tasks = []
        for future, level in self._deferred:
            begin, cigar = future.result()
            level.begin = level.span.offset + begin
            level.cigar = cigar
        self._deferred = []
        if memo:
            for key, entry in list(memo.items()):
                if not isinstance(entry, tuple):
                    memo[key] = entry.result()
        for alignment, level in self._patches:
            alignment.start_in_reference = level.begin
            alignment.cigar = _cigar_value(level.cigar)
        self._patches = []

    last_stats_events: list = []
    last_avoided_lengths = np.zeros(0, dtype=np.int64)
