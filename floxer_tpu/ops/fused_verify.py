"""One-dispatch fused verification over device-resident banks.

A wave of the verification cascade dispatched as shape-bucketed kernel
calls costs one dispatch and one download per bucket. This module
collapses ONE WAVE into ONE
device dispatch: a single jitted program that, per walk level stage,

  - gathers every task's window/pattern slices from the HBM-resident
    packed banks (ops/resident.py — offsets only, no host uploads),
  - gates each task on its walk's in-flight aliveness (a level is only
    meaningful if every earlier level of the same walk passed),
  - compacts alive tasks to the front of their segment (dead tasks carry
    window length 0, so they bound no column loop),
  - runs the production Myers kernels (banded, ops/banded.py; full-state
    small / large, ops/myers.py) on the segment,
  - folds the pass/fail verdicts back into the aliveness vector.

The host reads back one (distances, ends) pair per wave and replays the
sequential semantics exactly as before (verify_batch.py wave loop); tasks
after a walk's first failing level return a masked sentinel (distance =
pattern length, never cached) because their window length is zeroed.

Replaces: the per-anchor seqan3 calls of the reference's verification
walk (verification.cpp:44-117, alignment.cpp:83-178) — the engine the
reference names as its bottleneck (CONTRIBUTING.md:3-4) — with a
single-program cascade step on the device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .banded import BAND_WORDS_QUANTUM
from .banded import GROUP as BANDED_GROUP
from .myers import FULL_GROUP, MAX_UNROLLED_WORDS, WORD
from .resident import CHARS_PER_WORD, ResidentBank

KIND_BANDED = "banded"
KIND_SMALL = "small"
KIND_LARGE = "large"

_GROUP = {KIND_BANDED: BANDED_GROUP, KIND_SMALL: FULL_GROUP,
          KIND_LARGE: FULL_GROUP}

# task-table columns (one int32 matrix ships every segment's scalars)
(
    COL_WIN_WORD0, COL_WIN_PHASE, COL_WIN_LEN, COL_PAT_WORD0,
    COL_PAT_PHASE, COL_STREAM_WORD0, COL_STREAM_PHASE, COL_PAT_LEN,
    COL_BUDGET, COL_WALK,
) = range(10)
NUM_COLS = 10

# dispatch-plan templates: (ref bank words, query bank words) ->
# {(stage, kind): {shape_words, n_chars, cap}, "walks": N} — monotone
# maxes so every wave of a workload shares one compiled program
_PLAN_TEMPLATES: dict[tuple, dict] = {}

# plans dispatched (or warm-replayed) in THIS process: dispatching a plan
# not in this set compiles a fresh multi-second program mid-wave — the
# router avoids that for waves too small to amortize it
_DISPATCHED_PLANS: set[tuple] = set()


_FORCE_BANDED = bool(
    __import__("os").environ.get("FLOXER_TPU_FORCE_BANDED", "")
)


def classify_task(m: int, n: int, budget: int) -> tuple[str, int]:
    """(kind, state_words) for one task; mirrors the routing of
    verify_batch._TaskBatcher (banded whenever its band state is strictly
    narrower than full state at tile granularity; else full by word
    count). state_words is the task's own requirement — band words
    (banded) or pattern words (full); the segment takes the max over its
    tasks and pads it (_segment_shape)."""
    if 0 < budget < m and n >= m - budget:
        tile = BAND_WORDS_QUANTUM
        band_tiles = -(-(n - m + 2 * budget + 1) // (tile * WORD))
        full_tiles = -(-(-(-m // WORD)) // tile)
        # _FORCE_BANDED: test hook routing every eligible task through the
        # banded kernel (same semantics as the host batcher's hook)
        if band_tiles < full_tiles or _FORCE_BANDED:
            return KIND_BANDED, band_tiles * tile
    words = -(-m // WORD)
    if words > MAX_UNROLLED_WORDS:
        return KIND_LARGE, words
    return KIND_SMALL, words


def _pow2_at_least(x: int, floor: int) -> int:
    size = floor
    while size < x:
        size *= 2
    return size


@dataclass
class _Segment:
    kind: str
    max_words: int = 0  # max per-task state words (shape = padded max)
    max_win: int = 0  # max window length (n_chars = pow2 of this)
    # per-task host-side staging (python lists; converted on finalize)
    win_starts: list = field(default_factory=list)
    win_lens: list = field(default_factory=list)
    pat_starts: list = field(default_factory=list)
    pat_lens: list = field(default_factory=list)
    budgets: list = field(default_factory=list)
    walk_slots: list = field(default_factory=list)
    task_refs: list = field(default_factory=list)  # caller handles


class FusedBatch:
    """Host-side builder for one fused dispatch.

    add_task() stages one (walk, level) task; tasks of the same walk MUST
    be added in walk order (stage index = how many tasks this walk has
    staged so far — aliveness is chained through stages). run() issues the
    single dispatch and returns (distances, ends) aligned with the order
    of task_refs handed back by add_task."""

    def __init__(self, ref_bank: ResidentBank, query_bank: ResidentBank):
        self.ref_bank = ref_bank
        self.query_bank = query_bank
        # stage -> {kind -> _Segment}; segments take the MAX task shape so
        # edge-clamped windows and slightly-different budgets share one
        # segment — fewer kernels per program and far fewer distinct
        # compiled plans (window padding is cheap: the kernels bound their
        # column loops by the actual window lengths)
        self.stages: list[dict[str, _Segment]] = []
        self._stage_of_walk: dict[int, int] = {}
        self._walk_ids: dict[int, int] = {}  # walk_id -> dense slot
        self.num_tasks = 0
        self._pending = None  # (device result handle, plan, segments)

    def add_task(
        self,
        walk_id: int,
        win_start: int,
        win_len: int,
        pat_start: int,
        pat_len: int,
        budget: int,
    ) -> tuple[int, str, int]:
        """Stages a task; returns an opaque ref for result lookup."""
        stage = self._stage_of_walk.get(walk_id, 0)
        self._stage_of_walk[walk_id] = stage + 1
        slot = self._walk_ids.setdefault(walk_id, len(self._walk_ids))
        kind, state_words = classify_task(pat_len, win_len, budget)
        while len(self.stages) <= stage:
            self.stages.append({})
        seg = self.stages[stage].get(kind)
        if seg is None:
            seg = self.stages[stage][kind] = _Segment(kind)
        seg.max_words = max(seg.max_words, state_words)
        seg.max_win = max(seg.max_win, win_len)
        row = len(seg.win_starts)
        seg.win_starts.append(win_start)
        seg.win_lens.append(win_len)
        seg.pat_starts.append(pat_start)
        seg.pat_lens.append(pat_len)
        seg.budgets.append(budget)
        seg.walk_slots.append(slot)
        ref = (stage, kind, row)
        seg.task_refs.append(ref)
        self.num_tasks += 1
        return ref

    @staticmethod
    def _segment_shape(seg: _Segment) -> tuple[int, int, int]:
        """(shape_words, n_chars, cap) — padded static shape of a segment."""
        if seg.kind == KIND_BANDED:
            shape_words = (
                -(-seg.max_words // BAND_WORDS_QUANTUM) * BAND_WORDS_QUANTUM
            )
            n_chars = _pow2_at_least(seg.max_win, 1024)
        else:
            shape_words = _pow2_at_least(seg.max_words, 1)
            n_chars = _pow2_at_least(seg.max_win, 256)
        cap = _pow2_at_least(len(seg.win_starts), _GROUP[seg.kind])
        return shape_words, n_chars, cap

    def padded_cells(self) -> int:
        """Padded DP cells the dispatch will compute (cost-model input):
        per segment, OCCUPIED capacity x state rows x window chars. Plan
        templates may pad segments far beyond occupancy, but pad rows have
        window length 0 and cost next to nothing — so cost is modeled from
        occupancy rounded to the kernel group size."""
        total = 0
        for stage in self.stages:
            for seg in stage.values():
                shape_words, n_chars, _ = self._segment_shape(seg)
                group = _GROUP[seg.kind]
                occupied = -(-len(seg.win_starts) // group) * group
                total += occupied * shape_words * WORD * n_chars
        return total

    def run(self):
        """One device dispatch + sync; returns {task_ref: (distance,
        end)}. Use run_async() + collect() to overlap host work with the
        device execution (JAX dispatch is asynchronous; the packed-result
        download in collect() is the sync point)."""
        if self.run_async():
            return self.collect()
        return {}

    def plan_preview(self) -> tuple:
        """The plan tuple run_async() would dispatch (after merging this
        batch into the template), plus whether that plan has already been
        dispatched in this process — WITHOUT mutating the template."""
        template_key = (
            int(self.ref_bank.flat.shape[0]),
            int(self.query_bank.flat.shape[0]),
        )
        template = _PLAN_TEMPLATES.get(template_key, {})
        merged: dict[tuple, tuple] = {}
        for key in template:
            if isinstance(key, tuple):
                slot = template[key]
                merged[key] = (
                    slot["shape_words"], slot["n_chars"], slot["cap"]
                )
        num_walks = 32
        for walks_used in (len(self._walk_ids), template.get("walks", 1)):
            num_walks = max(num_walks, _pow2_at_least(max(walks_used, 1), 32))
        for stage_index, stage in enumerate(self.stages):
            for kind, seg in stage.items():
                shape_words, n_chars, cap = self._segment_shape(seg)
                old = merged.get((stage_index, kind), (0, 0, _GROUP[kind]))
                merged[(stage_index, kind)] = (
                    max(old[0], shape_words),
                    max(old[1], n_chars),
                    max(old[2], cap),
                )
        plan = tuple(
            (kind, *merged[(stage_index, kind)])
            for stage_index, kind in sorted(merged)
        )
        return plan, (plan, num_walks) in _DISPATCHED_PLANS

    def run_async(self) -> bool:
        """One device dispatch WITHOUT the sync; returns True when work
        was dispatched (collect() then returns its results).

        The dispatch plan (segment shapes/capacities — the jit compile
        key) is canonicalized through a module-level TEMPLATE keyed by the
        bank shapes: each run merges its segments into the template and
        emits the template's full segment list (missing segments ship as
        all-pad, which the kernels skip via their dynamic column bounds).
        Plans therefore converge after the first wave or two — every
        later wave of every chunk reuses ONE compiled program instead of
        paying a fresh compile per task-count shape."""
        if self.num_tasks == 0:
            self._pending = None
            return False
        template_key = (
            int(self.ref_bank.flat.shape[0]),
            int(self.query_bank.flat.shape[0]),
        )
        template = _PLAN_TEMPLATES.setdefault(template_key, {})
        num_walks = 32
        for walks_used in (len(self._walk_ids), template.get("walks", 1)):
            num_walks = max(num_walks, _pow2_at_least(max(walks_used, 1), 32))
        template["walks"] = num_walks
        # merge this batch into the template (monotone maxes)
        grew = False
        for stage_index, stage in enumerate(self.stages):
            for kind, seg in stage.items():
                shape_words, n_chars, cap = self._segment_shape(seg)
                slot = template.setdefault((stage_index, kind), {
                    "shape_words": 0, "n_chars": 0, "cap": _GROUP[kind],
                })
                if (
                    shape_words > slot["shape_words"]
                    or n_chars > slot["n_chars"]
                    or cap > slot["cap"]
                ):
                    # growth, not first fill; accumulate across segments so
                    # a later first-fill segment can't mask a real growth
                    grew = grew or slot["shape_words"] > 0
                slot["shape_words"] = max(slot["shape_words"], shape_words)
                slot["n_chars"] = max(slot["n_chars"], n_chars)
                slot["cap"] = max(slot["cap"], cap)
        if grew and template.get("compiled_once"):
            # GROWTH recompile: every template growth step is a fresh
            # compile of the whole wave program. Task counts are the
            # volatile axis — absorb the next growth up front by doubling
            # every task capacity and the walk capacity, so large-workload
            # runs converge to one recompile instead of one per new
            # task-count high-water mark. All-pad task rows have window
            # length 0, so the inflation costs table bytes only.
            for key, slot in template.items():
                if isinstance(key, tuple):
                    slot["cap"] *= 2
            num_walks *= 2
            template["walks"] = num_walks
        plan = []
        seg_args = []
        segments = []
        for stage_index, kind in sorted(
            key for key in template if isinstance(key, tuple)
        ):
            slot = template[(stage_index, kind)]
            seg = (
                self.stages[stage_index].get(kind)
                if stage_index < len(self.stages)
                else None
            )
            if seg is None:
                seg = _Segment(kind)  # all-pad: skipped on device
            segments.append(seg)
            plan.append(
                (kind, slot["shape_words"], slot["n_chars"], slot["cap"])
            )
            seg_args.append(
                _segment_device_args(seg, slot["cap"], num_walks)
            )
        from ..warm_shapes import record_shape

        record_shape((
            "fused", tuple(plan), num_walks,
            int(self.ref_bank.flat.shape[0]),
            int(self.query_bank.flat.shape[0]),
        ))
        _DISPATCHED_PLANS.add((tuple(plan), num_walks))
        template["compiled_once"] = True
        table = jnp.asarray(np.concatenate(seg_args, axis=0))
        packed = _fused_call(
            self.ref_bank.flat,
            self.query_bank.flat,
            table,
            plan=tuple(plan),
            num_walks=num_walks,
        )
        self._pending = (packed, tuple(plan), segments)
        return True

    def collect(self):
        """Sync point: ONE [sum(caps), 2] download instead of
        2 x num_segments device-to-host copies. Returns
        {task_ref: (distance, end)}."""
        if self._pending is None:
            return {}
        packed, plan, segments = self._pending
        self._pending = None
        packed = np.asarray(packed)
        results = {}
        offset = 0
        for (kind, _w, _n, cap), seg in zip(plan, segments):
            block = packed[offset : offset + cap]
            offset += cap
            for row, ref in enumerate(seg.task_refs):
                results[ref] = (int(block[row, 0]), int(block[row, 1]))
        return results


def _segment_device_args(seg: _Segment, cap: int, num_walks: int):
    from .resident import addr_arrays

    count = len(seg.win_starts)

    def pad(values, fill, dtype=np.int64):
        out = np.full(cap, fill, dtype=dtype)
        out[:count] = values
        return out

    win_starts = pad(seg.win_starts, 0)
    # padding rows: window length 0 => masked out (never eligible),
    # distance = pattern length. banded pad rows need 0 < budget < m.
    win_lens = pad(seg.win_lens, 0)
    pat_starts = pad(seg.pat_starts, 0)
    pat_lens = pad(seg.pat_lens, 2)
    budgets = pad(seg.budgets, 1)
    walk_slots = pad(seg.walk_slots, num_walks, np.int32)

    win_word0, win_phase = addr_arrays(win_starts)
    pat_word0, pat_phase = addr_arrays(pat_starts)
    stream_word0, stream_phase = addr_arrays(
        np.asarray(pat_starts, dtype=np.int64)
        + np.asarray(budgets, dtype=np.int64)
    )
    # one [cap, NUM_COLS] int32 block per segment; all segments
    # concatenate into a single task-table upload instead of ~10 arrays
    # per segment as separate transfers
    block = np.empty((cap, NUM_COLS), dtype=np.int32)
    block[:, COL_WIN_WORD0] = win_word0
    block[:, COL_WIN_PHASE] = win_phase
    block[:, COL_WIN_LEN] = win_lens
    block[:, COL_PAT_WORD0] = pat_word0
    block[:, COL_PAT_PHASE] = pat_phase
    block[:, COL_STREAM_WORD0] = stream_word0
    block[:, COL_STREAM_PHASE] = stream_phase
    block[:, COL_PAT_LEN] = pat_lens
    block[:, COL_BUDGET] = budgets
    block[:, COL_WALK] = walk_slots
    return block


def replay_plan(plan, num_walks: int, ref_words: int, query_words: int):
    """Warm-shape replay hook (warm_shapes.py): dispatch one all-pad fused
    program of the recorded plan so its first-execution cost is paid on
    the warmup thread, not the first wave. Returns the async outputs."""
    import jax.numpy as _jnp

    class _Bank:
        def __init__(self, n):
            self.flat = _jnp.zeros(n, dtype=_jnp.uint32)

    plan = tuple(tuple(seg) for seg in plan)
    _DISPATCHED_PLANS.add((plan, num_walks))
    table = jnp.asarray(np.concatenate([
        _segment_device_args(_Segment(kind), cap, num_walks)
        for kind, _w, _n, cap in plan
    ], axis=0))
    packed = _fused_call(
        _Bank(ref_words).flat,
        _Bank(query_words).flat,
        table,
        plan=plan,
        num_walks=num_walks,
    )
    return (packed,)


@functools.partial(jax.jit, static_argnames=("plan", "num_walks"))
def _fused_call(ref_flat, bank_flat, table, plan, num_walks):
    """The whole wave as one XLA program: per segment, permute alive tasks
    to the front, zero dead tasks' window lengths (the kernels' dynamic
    column bounds then skip them), run the matching Myers kernel, scatter
    verdicts into the aliveness vector. `table` is the single
    [sum(caps), NUM_COLS] int32 task table (one upload)."""
    from .resident import _resident_banded_call_core, _resident_full_core

    # slot num_walks is the sink for padding rows: always dead
    alive = jnp.ones((num_walks + 1,), dtype=jnp.int32)
    alive = alive.at[num_walks].set(0)

    _COLS = {
        "win_word0": COL_WIN_WORD0, "win_phase": COL_WIN_PHASE,
        "win_len": COL_WIN_LEN, "pat_word0": COL_PAT_WORD0,
        "pat_phase": COL_PAT_PHASE, "stream_word0": COL_STREAM_WORD0,
        "stream_phase": COL_STREAM_PHASE, "pat_len": COL_PAT_LEN,
        "budget": COL_BUDGET, "walk": COL_WALK,
    }
    out_dists = []
    out_ends = []
    offset = 0
    for kind, shape_words, n_chars, cap in plan:
        block = table[offset : offset + cap]  # static slice per segment
        offset += cap
        args = {name: block[:, col] for name, col in _COLS.items()}
        a = alive[args["walk"]]  # [cap] 0/1
        # stable compaction: alive tasks first, dead tasks (window length
        # 0) after them
        perm = jnp.argsort(1 - a, stable=True)
        a_p = a[perm]
        masked_win_len = jnp.where(a_p == 1, args["win_len"][perm], 0)

        def g(name, _perm=perm):
            return args[name][_perm]

        if kind == KIND_BANDED:
            dist_p, end_p = _resident_banded_call_core(
                ref_flat,
                bank_flat,
                g("win_word0"),
                g("win_phase"),
                masked_win_len,
                g("pat_word0"),
                g("pat_phase"),
                g("stream_word0"),
                g("stream_phase"),
                g("pat_len"),
                g("budget"),
                band_words=shape_words,
                num_text=n_chars,
            )
            dist_p, end_p = dist_p[:, 0], end_p[:, 0]
        else:
            dist_p, end_p = _resident_full_core(
                ref_flat,
                bank_flat,
                g("win_word0"),
                g("win_phase"),
                masked_win_len,
                g("pat_word0"),
                g("pat_phase"),
                g("pat_len"),
                num_words=shape_words,
                num_text=n_chars,
            )
        inv = jnp.zeros(cap, dtype=jnp.int32).at[perm].set(
            jnp.arange(cap, dtype=jnp.int32)
        )
        dist = dist_p[inv]
        end = end_p[inv]
        ok = ((dist <= args["budget"]) & (a == 1)).astype(jnp.int32)
        alive = alive.at[args["walk"]].min(ok)
        out_dists.append(dist)
        out_ends.append(end)
    return jnp.stack(
        [jnp.concatenate(out_dists), jnp.concatenate(out_ends)], axis=1
    )
