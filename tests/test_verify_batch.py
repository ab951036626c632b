"""Batched verification engine vs the sequential reference-semantics verifier
on randomized workloads — byte-identical alignments required."""

import numpy as np
import pytest

from floxer_tpu.index.fmindex import FmIndex
from floxer_tpu.intervals import create_verified_intervals_per_reference
from floxer_tpu.io.sequence_io import QueryRecord
from floxer_tpu.alphabet import reverse_complement
from floxer_tpu.ops.dp_reference import Orientation
from floxer_tpu.pex import BuildStrategy, build_pex_tree
from floxer_tpu.search_host import (
    AnchorChoiceStrategy,
    AnchorGroupOrder,
    SearchConfig,
    Searcher,
)
from floxer_tpu.verify import (
    QueryAlignments,
    QueryVerifier,
    ReferenceRecord,
    VerificationKind,
)
from floxer_tpu.verify_batch import BatchVerifier, _QueryItem


def _make_workload(seed, num_queries=6, read_len=60, k=4, seed_errors=1):
    rng = np.random.default_rng(seed)
    references = [
        ReferenceRecord("ref0", rng.integers(1, 5, size=800).astype(np.uint8), 0),
        ReferenceRecord("ref1", rng.integers(1, 5, size=400).astype(np.uint8), 1),
    ]
    index = FmIndex([r.rank_sequence for r in references])
    searcher = Searcher(
        index,
        len(references),
        SearchConfig(
            max_num_anchors_hard=500,
            max_num_anchors_soft=50,
            anchor_group_order=AnchorGroupOrder.COUNT_FIRST,
            anchor_choice_strategy=AnchorChoiceStrategy.ROUND_ROBIN,
            erase_useless_anchors=True,
        ),
    )

    items = []
    for qi in range(num_queries):
        ref = references[qi % 2]
        start = int(rng.integers(0, len(ref.rank_sequence) - read_len))
        read = ref.rank_sequence[start : start + read_len].copy()
        for _ in range(int(rng.integers(0, k))):
            pos = int(rng.integers(0, read_len))
            read[pos] = 1 + (read[pos] % 4)
        record = QueryRecord(
            id=f"q{qi}",
            rank_sequence=read,
            reverse_complement_rank_sequence=reverse_complement(read),
            quality="I" * read_len,
            internal_id=qi,
        )
        tree = build_pex_tree(read_len, k, seed_errors, BuildStrategy.RECURSIVE)
        seeds = tree.generate_seeds(1)
        fwd = searcher.search_seeds(seeds, record.rank_sequence)
        rc = searcher.search_seeds(
            seeds, record.reverse_complement_rank_sequence
        )
        items.append(_QueryItem(record, tree, fwd, rc))
    return references, items


def _run_sequential(references, items, kind, ratio, without_cigar, interval_opt):
    out = []
    for item in items:
        alignments = QueryAlignments(len(references))
        for orientation, result in (
            (Orientation.FORWARD, item.forward_result),
            (Orientation.REVERSE_COMPLEMENT, item.rc_result),
        ):
            query = (
                item.query_record.rank_sequence
                if orientation == Orientation.FORWARD
                else item.query_record.reverse_complement_rank_sequence
            )
            caches = create_verified_intervals_per_reference(
                len(references), interval_opt
            )
            for anchor in result.iter_anchors():
                QueryVerifier(
                    pex_tree=item.pex_tree,
                    anchor=anchor,
                    pex_leaf_node=item.pex_tree.leaves[anchor.pex_leaf_index],
                    query=query,
                    orientation=orientation,
                    reference=references[anchor.reference_id],
                    kind=kind,
                    already_verified_intervals=caches[anchor.reference_id],
                    extra_verification_ratio=ratio,
                    without_cigar=without_cigar,
                    alignments=alignments,
                ).verify()
        out.append(alignments)
    return out


def _as_tuples(alignments: QueryAlignments):
    return [
        [
            (a.start_in_reference, a.num_errors, a.orientation, tuple(a.cigar))
            for a in per_ref
        ]
        for per_ref in alignments.per_reference
    ]


@pytest.mark.parametrize("interval_opt", [False, True])
@pytest.mark.parametrize("without_cigar", [False, True])
@pytest.mark.parametrize(
    "kind", [VerificationKind.HIERARCHICAL, VerificationKind.DIRECT_FULL]
)
@pytest.mark.parametrize("use_device", [False, True])
def test_batch_matches_sequential(interval_opt, without_cigar, kind, use_device):
    references, items = _make_workload(seed=42)
    ratio = 0.3
    want = _run_sequential(
        references, items, kind, ratio, without_cigar, interval_opt
    )
    verifier = BatchVerifier(
        references,
        kind=kind,
        extra_verification_ratio=ratio,
        without_cigar=without_cigar,
        use_interval_optimization=interval_opt,
        use_device=use_device,
    )
    got = verifier.process(items)
    for qi, (w, g) in enumerate(zip(want, got)):
        assert _as_tuples(w) == _as_tuples(g), f"query {qi}"
        assert w.best_num_errors == g.best_num_errors


@pytest.mark.parametrize("seed", [1, 7])
def test_batch_matches_sequential_more_seeds(seed):
    references, items = _make_workload(seed=seed, num_queries=4, k=6)
    want = _run_sequential(
        references, items, VerificationKind.HIERARCHICAL, 0.05, False, True
    )
    got = BatchVerifier(
        references,
        kind=VerificationKind.HIERARCHICAL,
        extra_verification_ratio=0.05,
        without_cigar=False,
        use_interval_optimization=True,
        use_device=True,
    ).process(items)
    for w, g in zip(want, got):
        assert _as_tuples(w) == _as_tuples(g)


@pytest.mark.parametrize("without_cigar", [False, True])
def test_batch_matches_sequential_forced_banded(monkeypatch, without_cigar):
    """Route every eligible task through the banded kernel (interpret mode)
    and assert byte-equality with the sequential full-DP verifier — the
    CPU-side equivalence check for the banded dispatch path."""
    import floxer_tpu.verify_batch as vb

    monkeypatch.setattr(vb, "_FORCE_BANDED", True)
    references, items = _make_workload(seed=3, num_queries=4, read_len=80, k=6)
    want = _run_sequential(
        references, items, VerificationKind.HIERARCHICAL, 0.05,
        without_cigar, True
    )
    got = BatchVerifier(
        references,
        kind=VerificationKind.HIERARCHICAL,
        extra_verification_ratio=0.05,
        without_cigar=without_cigar,
        use_interval_optimization=True,
        use_device=True,
    ).process(items)
    for qi, (w, g) in enumerate(zip(want, got)):
        assert _as_tuples(w) == _as_tuples(g), f"query {qi}"


def test_deadline_check_aborts_between_waves():
    """An expired deadline raises VerificationTimeout at the first wave
    boundary (per-task timeout parity, parallelization.cpp:66,203)."""
    from floxer_tpu.verify_batch import VerificationTimeout

    references, items = _make_workload(321)
    calls = []

    def expired():
        calls.append(1)
        return True

    verifier = BatchVerifier(
        references,
        kind=VerificationKind.HIERARCHICAL,
        extra_verification_ratio=0.05,
        without_cigar=False,
        use_interval_optimization=True,
        use_device=False,
        deadline_check=expired,
    )
    with pytest.raises(VerificationTimeout):
        verifier.process(items)
    assert calls, "deadline_check was never consulted"


def test_deadline_check_unexpired_is_neutral():
    references, items = _make_workload(321)
    want = BatchVerifier(
        references,
        kind=VerificationKind.HIERARCHICAL,
        extra_verification_ratio=0.05,
        without_cigar=False,
        use_interval_optimization=True,
        use_device=False,
    ).process(items)
    got = BatchVerifier(
        references,
        kind=VerificationKind.HIERARCHICAL,
        extra_verification_ratio=0.05,
        without_cigar=False,
        use_interval_optimization=True,
        use_device=False,
        deadline_check=lambda: False,
    ).process(items)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert _as_tuples(w) == _as_tuples(g)


@pytest.mark.parametrize("interval_opt", [False, True])
@pytest.mark.parametrize("without_cigar", [False, True])
@pytest.mark.parametrize(
    "kind", [VerificationKind.HIERARCHICAL, VerificationKind.DIRECT_FULL]
)
def test_fused_wave_matches_sequential(
    monkeypatch, interval_opt, without_cigar, kind
):
    """The one-dispatch fused wave path (ops/fused_verify.py, interpret
    mode on CPU) is byte-identical to the sequential verifier — resident
    banks + forced fused routing."""
    import floxer_tpu.verify_batch as vb
    from floxer_tpu.ops.resident import ResidentBank

    monkeypatch.setattr(vb, "_FORCE_FUSED", True)
    references, items = _make_workload(seed=42)
    ratio = 0.3
    want = _run_sequential(
        references, items, kind, ratio, without_cigar, interval_opt
    )
    verifier = BatchVerifier(
        references,
        kind=kind,
        extra_verification_ratio=ratio,
        without_cigar=without_cigar,
        use_interval_optimization=interval_opt,
        use_device=True,
        resident_ref=ResidentBank([r.rank_sequence for r in references]),
    )
    got = verifier.process(items)
    assert verifier._fused_dispatches > 0, "fused path never dispatched"
    for qi, (w, g) in enumerate(zip(want, got)):
        assert _as_tuples(w) == _as_tuples(g), f"query {qi}"
        assert w.best_num_errors == g.best_num_errors


@pytest.mark.parametrize("seed", [1, 7, 13])
def test_fused_wave_matches_sequential_more_seeds(monkeypatch, seed):
    import floxer_tpu.verify_batch as vb
    from floxer_tpu.ops.resident import ResidentBank

    monkeypatch.setattr(vb, "_FORCE_FUSED", True)
    references, items = _make_workload(seed=seed, num_queries=4, k=6)
    want = _run_sequential(
        references, items, VerificationKind.HIERARCHICAL, 0.05, False, True
    )
    verifier = BatchVerifier(
        references,
        kind=VerificationKind.HIERARCHICAL,
        extra_verification_ratio=0.05,
        without_cigar=False,
        use_interval_optimization=True,
        use_device=True,
        resident_ref=ResidentBank([r.rank_sequence for r in references]),
    )
    got = verifier.process(items)
    assert verifier._fused_dispatches > 0
    for w, g in zip(want, got):
        assert _as_tuples(w) == _as_tuples(g)


def test_fused_split_wave_matches_sequential(monkeypatch):
    """Cost-model SPLIT routing: part of a wave runs as an async fused
    device dispatch while the host engine computes the rest concurrently
    — byte-identical to the sequential verifier, with both shares
    actually exercised."""
    import floxer_tpu.verify_batch as vb
    from floxer_tpu.ops.resident import ResidentBank

    # steer the router into a mid-range device share (and neutralize an
    # ambient FLOXER_TPU_FORCE_FUSED, which would force all-device)
    monkeypatch.setattr(vb, "_FORCE_FUSED", False)
    monkeypatch.setattr(vb, "_fused_call_overhead", lambda: 0.0)
    monkeypatch.setattr(vb, "_PROBE_MIN_HOST_S", 0.0)
    monkeypatch.setitem(vb._BAND_RATES, "host", 1e9)
    monkeypatch.setitem(vb._BAND_RATES, "device", 1.5e9)  # pf/dev == 1/host
    # pin: calibration must not move the steered rates mid-test
    monkeypatch.setitem(vb._BAND_RATES, "host_pinned", True)
    monkeypatch.setitem(vb._BAND_RATES, "device_pinned", True)
    monkeypatch.setattr(vb, "_FUSED_MIN_DEVICE_CELLS", 0.0)
    monkeypatch.setattr(vb, "_FUSED_NEW_PLAN_MIN_WALKS", 0)

    references, items = _make_workload(seed=42)
    want = _run_sequential(
        references, items, VerificationKind.HIERARCHICAL, 0.3, False, True
    )
    verifier = BatchVerifier(
        references,
        kind=VerificationKind.HIERARCHICAL,
        extra_verification_ratio=0.3,
        without_cigar=False,
        use_interval_optimization=True,
        use_device=lambda: True,  # resolved-callable: cost model stays on
        resident_ref=ResidentBank([r.rank_sequence for r in references]),
    )
    splits = []
    original = vb.BatchVerifier._compute_walks_flat

    def spy(self, walks, items_, subset, max_depth=None):
        splits.append(list(subset))
        return original(self, walks, items_, subset, max_depth=max_depth)

    monkeypatch.setattr(vb.BatchVerifier, "_compute_walks_flat", spy)
    got = verifier.process(items)
    assert verifier._fused_dispatches > 0, "device share never dispatched"
    assert splits, "host share never computed"
    for qi, (w, g) in enumerate(zip(want, got)):
        assert _as_tuples(w) == _as_tuples(g), f"query {qi}"


def test_band_rate_calibration(monkeypatch):
    """Self-calibrating router rates: observed (cells, seconds) samples
    EWMA toward the measured rate, outliers and pinned rates are ignored
    (VERDICT r3 item 8: the cost model must adapt to the attachment
    instead of trusting env-pinned constants)."""
    import floxer_tpu.verify_batch as vb

    monkeypatch.setitem(vb._BAND_RATES, "host", 26e9)
    monkeypatch.setitem(vb._BAND_RATES, "host_pinned", False)
    monkeypatch.setitem(vb._BAND_RATES, "device", 90e9)
    monkeypatch.setitem(vb._BAND_RATES, "device_pinned", False)

    # a measured 100 Gcells/s/thread host sample pulls the estimate up
    vb._observe_host_band_rate(cells=4e9, seconds=0.04, threads=1)
    assert 40e9 < vb._BAND_RATES["host"] < 100e9
    # repeated samples converge toward the observed rate
    for _ in range(20):
        vb._observe_host_band_rate(cells=4e9, seconds=0.04, threads=1)
    assert vb._BAND_RATES["host"] == pytest.approx(100e9, rel=0.01)

    # absurd samples (timer glitch: 10 Tcells/s) are dropped
    before = vb._BAND_RATES["host"]
    vb._observe_host_band_rate(cells=1e12, seconds=1e-4 + 1e-6, threads=1)
    assert vb._BAND_RATES["host"] == before
    # sub-threshold work (noise) is dropped
    vb._observe_host_band_rate(cells=1e6, seconds=0.5, threads=1)
    assert vb._BAND_RATES["host"] == before

    # device: an observed 300 Gcells/s kernel raises the estimate
    for _ in range(20):
        vb._observe_device_band_rate(padded_cells=3e9, kernel_seconds=0.01)
    assert vb._BAND_RATES["device"] == pytest.approx(300e9, rel=0.01)

    # pinned rates never move
    monkeypatch.setitem(vb._BAND_RATES, "host_pinned", True)
    pinned = vb._BAND_RATES["host"]
    vb._observe_host_band_rate(cells=4e9, seconds=0.4, threads=1)
    assert vb._BAND_RATES["host"] == pinned


def test_effective_host_rate_split_and_renormalization(monkeypatch):
    """Separated EWMAs + de-hysteresis (advisor r4 / VERDICT r4 item 8):
    effective fused-wave samples must not touch the physical banded-bucket
    rate, and fully-host waves keep feeding effective samples (via
    _observe_host_wave) so a composition shift re-normalizes the rate in
    either direction within a few waves — the continuous-observation form
    of de-hysteresis. (An unconditional decay toward physical was tried
    and reverted: on genuinely early-exit-heavy workloads the inflation
    is the correct signal, and decaying it re-engaged the device at a
    measured 2x end-to-end loss on hg38.)"""
    import floxer_tpu.verify_batch as vb

    monkeypatch.setitem(vb._BAND_RATES, "host", 26e9)
    monkeypatch.setitem(vb._BAND_RATES, "host_effective", 26e9)
    monkeypatch.setitem(vb._BAND_RATES, "host_pinned", False)

    # early-exit-heavy fused waves: effective rate hundreds of times
    # physical (the hg38-observed regime, exaggerated)
    for _ in range(30):
        vb._observe_host_band_rate(
            cells=5e13, seconds=0.1, threads=2, effective=True
        )
    assert vb._BAND_RATES["host_effective"] > 1e12
    # ... but the PHYSICAL banded-bucket rate is untouched
    assert vb._BAND_RATES["host"] == 26e9
    # and a physical-range update does not touch the effective rate
    eff_before = vb._BAND_RATES["host_effective"]
    vb._observe_host_band_rate(cells=4e9, seconds=0.04, threads=1)
    assert vb._BAND_RATES["host_effective"] == eff_before
    assert vb._BAND_RATES["host"] > 26e9

    # composition shifts back (few early exits): fully-host-wave samples
    # near physical pull the inflated rate down within ~8 waves — the
    # log-space EWMA makes multi-order swings symmetric
    verifier = object.__new__(vb.BatchVerifier)
    for _ in range(8):
        verifier._host_wave_estimate = 8e9  # full-chain estimate
        verifier._observe_host_wave(0.08)  # ~5e10/thread observed
    assert vb._BAND_RATES["host_effective"] < 4e11
    # ... and consuming the estimate resets it (no double observation)
    assert verifier._host_wave_estimate == 0.0
    before = vb._BAND_RATES["host_effective"]
    verifier._observe_host_wave(0.08)
    assert vb._BAND_RATES["host_effective"] == before

    # env pin disables the dynamics entirely
    monkeypatch.setitem(vb._BAND_RATES, "host_pinned", True)
    monkeypatch.setitem(vb._BAND_RATES, "host", 1e9)
    monkeypatch.setitem(vb._BAND_RATES, "host_effective", 5e9)
    assert vb._host_chain_rate() == 1e9


def test_direct_attached_routes_all_device(monkeypatch):
    """Direct-attached card simulation: with per-call overhead pinned to
    ~1 ms and a calibrated device rate far above the host rate, the router
    engages the device and sends it (essentially) the whole wave. The
    residual host share is the SPLIT optimizer's free concurrency (host
    threads run while the device executes), not pricing-out; with
    hundred-Mcell waves the host share converges to the same few
    percent."""
    import floxer_tpu.verify_batch as vb
    from floxer_tpu.ops.resident import ResidentBank

    monkeypatch.setattr(vb, "_FORCE_FUSED", False)
    # ~1 ms per-call overhead: a direct-attached chip
    monkeypatch.setattr(vb, "_fused_call_overhead", lambda: 0.001)
    monkeypatch.setattr(vb, "_PROBE_MIN_HOST_S", 0.0)
    monkeypatch.setattr(vb, "_FUSED_MIN_DEVICE_CELLS", 0.0)
    monkeypatch.setattr(vb, "_FUSED_NEW_PLAN_MIN_WALKS", 0)
    # rates as calibration would discover them on a direct attachment,
    # scaled so the test's tiny wave occupies the same (host_s >> overhead)
    # regime as a production wave: device far faster than one host thread
    monkeypatch.setitem(vb._BAND_RATES, "host", 1e6)
    monkeypatch.setitem(vb._BAND_RATES, "device", 1e12)
    monkeypatch.setitem(vb._BAND_RATES, "host_pinned", True)
    monkeypatch.setitem(vb._BAND_RATES, "device_pinned", True)

    references, items = _make_workload(seed=42)
    verifier = BatchVerifier(
        references,
        kind=VerificationKind.HIERARCHICAL,
        extra_verification_ratio=0.3,
        without_cigar=False,
        use_interval_optimization=True,
        use_device=lambda: True,
        resident_ref=ResidentBank([r.rank_sequence for r in references]),
    )
    host_walks = []
    device_walks = []
    original_flat = vb.BatchVerifier._compute_walks_flat
    original_fused = vb.BatchVerifier._try_fused_wave

    def spy_flat(self, walks, items_, subset, max_depth=None):
        host_walks.extend(subset)
        return original_flat(
            self, walks, items_, subset, max_depth=max_depth
        )

    def spy_fused(self, walks, items_, subset, *args, **kwargs):
        device_walks.extend(subset)
        return original_fused(self, walks, items_, subset, *args, **kwargs)

    monkeypatch.setattr(vb.BatchVerifier, "_compute_walks_flat", spy_flat)
    monkeypatch.setattr(vb.BatchVerifier, "_try_fused_wave", spy_fused)
    verifier.process(items)
    assert verifier._fused_dispatches > 0, "device never engaged"
    total = len(set(device_walks)) or 1
    host_fraction = len(set(host_walks)) / total
    assert host_fraction <= 0.1, (
        f"host got {host_fraction:.0%} of the wave on a direct chip"
    )
