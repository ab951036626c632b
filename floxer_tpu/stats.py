"""Search and alignment statistics (histograms + counters).

Parity target: include/statistics.hpp + src/lib/statistics.cpp: one counter
(completely excluded queries) and 18 named threshold histograms with
min/mean/max, two hardcoded binning profiles selected by --stats-input-hint
(real_nanopore default / simulated, statistics.cpp:9-61), TOML or terminal
output. In the batched pipeline the per-batch histogram updates are plain numpy
reductions on host; across hosts the arrays merge with a psum.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def linear_range(num_steps: int, maximum: int) -> list[int]:
    """statistics.cpp:461-468."""
    return [i * maximum // num_steps for i in range(num_steps)]


def _configs(input_hint: str) -> dict[str, list[int]]:
    if input_hint in ("", "real_nanopore"):
        practical_query_length = linear_range(30, 150_000)
        practical_anchor = linear_range(30, 30_000)
        edit_distance = linear_range(30, 3_000)
        practical_time = linear_range(30, 20_000)
    elif input_hint == "simulated":
        practical_query_length = linear_range(30, 10_000)
        practical_anchor = linear_range(30, 1_000)
        edit_distance = linear_range(30, 1_000)
        practical_time = linear_range(30, 3_000)
    else:
        raise ValueError("unknown stats input hint")
    return {
        "small": linear_range(30, 100),
        "medium": linear_range(30, 1000),
        "tiny": [0, 1, 2, 3, 4],
        "query_length": practical_query_length,
        "anchor": practical_anchor,
        "kept_anchor_per_seed": linear_range(30, 200),
        "edit_distance": edit_distance,
        "time": practical_time,
    }


@dataclass
class Histogram:
    name: str
    thresholds: list[int]
    data: list[int] = field(default_factory=list)
    num_values: int = 0
    min_value: int = 2**62
    max_value: int = 0
    total: int = 0

    def __post_init__(self):
        if not self.data:
            self.data = [0] * (len(self.thresholds) + 1)

    def add_value(self, value: int) -> None:
        self.num_values += 1
        self.min_value = min(self.min_value, value)
        self.max_value = max(self.max_value, value)
        self.total += value
        for i, threshold in enumerate(self.thresholds):
            if value <= threshold:
                self.data[i] += 1
                return
        self.data[-1] += 1

    def add_values(self, values) -> None:
        """Vectorized add_value over a numpy array (same bucketing: the
        first threshold with value <= threshold)."""
        import numpy as np

        values = np.asarray(values)
        if values.size == 0:
            return
        self.num_values += int(values.size)
        self.min_value = min(self.min_value, int(values.min()))
        self.max_value = max(self.max_value, int(values.max()))
        self.total += int(values.sum())
        bins = np.searchsorted(np.asarray(self.thresholds), values, "left")
        counts = np.bincount(bins, minlength=len(self.data))
        for i, c in enumerate(counts.tolist()):
            self.data[i] += c

    def merge_with(self, other: "Histogram") -> None:
        assert self.thresholds == other.thresholds
        self.num_values += other.num_values
        self.min_value = min(self.min_value, other.min_value)
        self.max_value = max(self.max_value, other.max_value)
        self.total += other.total
        for i in range(len(self.data)):
            self.data[i] += other.data[i]

    def format_for_terminal(self) -> str:
        basic = (
            f"\nmin = {self.min_value}, mean = {self.total / self.num_values:.2f},"
            f" max = {self.max_value}"
            if self.num_values > 0
            else ""
        )
        thresholds = "\t".join(str(t) for t in self.thresholds)
        occurrences = "\t".join(str(d) for d in self.data)
        return (
            f"histogram for {self.name} (total: {self.num_values})\n"
            f"threshold:\t{thresholds}\tinf\n"
            f"occurrences:\t{occurrences}"
            f"{basic}"
        )

    def format_as_toml(self) -> str:
        name = self.name.replace(" ", "_")
        out = (
            f"[{name}]\n"
            f"num_values = {self.num_values}\n"
            f"thresholds = [{', '.join(str(t) for t in self.thresholds)}]\n"
            f"occurrences = [{', '.join(str(d) for d in self.data)}]\n"
        )
        if self.num_values > 0:
            out += (
                f"min_value = {self.min_value}\n"
                f"mean = {self.total / self.num_values:.2f}\n"
                f"max_value = {self.max_value}\n"
            )
        return out


_HISTOGRAM_LAYOUT = [
    # (name, config key) in the reference's declaration order
    # (statistics.cpp:220-245)
    ("query lengths", "query_length"),
    ("seed lengths", "small"),
    ("errors per seed", "tiny"),
    ("seeds per query", "medium"),
    ("fully excluded seeds per query", "medium"),
    ("kept anchors per query", "anchor"),
    ("excluded raw anchors by soft cap per query", "anchor"),
    ("excluded raw anchors by erase useless per query", "anchor"),
    ("kept anchors per kept seed", "kept_anchor_per_seed"),
    ("excluded raw anchors by soft cap per kept seed", "kept_anchor_per_seed"),
    ("excluded raw anchors by erase useless per kept seed", "kept_anchor_per_seed"),
    ("reference span sizes aligned of inner nodes", "query_length"),
    ("reference span sizes aligned of roots", "query_length"),
    ("reference span sizes alignment avoided of roots", "query_length"),
    ("alignments per query", "small"),
    ("alignments edit distance", "edit_distance"),
    ("milliseconds spent in search per query", "time"),
    ("milliseconds spent in verification per query", "time"),
]

_NUM_COMPLETELY_EXCLUDED_QUERIES = "completely excluded queries"


class SearchAndAlignmentStatistics:
    def __init__(self, input_hint: str = ""):
        configs = _configs(input_hint)
        self.counts: dict[str, int] = {_NUM_COMPLETELY_EXCLUDED_QUERIES: 0}
        self.histograms: dict[str, Histogram] = {
            name: Histogram(name, configs[key]) for name, key in _HISTOGRAM_LAYOUT
        }

    # -- counters / single-value adders ---------------------------------
    def increment_num_completely_excluded_queries(self):
        self.counts[_NUM_COMPLETELY_EXCLUDED_QUERIES] += 1

    def _add(self, name, value):
        self.histograms[name].add_value(value)

    def add_query_length(self, v):
        self._add("query lengths", v)

    def add_seed_length(self, v):
        self._add("seed lengths", v)

    def add_num_errors_per_seed(self, v):
        self._add("errors per seed", v)

    def add_num_seeds_per_query(self, v):
        self._add("seeds per query", v)

    def add_num_fully_excluded_seeds_per_query(self, v):
        self._add("fully excluded seeds per query", v)

    def add_num_kept_anchors_per_query(self, v):
        self._add("kept anchors per query", v)

    def add_num_excluded_raw_anchors_by_soft_cap_per_query(self, v):
        self._add("excluded raw anchors by soft cap per query", v)

    def add_num_excluded_raw_anchors_by_erase_useless_per_query(self, v):
        self._add("excluded raw anchors by erase useless per query", v)

    def add_num_kept_anchors_per_kept_seed(self, v):
        self._add("kept anchors per kept seed", v)

    def add_num_excluded_raw_anchors_by_soft_cap_per_kept_seed(self, v):
        self._add("excluded raw anchors by soft cap per kept seed", v)

    def add_num_excluded_raw_anchors_by_erase_useless_per_kept_seed(self, v):
        self._add("excluded raw anchors by erase useless per kept seed", v)

    def add_reference_span_size_aligned_inner_node(self, v):
        self._add("reference span sizes aligned of inner nodes", v)

    def add_reference_span_size_aligned_root(self, v):
        self._add("reference span sizes aligned of roots", v)

    def add_reference_span_size_avoided_root(self, v):
        self._add("reference span sizes alignment avoided of roots", v)

    def add_reference_span_sizes_avoided_root_many(self, values):
        """Vectorized bulk add (the batch verifier's avoided-root span
        lengths arrive as one numpy array per chunk)."""
        self.histograms["reference span sizes alignment avoided of roots"].add_values(
            values
        )

    def add_num_alignments(self, v):
        self._add("alignments per query", v)

    def add_alignment_edit_distance(self, v):
        self._add("alignments edit distance", v)

    def add_milliseconds_spent_in_search_per_query(self, v):
        self._add("milliseconds spent in search per query", v)

    def add_milliseconds_spent_in_verification_per_query(self, v):
        self._add("milliseconds spent in verification per query", v)

    # -- aggregate adders (statistics.cpp:279-294, 353-413) --------------
    def add_statistics_for_seeds(self, forward_seeds, reverse_complement_seeds):
        self.add_num_seeds_per_query(
            len(forward_seeds) + len(reverse_complement_seeds)
        )
        from .pex import seed_stat_arrays

        for seeds in (forward_seeds, reverse_complement_seeds):
            lengths, errors, _, _ = seed_stat_arrays(seeds)
            self.histograms["errors per seed"].add_values(errors)
            self.histograms["seed lengths"].add_values(lengths)

    def add_statistics_for_search_result(self, forward_result, rc_result):
        if hasattr(forward_result, "kept_useful") and hasattr(
            rc_result, "kept_useful"
        ):
            return self._add_statistics_for_search_result_soa(
                forward_result, rc_result
            )
        num_fully_excluded = 0
        num_kept = 0
        num_excluded_soft = 0
        num_excluded_useless = 0
        all_excluded = True
        for result in (forward_result, rc_result):
            for anchors_of_seed in result.anchors_by_seed:
                if anchors_of_seed.num_kept_useful_anchors == 0:
                    num_fully_excluded += 1
                else:
                    all_excluded = False
                    num_kept += anchors_of_seed.num_kept_useful_anchors
                    self.add_num_kept_anchors_per_kept_seed(
                        anchors_of_seed.num_kept_useful_anchors
                    )
                    num_excluded_soft += (
                        anchors_of_seed.num_excluded_raw_anchors_by_soft_cap
                    )
                    self.add_num_excluded_raw_anchors_by_soft_cap_per_kept_seed(
                        anchors_of_seed.num_excluded_raw_anchors_by_soft_cap
                    )
                    excluded_useless = (
                        anchors_of_seed.num_kept_raw_anchors
                        - anchors_of_seed.num_kept_useful_anchors
                    )
                    num_excluded_useless += excluded_useless
                    self.add_num_excluded_raw_anchors_by_erase_useless_per_kept_seed(
                        excluded_useless
                    )
        self.add_num_fully_excluded_seeds_per_query(num_fully_excluded)
        self.add_num_kept_anchors_per_query(num_kept)
        self.add_num_excluded_raw_anchors_by_soft_cap_per_query(num_excluded_soft)
        self.add_num_excluded_raw_anchors_by_erase_useless_per_query(
            num_excluded_useless
        )
        if all_excluded:
            self.increment_num_completely_excluded_queries()

    def add_search_statistics_for_chunk(self, entries, search_ms: int):
        """Chunk-level batched form of add_query_length +
        add_statistics_for_seeds + add_statistics_for_search_result +
        add_milliseconds_spent_in_search_per_query over SoA results:
        identical histogram contents, one vectorized update per histogram
        per chunk instead of ~4 calls per query x ~1k seeds.

        entries: list of (query_length, seeds, fwd SearchResultSoA,
        rc SearchResultSoA); search_ms is the chunk-averaged per-query
        search time (the batched engine's convention)."""
        import numpy as np

        from .pex import seed_stat_arrays

        if not entries:
            return
        num_queries = len(entries)
        qlens = np.fromiter(
            (e[0] for e in entries), count=num_queries, dtype=np.int64
        )
        nseeds = np.fromiter(
            (2 * len(e[1]) for e in entries), count=num_queries,
            dtype=np.int64,
        )
        self.histograms["query lengths"].add_values(qlens)
        self.histograms["seeds per query"].add_values(nseeds)
        self.histograms["milliseconds spent in search per query"].add_values(
            np.full(num_queries, search_ms, dtype=np.int64)
        )

        err_parts = []
        len_parts = []
        for _, seeds, _, _ in entries:
            lengths, errors, _, _ = seed_stat_arrays(seeds)
            err_parts.append(errors)
            len_parts.append(lengths)
        err = np.concatenate(err_parts)
        lens = np.concatenate(len_parts)
        # forward and reverse-complement seed sets are the same list: each
        # value is recorded twice (statistics.cpp:279-294 semantics)
        self.histograms["errors per seed"].add_values(err)
        self.histograms["errors per seed"].add_values(err)
        self.histograms["seed lengths"].add_values(lens)
        self.histograms["seed lengths"].add_values(lens)

        ku_parts, kr_parts, es_parts = [], [], []
        bounds = [0]
        for _, _, fwd, rc in entries:
            ku_parts += [fwd.kept_useful, rc.kept_useful]
            kr_parts += [fwd.kept_raw, rc.kept_raw]
            es_parts += [fwd.excluded_soft, rc.excluded_soft]
            bounds.append(
                bounds[-1]
                + fwd.kept_useful.shape[0]
                + rc.kept_useful.shape[0]
            )
        ku = np.concatenate(ku_parts)
        kr = np.concatenate(kr_parts)
        es = np.concatenate(es_parts)
        kept_mask = ku > 0
        kept = ku[kept_mask]
        soft_kept = es[kept_mask]
        useless_kept = (kr - ku)[kept_mask]
        self.histograms["kept anchors per kept seed"].add_values(kept)
        self.histograms[
            "excluded raw anchors by soft cap per kept seed"
        ].add_values(soft_kept)
        self.histograms[
            "excluded raw anchors by erase useless per kept seed"
        ].add_values(useless_kept)

        starts = np.asarray(bounds[:-1], dtype=np.int64)
        fully_excluded = np.add.reduceat(
            (~kept_mask).astype(np.int64), starts
        )
        kept_q = np.add.reduceat(np.where(kept_mask, ku, 0), starts)
        soft_q = np.add.reduceat(np.where(kept_mask, es, 0), starts)
        useless_q = np.add.reduceat(
            np.where(kept_mask, kr - ku, 0), starts
        )
        self.histograms["fully excluded seeds per query"].add_values(
            fully_excluded
        )
        self.histograms["kept anchors per query"].add_values(kept_q)
        self.histograms[
            "excluded raw anchors by soft cap per query"
        ].add_values(soft_q)
        self.histograms[
            "excluded raw anchors by erase useless per query"
        ].add_values(useless_q)
        self.counts[_NUM_COMPLETELY_EXCLUDED_QUERIES] += int(
            (kept_q == 0).sum()
        )

    def _add_statistics_for_search_result_soa(self, forward_result, rc_result):
        """Array fast path for SearchResultSoA results (chunk-batched
        search): identical histogram updates to the object loop above,
        computed with numpy reductions instead of ~1k per-seed calls."""
        import numpy as np

        kept_useful = np.concatenate(
            [forward_result.kept_useful, rc_result.kept_useful]
        )
        kept_raw = np.concatenate([forward_result.kept_raw, rc_result.kept_raw])
        excluded_soft = np.concatenate(
            [forward_result.excluded_soft, rc_result.excluded_soft]
        )
        kept_mask = kept_useful > 0
        num_fully_excluded = int(kept_useful.shape[0] - kept_mask.sum())
        kept = kept_useful[kept_mask]
        soft_kept = excluded_soft[kept_mask]
        useless_kept = (kept_raw - kept_useful)[kept_mask]
        self.histograms["kept anchors per kept seed"].add_values(kept)
        self.histograms[
            "excluded raw anchors by soft cap per kept seed"
        ].add_values(soft_kept)
        self.histograms[
            "excluded raw anchors by erase useless per kept seed"
        ].add_values(useless_kept)
        self.add_num_fully_excluded_seeds_per_query(num_fully_excluded)
        self.add_num_kept_anchors_per_query(int(kept.sum()))
        self.add_num_excluded_raw_anchors_by_soft_cap_per_query(
            int(soft_kept.sum())
        )
        self.add_num_excluded_raw_anchors_by_erase_useless_per_query(
            int(useless_kept.sum())
        )
        if not kept_mask.any():
            self.increment_num_completely_excluded_queries()

    # -- output ----------------------------------------------------------
    def num_queries(self) -> int:
        return self.histograms["query lengths"].num_values

    def format_for_terminal(self) -> list[str]:
        lines = [
            f"number of {name}: {value}" for name, value in self.counts.items()
        ]
        lines.extend(h.format_for_terminal() for h in self.histograms.values())
        return lines

    def format_as_toml(self) -> str:
        out = "".join(
            f"{name.replace(' ', '_')} = {value}\n"
            for name, value in self.counts.items()
        )
        out += "".join(h.format_as_toml() for h in self.histograms.values())
        return out

    def merge_other_into_this(self, other: "SearchAndAlignmentStatistics") -> None:
        for name in self.counts:
            self.counts[name] += other.counts[name]
        for name in self.histograms:
            self.histograms[name].merge_with(other.histograms[name])

    # -- collective merge (multi-host) -----------------------------------
    # The stats state splits into sum-mergeable scalars (counters, bucket
    # counts, totals) and order-statistics (min/max). to_merge_arrays
    # flattens them into three int64 vectors with a layout that is a pure
    # function of the histogram configuration, so every host produces
    # congruent vectors; apply_merged_arrays writes an allreduced triple
    # back. Used by pipeline.run via parallel.mesh.allreduce_stats — the
    # reference's global-stats mutex merge (parallelization.cpp:278-281)
    # as psum/pmin/pmax collectives.

    def to_merge_arrays(self):
        import numpy as np

        sums: list[int] = [self.counts[name] for name in sorted(self.counts)]
        mins: list[int] = []
        maxs: list[int] = []
        for name, _ in _HISTOGRAM_LAYOUT:
            hist = self.histograms[name]
            sums.extend([hist.num_values, hist.total])
            sums.extend(hist.data)
            mins.append(hist.min_value)
            maxs.append(hist.max_value)
        return (
            np.asarray(sums, dtype=np.int64),
            np.asarray(mins, dtype=np.int64),
            np.asarray(maxs, dtype=np.int64),
        )

    def apply_merged_arrays(self, sums, mins, maxs) -> None:
        cursor = 0
        for name in sorted(self.counts):
            self.counts[name] = int(sums[cursor])
            cursor += 1
        for i, (name, _) in enumerate(_HISTOGRAM_LAYOUT):
            hist = self.histograms[name]
            hist.num_values = int(sums[cursor])
            hist.total = int(sums[cursor + 1])
            cursor += 2
            width = len(hist.data)
            hist.data = [int(v) for v in sums[cursor : cursor + width]]
            cursor += width
            hist.min_value = int(mins[i])
            hist.max_value = int(maxs[i])
