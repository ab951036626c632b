"""PEX hierarchical verification.

Parity target: src/lib/verification.cpp. For each anchor, walk from the
anchor's PEX leaf's parent up to the root; at each node compute the reference
span implied by the anchor and align that node's query slice against it with
the node's error budget. Stop early on failure; root alignments are recorded
(with CIGAR unless --without-cigar) and root spans enter the
verified-interval cache.

Span math (compute_reference_span_start_and_length, verification.cpp:157-184,
pinned by verification_test.cpp:126-161):

    base_length = node_span_length + 2 * node_errors + 1
    extra       = float_aware_ceil(base_length * extra_verification_ratio)
    start       = clamp(anchor_pos - (leaf_from - node_from) - node_errors
                        - extra, 0)
    length      = min(base_length + 2 * extra, reference_length - start)

The alignment calls go through a pluggable engine so the device pipeline can
batch them (ops/dp_reference for the host oracle, the Myers kernels of
ops/ on the device).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from .intervals import HalfOpenInterval, VerifiedIntervals
from .ops.dp_reference import (
    AlignmentMode,
    AlignmentResult,
    Orientation,
    QueryAlignment,
    align_semi_global,
)
from .pex import PexNode, PexTree
from .search_host import Anchor
from .utils.mathutils import float_aware_ceil

# reference spans at most this long skip the re-check of the interval cache
# right before aligning (verification.cpp:85-92)
MAX_REF_SPAN_LENGTH_WITHOUT_CHECKING_INTERVALS = 512


class VerificationKind(enum.Enum):
    DIRECT_FULL = "direct_full"
    HIERARCHICAL = "hierarchical"


@dataclass(frozen=True)
class SpanConfig:
    offset: int
    length: int
    applied_extra_verification_length_per_side: int

    def as_half_open_interval(self) -> HalfOpenInterval:
        return HalfOpenInterval(self.offset, self.offset + self.length)


def compute_reference_span(
    anchor: Anchor,
    pex_node: PexNode,
    leaf_query_index_from: int,
    full_reference_length: int,
    extra_verification_ratio: float,
) -> SpanConfig:
    """verification.cpp:157-184."""
    base_length = pex_node.length_of_query_span + 2 * pex_node.num_errors + 1
    extra = float_aware_ceil(base_length * extra_verification_ratio)
    start_signed = (
        anchor.reference_position
        - (leaf_query_index_from - pex_node.query_index_from)
        - pex_node.num_errors
        - extra
    )
    start = max(start_signed, 0)
    length = min(base_length + 2 * extra, full_reference_length - start)
    return SpanConfig(start, length, extra)


@dataclass
class QueryAlignments:
    """All alignments of one query to all references (alignment.hpp:28-51)."""

    num_references: int
    per_reference: list[list[QueryAlignment]] = field(default_factory=list)
    best_num_errors: int | None = None

    def __post_init__(self):
        if not self.per_reference:
            self.per_reference = [[] for _ in range(self.num_references)]

    def insert(self, alignment: QueryAlignment, reference_id: int) -> None:
        if self.best_num_errors is None or alignment.num_errors < self.best_num_errors:
            self.best_num_errors = alignment.num_errors
        self.per_reference[reference_id].append(alignment)

    def size(self) -> int:
        return sum(len(a) for a in self.per_reference)

    def merge_other_into_this(self, other: "QueryAlignments") -> None:
        for reference_id, alignments in enumerate(other.per_reference):
            for alignment in alignments:
                self.insert(alignment, reference_id)


@dataclass
class ReferenceRecord:
    id: str
    rank_sequence: np.ndarray
    internal_id: int


class QueryVerifier:
    """Parity: verification::query_verifier (verification.hpp:22-48)."""

    def __init__(
        self,
        pex_tree: PexTree,
        anchor: Anchor,
        pex_leaf_node: PexNode,
        query: np.ndarray,
        orientation: Orientation,
        reference: ReferenceRecord,
        kind: VerificationKind,
        already_verified_intervals: VerifiedIntervals,
        extra_verification_ratio: float,
        without_cigar: bool,
        alignments: QueryAlignments,
        stats=None,
    ):
        self.pex_tree = pex_tree
        self.anchor = anchor
        self.pex_leaf_node = pex_leaf_node
        self.query = query
        self.orientation = orientation
        self.reference = reference
        self.kind = kind
        self.already_verified_intervals = already_verified_intervals
        self.extra_verification_ratio = extra_verification_ratio
        self.without_cigar = without_cigar
        self.alignments = alignments
        self.stats = stats

    def verify(self) -> None:
        if self.kind == VerificationKind.DIRECT_FULL:
            self._direct_full_verification()
        elif self.kind == VerificationKind.HIERARCHICAL:
            self._hierarchical_verification()
        else:  # pragma: no cover
            raise ValueError("unknown verification kind")

    # ------------------------------------------------------------------

    def _root_span_config(self) -> SpanConfig:
        return compute_reference_span(
            self.anchor,
            self.pex_tree.root,
            self.pex_leaf_node.query_index_from,
            len(self.reference.rank_sequence),
            self.extra_verification_ratio,
        )

    def _root_was_already_verified(self) -> bool:
        """verification.cpp:119-136: the lookup trims the extra margin."""
        span = self._root_span_config()
        trimmed = span.as_half_open_interval().trim_from_both_sides(
            span.applied_extra_verification_length_per_side
        )
        if self.already_verified_intervals.contains(trimmed):
            if self.stats is not None:
                self.stats.add_reference_span_size_avoided_root(span.length)
            return True
        return False

    def _direct_full_verification(self) -> None:
        if self._root_was_already_verified():
            return
        span = self._root_span_config()
        self._try_to_align_node(self.pex_tree.root, span)
        self.already_verified_intervals.insert(span.as_half_open_interval())

    def _hierarchical_verification(self) -> None:
        if self._root_was_already_verified():
            return

        root_span = self._root_span_config()

        # whole tree is a single root leaf (verification.cpp:52-71)
        if self.pex_leaf_node.is_root:
            self._try_to_align_node(self.pex_leaf_node, root_span)
            self.already_verified_intervals.insert(root_span.as_half_open_interval())
            return

        curr_node = self.pex_tree.parent_of(self.pex_leaf_node)
        while True:
            span = compute_reference_span(
                self.anchor,
                curr_node,
                self.pex_leaf_node.query_index_from,
                len(self.reference.rank_sequence),
                self.extra_verification_ratio if curr_node.is_root else 0.0,
            )

            # another batch lane/thread may have verified it meanwhile
            if (
                span.length > MAX_REF_SPAN_LENGTH_WITHOUT_CHECKING_INTERVALS
                and self._root_was_already_verified()
            ):
                return

            exists = self._try_to_align_node(curr_node, span)

            if curr_node.is_root:
                self.already_verified_intervals.insert(span.as_half_open_interval())

            if not exists or curr_node.is_root:
                break
            curr_node = self.pex_tree.parent_of(curr_node)

    def _try_to_align_node(self, pex_node: PexNode, span: SpanConfig) -> bool:
        """verification.cpp:186-245: inner nodes are existence-only, roots
        return a full alignment (with CIGAR unless without_cigar)."""
        node_query = self.query[
            pex_node.query_index_from : pex_node.query_index_to + 1
        ]
        reference_span = self.reference.rank_sequence[
            span.offset : span.offset + span.length
        ]

        if pex_node.is_root:
            mode = (
                AlignmentMode.WITHOUT_CIGAR
                if self.without_cigar
                else AlignmentMode.WITH_CIGAR
            )
        else:
            mode = AlignmentMode.ONLY_VERIFY_EXISTENCE

        result: AlignmentResult = align_semi_global(
            reference_span,
            node_query,
            num_allowed_errors=pex_node.num_errors,
            orientation=self.orientation,
            mode=mode,
            reference_span_offset=span.offset,
        )

        if result.alignment is not None:
            assert pex_node.is_root
            self.alignments.insert(result.alignment, self.reference.internal_id)

        if self.stats is not None:
            if pex_node.is_root:
                self.stats.add_reference_span_size_aligned_root(span.length)
            else:
                self.stats.add_reference_span_size_aligned_inner_node(span.length)

        return result.exists
