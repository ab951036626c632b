"""Device-resident FM-index: batched rank / LF / locate as JAX gathers.

Device replacement for fmindex-collection's EPR-dictionary rank queries
(include/fmindex.hpp:8, queried per-cursor in search.cpp:173/253): the BWT
and its occ checkpoints live in HBM as flat arrays, and a rank query for a
whole batch of cursors is one checkpoint gather plus a masked popcount over
the partial block — pure VPU work with no host round-trips.

Layout (from index/fmindex.py, shipped with jnp.asarray):
  - bwt:            uint8  [n]       BWT symbols (fwd or rev text)
  - occ:            int32  [nb, 6]   cumulative counts at block boundaries
  - C:              int32  [7]       first-row symbol offsets
  - sampled_rows:   int32  [ns]      sorted SA rows with sampled positions
  - sampled_values: int32  [ns]      the sampled text positions
  - seq_starts:     int32  [num_seqs]

locate() is a fixed-trip-count LF walk (sampling by text position mod rate
guarantees <= rate-1 steps, index/fmindex.py) — a lax.fori_loop of gathers,
one iteration per sampling step, fully batched.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..alphabet import SIGMA
from .fmindex import OCC_BLOCK, FmIndex


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceSingleIndex:
    bwt: jax.Array  # uint8 [n]
    occ: jax.Array  # int32 [nb, SIGMA]
    # bit-plane occ dictionary (device EPR analogue, fmindex.hpp:8):
    # uint32 [nb, SIGMA, OCC_BLOCK // 32]; bit j of word w in block b set
    # iff bwt[b * OCC_BLOCK + 32 * w + j] == symbol. rank = checkpoint
    # gather + masked lax.population_count — ~4x less gather traffic and
    # ~20x less VPU work than the dense one-hot window path.
    planes: jax.Array | None = None

    def tree_flatten(self):
        return (self.bwt, self.occ, self.planes), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceIndex:
    fwd: DeviceSingleIndex
    rev: DeviceSingleIndex
    C: jax.Array  # int32 [SIGMA + 1]
    sampled_rows: jax.Array  # int32 [ns]
    sampled_values: jax.Array  # int32 [ns]
    seq_starts: jax.Array  # int32 [num_seqs]
    # combined rank table for the frontier search: uint32
    # [nb_fwd + 1 + nb_rev, SIGMA, 1 + OCC_BLOCK // 32] where [..., 0] is
    # the occ checkpoint and [..., 1:] the bit planes; fwd blocks first,
    # rev blocks at row offset rev_block_offset. One gather yields both
    # the checkpoint and the popcount words for either direction — the
    # frontier expand's rank drops from 8 gather launches to 2.
    rank_rows: jax.Array | None = None
    # int32 scalar array (a pytree child, so jit treats it as data and the
    # pytree structure stays stable across indexes)
    rev_block_offset: jax.Array | None = None
    sampling_rate: int = 4

    def tree_flatten(self):
        children = (
            self.fwd,
            self.rev,
            self.C,
            self.sampled_rows,
            self.sampled_values,
            self.seq_starts,
            self.rank_rows,
            self.rev_block_offset,
        )
        return children, self.sampling_rate

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children[:6], rank_rows=children[6],
                   rev_block_offset=children[7], sampling_rate=aux)

    @classmethod
    def from_host(cls, index: FmIndex) -> "DeviceIndex":
        import numpy as np

        def single(host, planes):
            return DeviceSingleIndex(
                jnp.asarray(host.bwt, dtype=jnp.uint8),
                jnp.asarray(host.occ_checkpoints, dtype=jnp.int32),
                jnp.asarray(planes),
            )

        def rank_row_table(host, planes):
            # FLAT 2-D rows [nb, 32]: column 5*s is symbol s's checkpoint,
            # columns 5*s+1 .. 5*s+4 its plane words, 30..31 zero pad.
            # 2-D keeps the row gather wide and lets the rank computation
            # slice columns into [B] vectors (perfect 1-D layouts) instead
            # of reducing over a [B, 6, 5] minor shape whose (8, 128)
            # tiling wastes ~97% of each VPU tile (profiled: 673k cycles
            # per rank reduce at [32768, 6, 5]).
            nb = planes.shape[0]
            words = planes.shape[2]
            rows = np.zeros((nb, 32), dtype=np.uint32)
            for s in range(SIGMA):
                rows[:, 5 * s] = host.occ_checkpoints[:nb, s].astype(
                    np.uint32
                )
                rows[:, 5 * s + 1 : 5 * s + 1 + words] = planes[:, s, :]
            return rows

        # pack each direction's bit planes ONCE (an O(genome) numpy pass)
        # and share between the planes child and the rank-row table
        fwd_planes = pack_bit_planes(index.fwd.bwt)
        rev_planes = pack_bit_planes(index.rev.bwt)
        # rank_rows addresses a combined fwd ++ rev position space of
        # ~2n + OCC_BLOCK in int32 (rank_rows_lookup computes
        # base + rev_block_offset * OCC_BLOCK before the block divide);
        # past int32 that arithmetic wraps negative and gathers garbage
        # rows, so fall back to the per-direction planes/dense rank path
        # which stays within the single-direction int32-exact limit.
        combined_positions = (
            fwd_planes.shape[0] + 1 + rev_planes.shape[0]
        ) * OCC_BLOCK
        if combined_positions >= 2**31:
            rank_rows = None
            rev_block_offset = jnp.int32(0)
        else:
            fwd_rows = rank_row_table(index.fwd, fwd_planes)
            rev_rows = rank_row_table(index.rev, rev_planes)
            # one zero pad row between the directions so the rev offset is
            # a whole block count and fwd's final checkpoint row (block
            # nb-1 covers positions up to n) never collides with rev
            # block 0
            pad = np.zeros_like(fwd_rows[:1])
            # fwd position n reads block n // OCC_BLOCK = nb_fwd - 1
            # (planes) but the checkpoint of the NEXT boundary lives at
            # occ row nb_fwd; rank_rows stores the checkpoint at the row's
            # own boundary, so a position in block b always uses row b for
            # both checkpoint and planes — no +1 row needed
            rank_rows = np.concatenate([fwd_rows, pad, rev_rows], axis=0)
            rev_block_offset = jnp.int32(fwd_rows.shape[0] + 1)

        return cls(
            fwd=single(index.fwd, fwd_planes),
            rev=single(index.rev, rev_planes),
            C=jnp.asarray(index.C, dtype=jnp.int32),
            sampled_rows=jnp.asarray(index.sampled_rows, dtype=jnp.int32),
            sampled_values=jnp.asarray(index.sampled_values, dtype=jnp.int32),
            seq_starts=jnp.asarray(index.seq_starts, dtype=jnp.int32),
            rank_rows=None if rank_rows is None else jnp.asarray(rank_rows),
            rev_block_offset=rev_block_offset,
            sampling_rate=index.sampling_rate,
        )


@jax.tree_util.register_pytree_node_class
@dataclass
class ShardedSingleIndex:
    """One direction of a ROW-SHARDED FM-index, as seen from inside a
    shard_map body: this device's local BWT rows, local cumulative occ
    checkpoints, and the shard's start row. rank_all() on it clamps global
    positions into the shard, counts locally, and psums the partial counts
    over `axis_name` — the ICI collective form of the hg38-scale rank
    query (SURVEY.md section 2.4: the reference holds the whole ~11 GB
    index in one node's RAM, floxer.cpp:90-92)."""

    bwt: jax.Array  # uint8 [shard_len_padded]
    occ: jax.Array  # int32 [nb_local + 1, SIGMA] local cumulative
    shard_start: jax.Array  # int32 scalar
    shard_length: jax.Array  # int32 scalar
    axis_name: str = "index"
    global_n: int = 0

    def tree_flatten(self):
        children = (self.bwt, self.occ, self.shard_start, self.shard_length)
        return children, (self.axis_name, self.global_n)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, axis_name=aux[0], global_n=aux[1])


def index_size(index) -> int:
    """Global text length of a (possibly sharded) single-direction index."""
    if isinstance(index, ShardedSingleIndex):
        return index.global_n
    return index.bwt.shape[0]


def pack_bit_planes(bwt) -> "np.ndarray":
    """Host-side bit-plane packing of a BWT for the planes rank path:
    uint32 [num_blocks, SIGMA, OCC_BLOCK // 32], little-endian bit order
    within each word (bit j of word w in block b <=> position
    b * OCC_BLOCK + 32 * w + j)."""
    import numpy as np

    n = bwt.shape[0]
    num_blocks = n // OCC_BLOCK + 1
    padded = np.full(num_blocks * OCC_BLOCK, SIGMA, dtype=np.uint8)
    padded[:n] = bwt  # pad symbol SIGMA: set in no plane
    words_per_block = OCC_BLOCK // 32
    planes = np.empty(
        (num_blocks, SIGMA, words_per_block), dtype=np.uint32
    )
    view = padded.reshape(num_blocks, words_per_block, 32)
    for symbol in range(SIGMA):
        bits = view == symbol  # [nb, W, 32] bool
        packed = np.packbits(bits, axis=-1, bitorder="little")  # [nb, W, 4]
        planes[:, symbol, :] = (
            np.ascontiguousarray(packed).view("<u4").reshape(
                num_blocks, words_per_block
            )
        )
    return planes


def _rank_all_planes(occ, planes, positions) -> jax.Array:
    """Bit-plane rank: [B] -> [B, SIGMA] via one checkpoint gather + one
    plane-row gather + masked popcounts (the EPR checkpoint+prefix scheme
    in device form)."""
    block = positions // OCC_BLOCK
    base = occ[block]  # [B, SIGMA]
    r = (positions - block * OCC_BLOCK).astype(jnp.uint32)  # [B]
    words_per_block = planes.shape[2]
    rows = planes[block]  # [B, SIGMA, W]
    # per-word masks: word w keeps its lowest clamp(r - 32w, 0, 32) bits
    w_base = (
        jnp.arange(words_per_block, dtype=jnp.uint32)[None, :] * 32
    )  # [1, W]
    bits_below = jnp.clip(
        r[:, None].astype(jnp.int32) - w_base.astype(jnp.int32), 0, 32
    )
    partial = (
        jnp.left_shift(
            jnp.uint32(1), jnp.clip(bits_below, 0, 31).astype(jnp.uint32)
        )
        - jnp.uint32(1)
    )
    mask = jnp.where(
        bits_below >= 32, jnp.uint32(0xFFFFFFFF), partial
    )  # [B, W]
    counts = jnp.sum(
        jax.lax.population_count(rows & mask[:, None, :]).astype(jnp.int32),
        axis=2,
    )  # [B, SIGMA]
    return base + counts


def rank_rows_lookup(rank_rows, positions) -> jax.Array:
    """Rank over the combined flat (checkpoint | planes) row table:
    [B] global positions (rev positions pre-offset by
    rev_block_offset * OCC_BLOCK) -> list of SIGMA [B] count vectors,
    in ONE row gather.
    All arithmetic runs on [B] column vectors (clean 1-D layouts): per
    word w the mask keeps the lowest clip(r - 32w, 0, 32) bits, and the
    per-symbol count is checkpoint + 4 masked popcounts."""
    block = positions // OCC_BLOCK
    rows = rank_rows[block]  # [B, 32] uint32 flat layout
    r = (positions - block * OCC_BLOCK).astype(jnp.int32)
    words_per_block = OCC_BLOCK // 32
    masks = []
    for w in range(words_per_block):
        bits_below = jnp.clip(r - 32 * w, 0, 32)
        partial = (
            jnp.left_shift(
                jnp.uint32(1),
                jnp.clip(bits_below, 0, 31).astype(jnp.uint32),
            )
            - jnp.uint32(1)
        )
        masks.append(
            jnp.where(bits_below >= 32, jnp.uint32(0xFFFFFFFF), partial)
        )
    counts = []
    for s in range(SIGMA):
        acc = rows[:, 5 * s].astype(jnp.int32)
        for w in range(words_per_block):
            acc = acc + jax.lax.population_count(
                rows[:, 5 * s + 1 + w] & masks[w]
            ).astype(jnp.int32)
        counts.append(acc)
    return counts


def rank_rows_lookup_stacked(rank_rows, positions) -> jax.Array:
    """[B, SIGMA] form of rank_rows_lookup (tests / generic callers)."""
    return jnp.stack(rank_rows_lookup(rank_rows, positions), axis=1)


def _rank_all_dense(bwt, occ, positions) -> jax.Array:
    block = positions // OCC_BLOCK
    base = occ[block]  # [B, SIGMA]
    start = block * OCC_BLOCK
    offsets = jnp.arange(OCC_BLOCK, dtype=jnp.int32)[None, :]  # [1, OB]
    gather_idx = jnp.minimum(start[:, None] + offsets, bwt.shape[0] - 1)
    window = bwt[gather_idx].astype(jnp.int32)  # [B, OB]
    in_range = offsets < (positions - start)[:, None]  # [B, OB]
    one_hot = (
        window[:, :, None] == jnp.arange(SIGMA, dtype=jnp.int32)[None, None, :]
    )
    partial_counts = jnp.sum(
        one_hot & in_range[:, :, None], axis=1, dtype=jnp.int32
    )
    return base + partial_counts


def rank_all(index, positions: jax.Array) -> jax.Array:
    """occ over all SIGMA symbols for a batch of positions: [B] -> [B, SIGMA].

    One checkpoint gather + a masked one-hot popcount over the partial block
    (OCC_BLOCK wide), the device analogue of the EPR dictionary's
    checkpoint+prefix-sum scheme. For a ShardedSingleIndex the count is a
    local partial plus a psum over the index mesh axis.
    """
    if isinstance(index, ShardedSingleIndex):
        # subtract the shard start BEFORE narrowing to int32: global
        # positions of a >2 Gbp sharded text exceed int32 while shard-LOCAL
        # positions fit (hg38 / 2 shards = 1.55 G < 2^31). NOTE: the
        # subtraction itself is exact only when the incoming positions
        # dtype is wide enough — at >2 Gbp scale callers must run with
        # jax_enable_x64 (or pre-localized positions); under the default
        # 32-bit config this path is exact to 2^31-1 like everything else.
        local_pos = jnp.clip(
            positions - index.shard_start.astype(positions.dtype),
            0,
            index.shard_length,
        ).astype(jnp.int32)
        local = _rank_all_dense(
            index.bwt, index.occ.astype(jnp.int32), local_pos
        )
        return jax.lax.psum(local, index.axis_name)
    positions = positions.astype(jnp.int32)
    if getattr(index, "planes", None) is not None:
        return _rank_all_planes(index.occ, index.planes, positions)
    return _rank_all_dense(index.bwt, index.occ, positions)


def bwt_at(index, rows: jax.Array) -> jax.Array:
    """BWT symbols at global rows; for a sharded index the owning shard
    contributes via a masked psum."""
    if isinstance(index, ShardedSingleIndex):
        local = jnp.clip(rows - index.shard_start, 0, index.shard_length - 1)
        in_shard = (rows >= index.shard_start) & (
            rows < index.shard_start + index.shard_length
        )
        value = jnp.where(in_shard, index.bwt[local].astype(jnp.int32), 0)
        return jax.lax.psum(value, index.axis_name)
    return index.bwt[rows].astype(jnp.int32)


def rank_symbol(
    index: DeviceSingleIndex, symbol: jax.Array, positions: jax.Array
) -> jax.Array:
    """occ(symbol, position) batched: [B],[B] -> [B]."""
    counts = rank_all(index, positions)
    return jnp.take_along_axis(counts, symbol[:, None].astype(jnp.int32), 1)[:, 0]


def extend_left_all(
    index: DeviceIndex, lb: jax.Array, lb_rev: jax.Array, length: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """All-SIGMA left extension for a batch of bidirectional cursors.

    [B] cursors -> ([B, SIGMA] lb, [B, SIGMA] lb_rev, [B, SIGMA] length),
    mirroring FmIndex.extend_left_all with two rank_all calls.
    """
    lo = rank_all(index.fwd, lb)  # [B, SIGMA]
    hi = rank_all(index.fwd, lb + length)
    counts = hi - lo
    prefix = jnp.cumsum(counts, axis=1) - counts  # exclusive prefix sum
    new_lb = index.C[None, :SIGMA] + lo
    new_lb_rev = lb_rev[:, None] + prefix
    return new_lb, new_lb_rev, counts


def extend_right_all(
    index: DeviceIndex, lb: jax.Array, lb_rev: jax.Array, length: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    lo = rank_all(index.rev, lb_rev)
    hi = rank_all(index.rev, lb_rev + length)
    counts = hi - lo
    prefix = jnp.cumsum(counts, axis=1) - counts
    new_lb_rev = index.C[None, :SIGMA] + lo
    new_lb = lb[:, None] + prefix
    return new_lb, new_lb_rev, counts


@jax.tree_util.register_pytree_node_class
@dataclass
class ShardedDeviceIndex:
    """A DeviceIndex whose BWT/occ rows and SA samples are row-sharded
    across the `index` mesh axis (built by
    parallel/sharded_index.shard_full_index, consumed inside shard_map).
    C and seq_starts stay replicated. All batched ops (rank, LF, locate,
    extensions, the frontier search) work unchanged on it — the sharded
    gathers resolve through rank_all/bwt_at/_sample_lookup."""

    fwd: ShardedSingleIndex
    rev: ShardedSingleIndex
    C: jax.Array
    sampled_rows: jax.Array  # int32 [ns_local] local chunk, pad 1<<30
    sampled_values: jax.Array  # int32 [ns_local]
    seq_starts: jax.Array
    sampling_rate: int = 4

    def tree_flatten(self):
        children = (
            self.fwd,
            self.rev,
            self.C,
            self.sampled_rows,
            self.sampled_values,
            self.seq_starts,
        )
        return children, self.sampling_rate

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, sampling_rate=aux)


def _sample_lookup(index, rows: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(hit [B] bool, sampled_value [B]) for SA rows; sharded indexes OR
    the hit and sum the value across the index axis (exactly one shard can
    own a row; local pads are 1<<30 sentinels that never match)."""
    idx = jnp.searchsorted(index.sampled_rows, rows)
    idx = jnp.minimum(idx, index.sampled_rows.shape[0] - 1)
    hit = index.sampled_rows[idx] == rows
    value = jnp.where(hit, index.sampled_values[idx], 0)
    if isinstance(index, ShardedDeviceIndex):
        axis = index.fwd.axis_name
        hit = jax.lax.psum(hit.astype(jnp.int32), axis) > 0
        value = jax.lax.psum(value, axis)
    return hit, value


def lf_step(index, rows: jax.Array) -> jax.Array:
    """One batched LF mapping step: row of suffix p -> row of suffix p-1."""
    symbols = bwt_at(index.fwd, rows)
    return index.C[symbols] + rank_symbol(index.fwd, symbols, rows)


@partial(jax.jit, static_argnames=("sampling_rate",))
def locate_batch(
    index: DeviceIndex, rows: jax.Array, sampling_rate: int | None = None
) -> tuple[jax.Array, jax.Array]:
    """Batched locate: SA rows -> (reference_id, position_in_reference).

    Bounded LF walk of at most sampling_rate - 1 steps (text-position
    sampling), then a searchsorted over sequence starts — the device
    analogue of index.locate (search.cpp:253). The walk bound defaults to
    the INDEX's own sampling rate (pytree aux, static under jit): an
    explicit smaller value would silently yield garbage coordinates for
    rows that need more steps than the loop runs.
    """
    if sampling_rate is None:
        sampling_rate = index.sampling_rate
    rows = rows.astype(jnp.int32)

    def body(_, carry):
        cur_rows, steps, done = carry
        hit, sampled_value = _sample_lookup(index, cur_rows)
        newly_done = hit & ~done
        # remember the sampled value for rows that just hit
        steps = jnp.where(newly_done, sampled_value + steps, steps)
        next_rows = lf_step(index, cur_rows)
        cur_rows = jnp.where(hit | done, cur_rows, next_rows)
        # rows still walking accumulate +1 text position
        steps = jnp.where(hit | done, steps, steps + 1)
        return cur_rows, steps, done | hit

    init = (
        rows,
        jnp.zeros_like(rows),
        jnp.zeros(rows.shape, dtype=bool),
    )
    _, positions, done = jax.lax.fori_loop(0, sampling_rate, body, init)

    seq_ids = (
        jnp.searchsorted(index.seq_starts, positions, side="right") - 1
    ).astype(jnp.int32)
    in_seq_positions = positions - index.seq_starts[seq_ids]
    return seq_ids, in_seq_positions
