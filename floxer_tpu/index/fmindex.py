"""Bidirectional FM-index over DNA5 rank sequences.

Device-friendly re-design of the reference's fmindex-collection BiFMIndex
(include/fmindex.hpp:7-10: alphabet size 6, suffix-array sampling rate 4,
built in floxer.cpp:92-97, queried in src/lib/search.cpp:173/253).

Index layout (everything is a flat numpy array so the whole index ships to
device HBM unchanged; see device_index.py for the batched-gather query path):

  - text: concatenation of all reference rank sequences, each followed by a
    rank-0 sentinel separator
  - sa / bwt and their reversed-text counterparts (bidirectional search needs
    an index over text and over reversed text)
  - occ checkpoints every OCC_BLOCK positions per symbol (int64 on host;
    int32 + uint8 packed BWT on device), C array from symbol counts
  - sampled suffix array by TEXT position (pos % sampling_rate == 0), so
    locate() is a bounded LF walk of at most sampling_rate - 1 steps — a
    fixed-trip-count gather loop on device

Construction runs on host: suffix array via numpy prefix doubling (O(n log n)
full-array argsorts — vectorized, no Python-per-char loops).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..alphabet import SIGMA

OCC_BLOCK = 128
DEFAULT_SAMPLING_RATE = 4


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array: native SA-IS (O(n), floxer_tpu/native/sais.cpp) with a
    numpy prefix-doubling fallback."""
    from ..native import native_suffix_array

    native = native_suffix_array(np.asarray(text, dtype=np.uint8))
    if native is not None:
        return native
    return _suffix_array_doubling(text)


def _suffix_array_doubling(text: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling (Manber-Myers, numpy-vectorized).

    Ranks are compared as (rank[i], rank[i+k]) pairs, doubling k. Ties break
    consistently because every sequence ends with a sentinel; equal suffixes
    cannot occur except for the (distinct-position) separators themselves,
    which compare by their continuation.
    """
    text = np.asarray(text, dtype=np.int64)
    n = text.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int64)
    rank = text.copy()
    k = 1
    idx = np.arange(n, dtype=np.int64)
    while True:
        rank2 = np.full(n, -1, dtype=np.int64)
        rank2[: n - k] = rank[k:]
        order = np.lexsort((rank2, rank))
        # new ranks: increment where the (rank, rank2) pair differs
        r_ord = rank[order]
        r2_ord = rank2[order]
        changed = np.empty(n, dtype=np.int64)
        changed[0] = 0
        changed[1:] = (r_ord[1:] != r_ord[:-1]) | (r2_ord[1:] != r2_ord[:-1])
        new_rank_ord = np.cumsum(changed)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_rank_ord
        if new_rank_ord[-1] == n - 1:
            return order
        k *= 2
        if k >= n:
            return np.lexsort((idx, rank))


def _bwt_from_sa(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    prev = sa - 1  # SA[i] == 0 wraps to the last text char
    return text[prev].astype(np.uint8)


def _occ_checkpoints(bwt: np.ndarray) -> np.ndarray:
    """(num_blocks + 1, SIGMA) cumulative symbol counts at block boundaries.

    Per-symbol reshape+sum instead of np.add.at: the scatter path is
    single-element at a time and costs minutes at genome scale, the six
    vectorized passes are bandwidth-bound seconds."""
    n = bwt.shape[0]
    num_blocks = n // OCC_BLOCK + 1
    per_block = np.zeros((num_blocks, SIGMA), dtype=np.int64)
    full = n // OCC_BLOCK
    if full:
        view = bwt[: full * OCC_BLOCK].reshape(full, OCC_BLOCK)
        for symbol in range(SIGMA):
            np.sum(view == symbol, axis=1, out=per_block[:full, symbol])
    tail = bwt[full * OCC_BLOCK :]
    if tail.size:
        per_block[full] = np.bincount(tail, minlength=SIGMA)[:SIGMA]
    checkpoints = np.zeros((num_blocks + 1, SIGMA), dtype=np.int64)
    np.cumsum(per_block, axis=0, out=checkpoints[1:])
    return checkpoints


# native in-RAM layout (search.cpp): one 128-byte row per OCC_BLOCK
# positions = [6 x int64 checkpoint | 64 nibble-packed symbols | pad].
# Rank queries touch two adjacent cache lines instead of a checkpoint line
# plus bwt lines in a separate array — the native search is memory-stall
# bound at large genome scale, not compute bound.
OCC_ROW_BYTES = 128
OCC_NIBBLE_OFFSET = 48


def _advise_hugepages(array: np.ndarray) -> None:
    """Best-effort MADV_HUGEPAGE on the array's 2 MiB-aligned interior:
    random rank queries over a multi-hundred-MB table are TLB-miss bound
    on 4 KiB pages."""
    import os

    if os.environ.get("FLOXER_TPU_NO_HUGEPAGES"):
        return
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        align = 2 * 1024 * 1024
        addr = array.ctypes.data
        start = (addr + align - 1) // align * align
        end = (addr + array.nbytes) // align * align
        if end > start:
            libc.madvise(
                ctypes.c_void_p(start),
                ctypes.c_size_t(end - start),
                14,  # MADV_HUGEPAGE
            )
    except Exception:  # noqa: BLE001 - advisory only
        pass


def pack_occ_rows(bwt: np.ndarray, occ_checkpoints: np.ndarray) -> np.ndarray:
    """Build the interleaved occ-row buffer the native engines scan."""
    n = bwt.shape[0]
    num_blocks = n // OCC_BLOCK + 1
    flat = np.empty(num_blocks * OCC_ROW_BYTES, dtype=np.uint8)
    # advise BEFORE the fill below faults the pages in: MADV_HUGEPAGE on an
    # already-populated 4 KiB VMA only queues lazy collapse, which in
    # practice never happens for a table this size
    _advise_hugepages(flat)
    rows = flat.reshape(num_blocks, OCC_ROW_BYTES)
    rows[:, OCC_NIBBLE_OFFSET + OCC_BLOCK // 2 :] = 0
    rows[:, :OCC_NIBBLE_OFFSET] = (
        np.ascontiguousarray(occ_checkpoints[:num_blocks])
        .astype("<i8", copy=False)
        .view(np.uint8)
        .reshape(num_blocks, OCC_NIBBLE_OFFSET)
    )
    padded = np.zeros(num_blocks * OCC_BLOCK, dtype=np.uint8)
    padded[:n] = bwt
    pairs = padded.reshape(num_blocks, OCC_BLOCK // 2, 2)
    rows[:, OCC_NIBBLE_OFFSET : OCC_NIBBLE_OFFSET + OCC_BLOCK // 2] = (
        pairs[:, :, 0] | (pairs[:, :, 1] << 4)
    )
    return flat


def _huge_empty(nbytes: int, dtype=np.uint8) -> np.ndarray:
    """np.empty with MADV_HUGEPAGE advised BEFORE first touch. On this VM
    first-touching fresh 4 KiB pages runs at ~0.05 GB/s while advised
    2 MiB pages fault at ~1.3 GB/s and fill at ~5 GB/s — a 25x difference
    that dominated the v2 artifact's load time (hg38 ~620 s)."""
    array = np.empty(nbytes // np.dtype(dtype).itemsize, dtype=dtype)
    _advise_hugepages(array)
    return array


def _parallel_rows(total: int, fn, threads: int | None = None) -> None:
    """Run fn(lo, hi) over a row range split across host threads. The
    first-touch page faulting of a fresh buffer is kernel-side work that
    scales with threads (measured 3.1x on 4 cores for a 3.2 GB widening
    copy), and numpy's cast/copy loops release the GIL — so the big v3
    load copies (occ-row expansion, SA-sample widening) go wide."""
    import concurrent.futures as cf

    if threads is None:
        threads = min(4, os.cpu_count() or 1)
    if threads <= 1 or total < (1 << 21):
        fn(0, total)
        return
    bounds = [
        (k * total // threads, (k + 1) * total // threads)
        for k in range(threads)
    ]
    with cf.ThreadPoolExecutor(threads) as pool:
        for future in [pool.submit(fn, lo, hi) for lo, hi in bounds]:
            future.result()


class _SingleIndex:
    """One direction's BWT machinery (forward text or reversed text).

    Holds either the raw (bwt, occ_checkpoints) tables — the build path —
    or only the interleaved packed-rows buffer (the v3 artifact load
    path), from which bwt / occ_checkpoints materialize lazily; the
    native engines consume packed_rows directly, so the hot path never
    pays the unpack."""

    def __init__(
        self,
        bwt: np.ndarray | None = None,  # uint8 [n]
        occ_checkpoints: np.ndarray | None = None,  # int64 [B + 1, SIGMA]
        packed: np.ndarray | None = None,  # uint8 [B * OCC_ROW_BYTES]
        n: int | None = None,
        totals: np.ndarray | None = None,  # int64 [SIGMA] symbol counts
    ):
        self._bwt = bwt
        self._occ_checkpoints = occ_checkpoints
        self._packed_rows = packed
        self._n = n if n is not None else (len(bwt) if bwt is not None else 0)
        self._totals = totals

    @property
    def bwt(self) -> np.ndarray:
        if self._bwt is None:
            rows = self._packed_rows.reshape(-1, OCC_ROW_BYTES)
            nibbles = rows[:, OCC_NIBBLE_OFFSET : OCC_NIBBLE_OFFSET + OCC_BLOCK // 2]
            out = _huge_empty(nibbles.shape[0] * OCC_BLOCK)
            pairs = out.reshape(nibbles.shape[0], OCC_BLOCK // 2, 2)
            pairs[:, :, 0] = nibbles & np.uint8(0x0F)
            pairs[:, :, 1] = nibbles >> np.uint8(4)
            self._bwt = out[: self._n]
        return self._bwt

    @property
    def occ_checkpoints(self) -> np.ndarray:
        if self._occ_checkpoints is None:
            rows64 = self._packed_rows.view("<i8").reshape(
                -1, OCC_ROW_BYTES // 8
            )
            num_blocks = rows64.shape[0]
            full = np.empty((num_blocks + 1, SIGMA), dtype=np.int64)
            full[:num_blocks] = rows64[:, :SIGMA]
            # checkpoint past the last block = whole-text symbol counts
            full[num_blocks] = self._totals
            self._occ_checkpoints = full
        return self._occ_checkpoints

    def packed_rows(self) -> np.ndarray:
        """Interleaved native scan layout, built lazily and cached."""
        if self._packed_rows is None:
            self._packed_rows = pack_occ_rows(
                self._bwt, self._occ_checkpoints
            )
        return self._packed_rows

    def occ(self, symbol: int, position: int) -> int:
        """# occurrences of symbol in bwt[:position]."""
        block = position // OCC_BLOCK
        base = int(self.occ_checkpoints[block, symbol])
        start = block * OCC_BLOCK
        if position > start:
            base += int(np.count_nonzero(self.bwt[start:position] == symbol))
        return base

    def occ_all(self, position: int) -> np.ndarray:
        """occ for all SIGMA symbols at once (drives bidirectional updates)."""
        block = position // OCC_BLOCK
        counts = self.occ_checkpoints[block].copy()
        start = block * OCC_BLOCK
        if position > start:
            counts += np.bincount(self.bwt[start:position], minlength=SIGMA)
        return counts


@dataclass(frozen=True)
class Cursor:
    """Bidirectional cursor: fwd/rev interval starts + shared length.

    Mirrors fmindex-collection's BiFMIndexCursor (fmindex.hpp:9). The fwd
    interval [lb, lb+length) covers suffixes of text starting with the
    current pattern; the rev interval covers suffixes of reversed text
    starting with the reversed pattern.
    """

    lb: int
    lb_rev: int
    length: int

    @property
    def empty(self) -> bool:
        return self.length <= 0


class FmIndex:
    """Host-queryable bidirectional FM-index over a reference collection."""

    def __init__(
        self,
        sequences: list[np.ndarray],
        sampling_rate: int = DEFAULT_SAMPLING_RATE,
    ):
        self.sampling_rate = sampling_rate
        self.num_sequences = len(sequences)

        pieces = []
        starts = []
        pos = 0
        for seq in sequences:
            starts.append(pos)
            pieces.append(np.asarray(seq, dtype=np.uint8))
            pieces.append(np.zeros(1, dtype=np.uint8))  # sentinel separator
            pos += len(seq) + 1
        self._text = (
            np.concatenate(pieces) if pieces else np.zeros(0, dtype=np.uint8)
        )
        self._text_nib = None
        self._sampled_rows = None
        self._sampled_values = None
        self._sampled_raw = None
        self.seq_starts = np.asarray(starts, dtype=np.int64)
        self.seq_lengths = np.asarray([len(s) for s in sequences], dtype=np.int64)
        n = self.text.shape[0]
        self.n = n

        # forward and reverse directions build CONCURRENTLY: the SA-IS
        # call releases the GIL and each direction peaks at roughly
        # text + (n+1) int64 + n bits (sais.cpp builds in place), so even
        # an hg38-scale pair fits this host comfortably — and the wall
        # clock halves on the reference's own multithreaded-build design
        # point (floxer.cpp:92-97). Each direction frees its SA as soon as
        # the BWT / SA samples are derived.
        import threading

        results: dict = {}
        errors: list = []

        def build_forward() -> None:
            try:
                sa = suffix_array(self.text)
                bwt = _bwt_from_sa(self.text, sa)
                # sampled SA by text position: rows with SA value % rate == 0
                sampled_mask = sa % sampling_rate == 0
                rows = np.flatnonzero(sampled_mask).astype(np.int64)
                values = sa[sampled_mask].astype(np.int64)
                del sa, sampled_mask
                results["fwd"] = (bwt, _occ_checkpoints(bwt), rows, values)
            except Exception as error:  # noqa: BLE001 - re-raised below
                errors.append(error)

        def build_reverse() -> None:
            try:
                text_rev = self.text[::-1].copy()
                sa_rev = suffix_array(text_rev)
                bwt_rev = _bwt_from_sa(text_rev, sa_rev)
                del sa_rev, text_rev
                results["rev"] = (bwt_rev, _occ_checkpoints(bwt_rev))
            except Exception as error:  # noqa: BLE001 - re-raised below
                errors.append(error)

        if n >= (1 << 22):  # threading overhead is wasted on tiny builds
            rev_thread = threading.Thread(
                target=build_reverse, name="index-rev-build"
            )
            rev_thread.start()
            build_forward()
            rev_thread.join()
        else:
            build_forward()
            build_reverse()
        if errors:
            raise errors[0]
        bwt, fwd_occ, self._sampled_rows, self._sampled_values = results[
            "fwd"
        ]
        self.fwd = _SingleIndex(bwt, fwd_occ)
        self.rev = _SingleIndex(*results["rev"])

        counts = np.bincount(self.text, minlength=SIGMA).astype(np.int64)
        self.C = np.zeros(SIGMA + 1, dtype=np.int64)
        self.C[1:] = np.cumsum(counts)
        # membership bitset lookup via searchsorted on sampled_rows

    # ------------------------------------------------------------------
    # lazily materialized tables (v3 artifact load path)
    # ------------------------------------------------------------------

    @property
    def text(self) -> np.ndarray:
        if self._text is None:
            nib = self._text_nib
            out = _huge_empty(nib.shape[0] * 2)

            def unpack(lo: int, hi: int) -> None:
                out[2 * lo : 2 * hi : 2] = nib[lo:hi] & np.uint8(0x0F)
                out[2 * lo + 1 : 2 * hi : 2] = nib[lo:hi] >> np.uint8(4)

            _parallel_rows(nib.shape[0], unpack)
            self._text = out[: self.n]
            self._text_nib = None
        return self._text

    def _materialize_sampled(self) -> None:
        rows_raw, values_raw = self._sampled_raw
        count = rows_raw.shape[0]
        rows = _huge_empty(count * 8, np.int64)
        values = _huge_empty(count * 8, np.int64)

        def widen(lo: int, hi: int) -> None:
            np.copyto(rows[lo:hi], rows_raw[lo:hi], casting="unsafe")
            np.copyto(values[lo:hi], values_raw[lo:hi], casting="unsafe")

        _parallel_rows(count, widen)
        self._sampled_rows = rows
        self._sampled_values = values
        self._sampled_raw = None

    @property
    def sampled_rows(self) -> np.ndarray:
        if self._sampled_rows is None:
            self._materialize_sampled()
        return self._sampled_rows

    @property
    def sampled_values(self) -> np.ndarray:
        if self._sampled_values is None:
            self._materialize_sampled()
        return self._sampled_values

    # ------------------------------------------------------------------
    # cursor operations
    # ------------------------------------------------------------------

    def root_cursor(self) -> Cursor:
        return Cursor(0, 0, self.n)

    def _interval_symbol_counts(
        self, index: _SingleIndex, lb: int, length: int
    ) -> np.ndarray:
        return index.occ_all(lb + length) - index.occ_all(lb)

    def extend_left(self, cursor: Cursor, symbol: int) -> Cursor:
        """Prepend symbol to the pattern (backward step on the fwd index)."""
        counts = self._interval_symbol_counts(self.fwd, cursor.lb, cursor.length)
        new_len = int(counts[symbol])
        new_lb = int(self.C[symbol]) + self.fwd.occ(symbol, cursor.lb)
        new_lb_rev = cursor.lb_rev + int(counts[:symbol].sum())
        return Cursor(new_lb, new_lb_rev, new_len)

    def extend_right(self, cursor: Cursor, symbol: int) -> Cursor:
        """Append symbol to the pattern (backward step on the rev index)."""
        counts = self._interval_symbol_counts(self.rev, cursor.lb_rev, cursor.length)
        new_len = int(counts[symbol])
        new_lb_rev = int(self.C[symbol]) + self.rev.occ(symbol, cursor.lb_rev)
        new_lb = cursor.lb + int(counts[:symbol].sum())
        return Cursor(new_lb, new_lb_rev, new_len)

    def extend_left_all(self, cursor: Cursor) -> list["Cursor"]:
        """All SIGMA left extensions at once (two occ_all calls total)."""
        lo = self.fwd.occ_all(cursor.lb)
        hi = self.fwd.occ_all(cursor.lb + cursor.length)
        counts = hi - lo
        prefix = np.concatenate(([0], np.cumsum(counts)[:-1]))
        return [
            Cursor(
                int(self.C[c] + lo[c]),
                cursor.lb_rev + int(prefix[c]),
                int(counts[c]),
            )
            for c in range(SIGMA)
        ]

    def extend_right_all(self, cursor: Cursor) -> list["Cursor"]:
        lo = self.rev.occ_all(cursor.lb_rev)
        hi = self.rev.occ_all(cursor.lb_rev + cursor.length)
        counts = hi - lo
        prefix = np.concatenate(([0], np.cumsum(counts)[:-1]))
        return [
            Cursor(
                cursor.lb + int(prefix[c]),
                int(self.C[c] + lo[c]),
                int(counts[c]),
            )
            for c in range(SIGMA)
        ]

    # ------------------------------------------------------------------
    # locate
    # ------------------------------------------------------------------

    def _lf(self, row: int) -> int:
        symbol = int(self.fwd.bwt[row])
        return int(self.C[symbol]) + self.fwd.occ(symbol, row)

    def text_position(self, row: int) -> int:
        """SA[row] via the sampled-SA LF walk (<= sampling_rate - 1 steps)."""
        steps = 0
        while True:
            i = np.searchsorted(self.sampled_rows, row)
            if i < len(self.sampled_rows) and self.sampled_rows[i] == row:
                pos = int(self.sampled_values[i]) + steps
                return pos if pos < self.n else pos - self.n
            row = self._lf(row)
            steps += 1

    def locate(self, row: int) -> tuple[int, int]:
        """(reference_id, position_in_reference) for one cursor row
        (parity: index.locate in search.cpp:253/284)."""
        pos = self.text_position(row)
        seq_id = int(np.searchsorted(self.seq_starts, pos, side="right")) - 1
        return seq_id, pos - int(self.seq_starts[seq_id])

    def locate_batch(
        self, rows: np.ndarray, num_threads: int = 1
    ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized locate: (reference_ids, positions) int64 arrays for a
        batch of rows. The LF walks run in the native library when
        available (one call instead of per-row Python occ queries); the
        reference-id split is a vectorized searchsorted either way."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return rows, rows
        from ..native import native_locate_batch

        positions = native_locate_batch(self, rows, num_threads)
        if positions is None:
            positions = np.fromiter(
                (self.text_position(int(row)) for row in rows),
                dtype=np.int64,
                count=rows.shape[0],
            )
        seq_ids = np.searchsorted(self.seq_starts, positions, side="right") - 1
        return seq_ids, positions - self.seq_starts[seq_ids]

    # ------------------------------------------------------------------
    # persistence (replaces the reference's cereal archive,
    # output.cpp:25-40 / input.cpp:150-157)
    # ------------------------------------------------------------------

    def save(self, path) -> None:
        """Format v3: a raw, 4096-aligned section container (magic
        b'FLOXIDX3' + JSON header + sections).

        The occ rows are stored in exactly the bytes the runtime's
        interleaved scan layout needs — per block: SIGMA narrow
        checkpoints plus 32 nibble-packed symbols — so load is ONE
        widening strided copy per direction into a hugepage-advised
        buffer instead of v2's unpack-nibbles + repack-rows (which
        first-touched ~28 GB of 4 KiB pages at hg38 scale: ~620 s).
        Text and SA samples are memmapped and materialize lazily. At the
        reference's ~11 GB hg38 design point (floxer.cpp:90-92):
        narrow = uint32 whenever n < 2^32."""
        narrow = np.uint32 if self.n < (1 << 32) else np.int64
        num_blocks = self.n // OCC_BLOCK + 1

        def direction_sections(tag: str, single: _SingleIndex):
            rows = single.packed_rows().reshape(num_blocks, OCC_ROW_BYTES)
            occ = (
                np.ascontiguousarray(rows[:, :OCC_NIBBLE_OFFSET])
                .view("<i8")
                .astype(narrow)
            )
            nib = np.ascontiguousarray(
                rows[:, OCC_NIBBLE_OFFSET : OCC_NIBBLE_OFFSET + OCC_BLOCK // 2]
            )
            return [(f"{tag}_occ", occ), (f"{tag}_nib", nib)]

        sections = [
            ("seq_starts", self.seq_starts),
            ("seq_lengths", self.seq_lengths),
            ("C", self.C),
            ("text_nib", _pack_nibbles(self.text)),
            *direction_sections("fwd", self.fwd),
            *direction_sections("rev", self.rev),
            ("sampled_rows", self.sampled_rows.astype(narrow)),
            ("sampled_values", self.sampled_values.astype(narrow)),
        ]
        _write_v3(
            path,
            {"n": self.n, "sampling_rate": self.sampling_rate},
            sections,
        )

    @classmethod
    def load(cls, path) -> "FmIndex":
        with open(path, "rb") as handle:
            magic = handle.read(len(_V3_MAGIC))
        if magic == _V3_MAGIC:
            return cls._load_v3(path)
        return cls._load_npz(path)

    @classmethod
    def _load_v3(cls, path) -> "FmIndex":
        meta, sections = _read_v3(path)
        obj = cls.__new__(cls)
        obj.n = int(meta["n"])
        obj.sampling_rate = int(meta["sampling_rate"])
        obj.seq_starts = np.asarray(sections["seq_starts"])
        obj.seq_lengths = np.asarray(sections["seq_lengths"])
        obj.num_sequences = len(obj.seq_starts)
        obj.C = np.asarray(sections["C"])
        num_blocks = obj.n // OCC_BLOCK + 1
        totals = np.diff(obj.C)

        def expand(tag: str) -> _SingleIndex:
            flat = _huge_empty(num_blocks * OCC_ROW_BYTES)
            rows = flat.reshape(num_blocks, OCC_ROW_BYTES)
            rows64 = flat.view("<i8").reshape(num_blocks, OCC_ROW_BYTES // 8)
            occ = sections[f"{tag}_occ"]
            nib = sections[f"{tag}_nib"]

            def fill(lo: int, hi: int) -> None:
                rows64[lo:hi, :SIGMA] = occ[lo:hi]  # widening copy
                rows[
                    lo:hi, OCC_NIBBLE_OFFSET : OCC_NIBBLE_OFFSET + OCC_BLOCK // 2
                ] = nib[lo:hi]
                rows[lo:hi, OCC_NIBBLE_OFFSET + OCC_BLOCK // 2 :] = 0

            _parallel_rows(num_blocks, fill)
            return _SingleIndex(packed=flat, n=obj.n, totals=totals)

        obj.fwd = expand("fwd")
        obj.rev = expand("rev")
        obj._text = None
        obj._text_nib = sections["text_nib"]
        obj._sampled_rows = None
        obj._sampled_values = None
        obj._sampled_raw = (
            sections["sampled_rows"],
            sections["sampled_values"],
        )
        return obj

    @classmethod
    def _load_npz(cls, path) -> "FmIndex":
        """Read compatibility for the v1/v2 npz artifacts."""
        data = np.load(path)
        version = int(data["format_version"])
        obj = cls.__new__(cls)
        obj.sampling_rate = int(data["sampling_rate"])
        obj.seq_starts = data["seq_starts"]
        obj.seq_lengths = data["seq_lengths"]
        obj.num_sequences = len(obj.seq_starts)
        obj.C = data["C"]
        obj._text_nib = None
        obj._sampled_raw = None
        if version >= 2:
            obj.n = int(data["n"])
            obj._text = _unpack_nibbles(data["text"], obj.n)
            obj.fwd = _SingleIndex(
                _unpack_nibbles(data["fwd_bwt"], obj.n),
                data["fwd_occ"].astype(np.int64),
            )
            obj.rev = _SingleIndex(
                _unpack_nibbles(data["rev_bwt"], obj.n),
                data["rev_occ"].astype(np.int64),
            )
            obj._sampled_rows = data["sampled_rows"].astype(np.int64)
            obj._sampled_values = data["sampled_values"].astype(np.int64)
            return obj
        obj._text = data["text"]
        obj.n = obj._text.shape[0]
        obj.fwd = _SingleIndex(data["fwd_bwt"], data["fwd_occ"])
        obj.rev = _SingleIndex(data["rev_bwt"], data["rev_occ"])
        obj._sampled_rows = data["sampled_rows"].astype(np.int64)
        obj._sampled_values = data["sampled_values"].astype(np.int64)
        return obj


_V3_MAGIC = b"FLOXIDX3"
_V3_ALIGN = 4096


def _write_v3(path, meta: dict, sections: list[tuple[str, np.ndarray]]):
    """Write the aligned raw-section container. Header JSON carries dtype,
    shape and byte offset per section; offsets are 4096-aligned so loads
    can memmap every section directly."""
    import json

    entries = {}
    # lay out offsets: header first, then aligned sections
    header_probe = {"meta": meta, "sections": {}}
    for name, array in sections:
        header_probe["sections"][name] = {
            "dtype": np.lib.format.dtype_to_descr(array.dtype),
            "shape": list(array.shape),
            "offset": 0,
        }
    header_len_guess = 0
    # two passes: offsets depend on header length which depends on offset
    # digit counts — iterate until stable (converges in <= 3 rounds)
    for _ in range(4):
        offset = len(_V3_MAGIC) + 8 + header_len_guess
        entries = {}
        for name, array in sections:
            offset = -(-offset // _V3_ALIGN) * _V3_ALIGN
            entries[name] = {
                "dtype": np.lib.format.dtype_to_descr(array.dtype),
                "shape": list(array.shape),
                "offset": offset,
            }
            offset += array.nbytes
        blob = json.dumps({"meta": meta, "sections": entries}).encode()
        if len(blob) == header_len_guess:
            break
        header_len_guess = len(blob)
    with open(path, "wb") as handle:
        handle.write(_V3_MAGIC)
        handle.write(np.uint64(len(blob)).tobytes())
        handle.write(blob)
        for name, array in sections:
            handle.seek(entries[name]["offset"])
            handle.write(np.ascontiguousarray(array).data)


def _read_v3(path):
    """Memmap every section of a v3 container (read-only)."""
    import json

    with open(path, "rb") as handle:
        handle.seek(len(_V3_MAGIC))
        header_len = int(np.frombuffer(handle.read(8), dtype=np.uint64)[0])
        header = json.loads(handle.read(header_len))
    sections = {}
    for name, entry in header["sections"].items():
        sections[name] = np.memmap(
            path,
            dtype=np.dtype(entry["dtype"]),
            mode="r",
            offset=entry["offset"],
            shape=tuple(entry["shape"]),
        )
    return header["meta"], sections


def _pack_nibbles(symbols: np.ndarray) -> np.ndarray:
    """uint8 values 0..15 -> two symbols per byte (low nibble first)."""
    if symbols.shape[0] % 2:
        symbols = np.concatenate(
            [symbols, np.zeros(1, dtype=np.uint8)]
        )
    return symbols[0::2] | (symbols[1::2] << np.uint8(4))


def _unpack_nibbles(packed: np.ndarray, n: int) -> np.ndarray:
    out = np.empty(packed.shape[0] * 2, dtype=np.uint8)
    out[0::2] = packed & np.uint8(0x0F)
    out[1::2] = packed >> np.uint8(4)
    return out[:n]
