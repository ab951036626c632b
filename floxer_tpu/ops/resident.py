"""Device-resident sequence banks + on-device kernel input preparation.

Every verification task is a (pattern, window) pair, and both are SLICES
of data the device can hold for the whole run: windows come from the
static reference, patterns from the chunk's reads. This module keeps both
resident on device as 4-bit packed rank streams and rebuilds every kernel
input on device, so a bucket ships a handful of int32 offset arrays
instead of per-task sequence copies:

  - ResidentBank: a set of rank sequences packed eight 4-bit chars per
    uint32 word (the packing of ops/banded.py), each sequence starting at
    an 8-char boundary, concatenated flat and uploaded once (reference:
    once per run; reads: once per chunk).
  - gathers: every per-task char window is one word-aligned
    lax.dynamic_slice plus an elementwise nibble funnel shift — local to
    device memory, no host round trip.
  - prep: Peq tables / banded initial state (vp0, char bit-planes) are
    rebuilt on device from the gathered pattern chars, matching
    ops/myers.py build_peq_vectorized and
    ops/banded.prepare_banded_batch bit-for-bit for every value the
    kernels consume.

Trailing gather garbage (chars past a window/pattern end, which the
host paths pad with 0 / 7) is harmless by construction: the kernels mask
scoring at text_len and never consume pattern-stream chars past m - budget
(proof notes inline below).

Replaces: the reference has no analogue — its seqan3 calls read sequences
from process RAM (alignment.cpp:83-96); here the data is already where
the compute is.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..alphabet import SIGMA
from .myers import WORD

CHARS_PER_WORD = 8
# tail padding so gathers near a bank's end never clamp their start: must
# cover the largest static gather (num_text buckets top out well below
# 256k chars = 32k words for 100k-char reads + band slack)
TAIL_PAD_WORDS = 32 * 1024


def pack_nibbles_flat(chars: np.ndarray) -> np.ndarray:
    """uint8 chars [n] -> uint32 words [ceil(n/8)], eight 4-bit nibbles per
    word, little-endian within the word (banded.pack_nibbles)."""
    n = len(chars)
    num_words = -(-n // CHARS_PER_WORD) if n else 0
    padded = np.zeros(num_words * CHARS_PER_WORD, dtype=np.uint32)
    padded[:n] = chars
    shifts = (4 * np.arange(CHARS_PER_WORD, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(
        padded.reshape(num_words, CHARS_PER_WORD) << shifts, axis=1
    )


class ResidentBank:
    """Rank sequences packed 4-bit, concatenated at 8-char boundaries.

    The layout (per-sequence base char offsets) is computed eagerly so
    callers can address slices before any device work; the packed upload
    happens on first use of `.flat` (tiny workloads that never dispatch a
    resident bucket never touch the device)."""

    def __init__(self, sequences: list[np.ndarray]):
        import threading

        self._sequences = sequences
        self.base_chars: list[int] = []
        cursor_words = 0
        for seq in sequences:
            self.base_chars.append(cursor_words * CHARS_PER_WORD)
            cursor_words += -(-len(seq) // CHARS_PER_WORD)
        self._num_words = cursor_words
        self._flat = None
        # a background preload (pipeline._get_resident_bank) may race the
        # align loop's first dispatch; the lock prevents a double build +
        # double upload of a multi-GB bank
        self._flat_lock = threading.Lock()

    def base(self, index: int) -> int:
        return self.base_chars[index]

    @property
    def flat(self) -> jax.Array:
        with self._flat_lock:
            if self._flat is None:
                # the flat length is part of every downstream jit cache
                # key: quantize it (next power of two) so banks of
                # similar size — e.g. successive read chunks — reuse
                # compiled programs instead of recompiling every bucket
                # shape per chunk
                total = self._num_words + TAIL_PAD_WORDS
                size = 1 << (total - 1).bit_length()
                words = np.zeros(size, dtype=np.uint32)
                for base, seq in zip(self.base_chars, self._sequences):
                    packed = pack_nibbles_flat(
                        np.asarray(seq, dtype=np.uint8)
                    )
                    start = base // CHARS_PER_WORD
                    words[start : start + len(packed)] = packed
                self._flat = jnp.asarray(words)
            return self._flat


def addr_arrays(char_starts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split global char offsets (int64-safe for >2G-char banks) into
    int32 (word_start, nibble_phase) pairs for the device gathers."""
    starts = np.asarray(char_starts, dtype=np.int64)
    return (
        (starts // CHARS_PER_WORD).astype(np.int32),
        (starts % CHARS_PER_WORD).astype(np.int32),
    )


def _gather_packed(flat, word_starts, phases, num_words: int):
    """[T] word-aligned slices of `num_words` words each, funnel-shifted by
    the 4-bit phase so char 0 of the result is exactly the char at the
    requested global offset. flat must carry >= num_words words of tail
    padding (TAIL_PAD_WORDS) so no slice clamps."""

    def one(word0, phase):
        w = jax.lax.dynamic_slice(flat, (word0,), (num_words + 1,))
        shift = (4 * phase).astype(jnp.uint32)
        lo = w[:-1] >> shift
        hi = w[1:] << ((jnp.uint32(32) - shift) & jnp.uint32(31))
        return jnp.where(phase == 0, w[:-1], lo | hi)

    return jax.vmap(one)(word_starts, phases)


def _unpack_codes(words):
    """uint32 [T, W] -> int32 chars [T, W*8] (values 0..15)."""
    shifts = (4 * jnp.arange(CHARS_PER_WORD, dtype=jnp.uint32))[None, None, :]
    nibbles = (words[:, :, None] >> shifts) & jnp.uint32(0xF)
    return nibbles.reshape(words.shape[0], -1).astype(jnp.int32)


def _pack_bits32(bits):
    """bool [..., W, 32] -> uint32 [..., W] little-endian within the word
    (np.packbits(bitorder='little').view('<u4') equivalent)."""
    weights = (
        jnp.uint32(1) << jnp.arange(WORD, dtype=jnp.uint32)
    )
    return jnp.sum(jnp.where(bits, weights, jnp.uint32(0)), axis=-1)


# ---------------------------------------------------------------------------
# banded kernel (ops/banded.py)
# ---------------------------------------------------------------------------


def _resident_banded_call_core(
    ref_flat,
    bank_flat,
    win_word0,
    win_phase,
    win_lens,
    pat_word0,
    pat_phase,
    stream_word0,
    stream_phase,
    pat_lens,
    budgets,
    band_words: int,
    num_text: int,
):
    """On-device rebuild of prepare_banded_batch + the banded kernel call.
    Unjitted core so fused_verify.py can inline it into a larger program.

    Equivalence notes vs the host path (all checked by
    tests/test_resident.py):
      - texts: trailing garbage past win_len instead of zero padding —
        masked by the kernel's `eligible = col < tlen` scoring gate.
      - stream: chars past m - budget are garbage instead of the host's 7
        fill — the kernel consumes stream char j only while `sliding`
        (col = j+1 <= j_star = m - budget), i.e. j < m - budget.
      - planes/vp0: identical bit patterns (masked before packing).
    """
    from .banded import banded_call

    T = win_word0.shape[0]
    num_words = num_text // CHARS_PER_WORD
    texts = _gather_packed(ref_flat, win_word0, win_phase, num_words)
    stream = _gather_packed(bank_flat, stream_word0, stream_phase, num_words)

    b_store = band_words * WORD
    pat_words = _gather_packed(
        bank_flat, pat_word0, pat_phase, b_store // CHARS_PER_WORD
    )
    pattern_codes = _unpack_codes(pat_words)  # [T, b_store]

    bit_idx = jnp.arange(b_store, dtype=jnp.int32)[None, :]
    k = budgets.astype(jnp.int32)[:, None]
    m = pat_lens.astype(jnp.int32)[:, None]
    rows = bit_idx + k - (b_store - 1)  # absolute pattern row at band pos p
    in_pat = (rows >= 1) & (rows <= m)
    gathered = jnp.take_along_axis(
        pattern_codes, jnp.clip(rows - 1, 0, b_store - 1), axis=1
    )
    codes = jnp.where(in_pat, gathered, 7)  # 7 = matches nothing
    pad_rows = rows <= 0  # all-match plane

    def pack(bits):
        return _pack_bits32(bits.reshape(T, band_words, WORD))

    planes0 = jnp.stack(
        [
            pack((codes & 1) != 0),
            pack((codes & 2) != 0),
            pack((codes & 4) != 0),
            pack(pad_rows),
        ],
        axis=1,
    )
    vp0 = pack(rows >= 1)

    scalars = (
        win_lens.astype(jnp.int32)[:, None],  # tlen
        (m - k),  # jstar
        (b_store - k),  # topshift
        (m >= b_store).astype(jnp.int32),  # mfrozen
        m,  # minit
        k,  # binit
    )
    return banded_call(
        vp0,
        planes0,
        texts,
        stream,
        scalars,
        band_words=band_words,
        num_text=num_text,
    )


_resident_banded_call = functools.partial(
    jax.jit, static_argnames=("band_words", "num_text")
)(_resident_banded_call_core)


def _resident_full_core(
    ref_flat,
    bank_flat,
    win_word0,
    win_phase,
    win_lens,
    pat_word0,
    pat_phase,
    pat_lens,
    num_words: int,
    num_text: int,
):
    """Full-state Myers on resident banks: gathers the window and pattern
    chars, rebuilds Peq on device and runs ops/myers.py — the unrolled-word
    kernel up to MAX_UNROLLED_WORDS words, the carry-scan kernel beyond.
    Returns (dist, end) row vectors [T]; fused_verify.py inlines it into
    the wave program."""
    from .myers import MAX_UNROLLED_WORDS, myers_batched, myers_batched_large

    texts = _unpack_codes(
        _gather_packed(
            ref_flat, win_word0, win_phase, num_text // CHARS_PER_WORD
        )
    )  # [T, num_text] int32; garbage past win_len masked by eligibility
    pattern_codes = _unpack_codes(
        _gather_packed(
            bank_flat, pat_word0, pat_phase, num_words * WORD // CHARS_PER_WORD
        )
    )
    peq = _device_peq(pattern_codes, pat_lens, num_words)  # [T, SIGMA, W]
    kernel = (
        myers_batched if num_words <= MAX_UNROLLED_WORDS
        else myers_batched_large
    )
    return kernel(
        peq,
        pat_lens.astype(jnp.int32),
        texts,
        win_lens.astype(jnp.int32),
        num_words=num_words,
    )


_resident_full_call = functools.partial(
    jax.jit, static_argnames=("num_words", "num_text")
)(_resident_full_core)


def myers_banded_resident(
    ref_bank: ResidentBank,
    query_bank: ResidentBank,
    win_starts: np.ndarray,  # int64 global char offsets into ref_bank
    win_lens: np.ndarray,
    pat_starts: np.ndarray,  # int64 global char offsets into query_bank
    pat_lens: np.ndarray,
    budgets: np.ndarray,
    band_words: int,
    num_text: int,
    sync: bool = True,
):
    """Drop-in for banded.myers_banded_device with offsets instead of
    arrays. Requires 0 < budget < m per task (the caller pads the batch
    with dummy rows m=2, budget=1, offsets 0)."""
    # the kernels consume 8 packed chars per word; round up (gathers just
    # read tail-padded words)
    num_text = -(-num_text // CHARS_PER_WORD) * CHARS_PER_WORD

    win_word0, win_phase = addr_arrays(win_starts)
    pat_word0, pat_phase = addr_arrays(pat_starts)
    stream_word0, stream_phase = addr_arrays(
        np.asarray(pat_starts, dtype=np.int64)
        + np.asarray(budgets, dtype=np.int64)
    )
    dist, end = _resident_banded_call(
        ref_bank.flat,
        query_bank.flat,
        jnp.asarray(win_word0),
        jnp.asarray(win_phase),
        jnp.asarray(win_lens, dtype=jnp.int32),
        jnp.asarray(pat_word0),
        jnp.asarray(pat_phase),
        jnp.asarray(stream_word0),
        jnp.asarray(stream_phase),
        jnp.asarray(pat_lens, dtype=jnp.int32),
        jnp.asarray(budgets, dtype=jnp.int32),
        band_words=band_words,
        num_text=num_text,
    )
    if not sync:
        return dist[:, 0], end[:, 0]
    return np.asarray(dist)[:, 0], np.asarray(end)[:, 0]


# ---------------------------------------------------------------------------
# full-state kernels (ops/myers.py)
# ---------------------------------------------------------------------------


def _device_peq(pattern_codes, pat_lens, num_words: int):
    """[T, SIGMA, W] uint32 Peq from gathered pattern chars; identical to
    build_peq_vectorized (chars past pat_len are masked out)."""
    T = pattern_codes.shape[0]
    idx = jnp.arange(num_words * WORD, dtype=jnp.int32)[None, :]
    valid = idx < pat_lens.astype(jnp.int32)[:, None]
    planes = []
    for s in range(SIGMA):
        bits = (pattern_codes == s) & valid
        planes.append(_pack_bits32(bits.reshape(T, num_words, WORD)))
    return jnp.stack(planes, axis=1)


def myers_full_resident(
    ref_bank: ResidentBank,
    query_bank: ResidentBank,
    win_starts: np.ndarray,
    win_lens: np.ndarray,
    pat_starts: np.ndarray,
    pat_lens: np.ndarray,
    m_bucket: int,
    num_text: int,
    sync: bool = True,
):
    """Drop-in for myers_distance with offsets instead of arrays. The
    caller pads the batch with dummy rows (lens 1, offsets 0)."""
    assert num_text % CHARS_PER_WORD == 0

    win_word0, win_phase = addr_arrays(win_starts)
    pat_word0, pat_phase = addr_arrays(pat_starts)
    dist, end = _resident_full_call(
        ref_bank.flat,
        query_bank.flat,
        jnp.asarray(win_word0),
        jnp.asarray(win_phase),
        jnp.asarray(win_lens, dtype=jnp.int32),
        jnp.asarray(pat_word0),
        jnp.asarray(pat_phase),
        jnp.asarray(pat_lens, dtype=jnp.int32),
        num_words=-(-m_bucket // WORD),
        num_text=num_text,
    )
    if not sync:
        return dist, end
    return np.asarray(dist), np.asarray(end)
