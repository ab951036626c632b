"""Banded sliding-window Myers edit distance on the device.

The production verification kernel for tasks whose band is narrower than
their pattern (PEX roots and large inner nodes): carries Myers state only
for the exactness band of B = n - m + 2*budget + 1 rows (see
ops/myers_banded.py for the algorithm and the proof that results are
byte-equivalent to the full DP for every value the pipeline consumes).

Two implementations of one contract; `banded_call` picks one from the
platform and the band width (`implementation`):

  - "cuda": the Hopper kernel of native/myers_banded.cu through jax.ffi
    (ops/banded_cuda.py), one warp per task with the band in registers;
  - "xla": `_banded_xla` below, the same recurrence as plain jnp over
    [T, band_words] arrays inside one lax.fori_loop over text columns.
    It runs on the CPU (tests, --engine device on a CPU host) and for
    bands wider than the CUDA kernel holds in registers.

Differences from the numpy mirror:

  - the band stops sliding once its bottom row reaches the pattern end m
    (column j_star = m - budget). From then on the stored rows are a fixed
    superset of the needed band (proof in mirror docstring notes), and the
    score of row m rides the STATIC top bit of the last band word.
  - pattern band rows are stored as THREE char bit-planes plus one
    all-match plane (rows <= 0) instead of six per-symbol Peq masks:
    Eq = XNOR-reduce of the planes against the text char's bits.

Host-side preparation (prepare_banded_batch) packs, per task: initial
VP/plane band words, the entering-row char stream (pattern chars from row
budget+1 on; 7 = matches nothing past the pattern end), and the scalars
(text length, j_star, carry-pessimism thresholds).

Text and stream chars are 4-bit nibbles, eight per uint32 word,
little-endian within the word: the packing of the device-resident
sequence banks (ops/resident.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .banded_cuda import BAND_WORDS_QUANTUM, MAX_BAND_WORDS
from .myers import WORD

# batches are padded to a multiple of this many tasks, so the set of
# compiled shapes stays small
GROUP = 8
CHARS_PER_WORD = 8
TOP_BIT = np.uint32(0x80000000)


def implementation(band_words: int) -> str:
    """The implementation for this band width: "cuda" on a GPU for bands
    the CUDA kernel holds, "xla" otherwise."""
    from ..backend import accelerator

    if accelerator() and band_words <= MAX_BAND_WORDS:
        return "cuda"
    return "xla"


def banded_call(vp0, planes0, texts, stream, scalars, band_words, num_text):
    """(dist, end), int32 [T, 1] each, for prepared banded tasks.

    vp0 uint32 [T, band_words], planes0 uint32 [T, 4, band_words], texts
    and stream uint32 [T, num_text / 8] (nibble-packed), scalars six
    int32 [T, 1] arrays (tlen, j_star, top_shift, m_frozen, m, budget).
    Traceable: fused_verify.py calls it inside its wave program."""
    if implementation(band_words) == "cuda":
        from .banded_cuda import banded_cuda_call

        return banded_cuda_call(vp0, planes0, texts, stream, scalars)
    return _banded_xla(
        vp0, planes0, texts, stream, scalars,
        band_words=band_words, num_text=num_text,
    )


@functools.partial(jax.jit, static_argnames=("band_words", "num_text"))
def _banded_xla(vp0, planes0, texts, stream, scalars, band_words, num_text):
    tlen, jstar, top_shift, m_frozen, m_init, b_init = (
        jnp.reshape(s, (-1,)).astype(jnp.int32) for s in scalars
    )
    T = vp0.shape[0]
    BW = band_words
    one = jnp.uint32(1)
    ones = jnp.uint32(0xFFFFFFFF)
    zero_word = jnp.zeros((T, 1), dtype=jnp.uint32)
    word_ids = jnp.arange(BW)[None, :]
    last_word = word_ids == BW - 1
    first_word = word_ids == 0

    def from_next(x):
        """Word p+1's value at word p, 0 at the last word."""
        return jnp.concatenate([x[:, 1:], zero_word], axis=1)

    def from_prev(x, distance=1):
        """Word p-distance's value at word p, 0 below word `distance`."""
        return jnp.concatenate(
            [jnp.zeros((T, distance), dtype=x.dtype), x[:, :-distance]], axis=1
        )

    def top_bit_if(cond):
        """TOP_BIT at the last word where cond [T] holds, else 0."""
        return jnp.where(last_word & cond[:, None], TOP_BIT, jnp.uint32(0))

    def column(col, tch, pch, state):
        vp, vn, p0, p1, p2, am, s_bot, s_m, best, best_end = state
        sliding = col <= jstar  # [T]
        slide_rows = sliding[:, None]

        # --- band slide one row down; the entering bottom row gets a
        # pessimistic VP and its pattern char's plane bits
        def slide(x, entering):
            shifted = (x >> one) | (from_next(x & one) << 31) | entering
            return jnp.where(slide_rows, shifted, x)

        vp = slide(vp, top_bit_if(jnp.ones_like(sliding)))
        vn = slide(vn, jnp.uint32(0))
        p0 = slide(p0, top_bit_if((pch & 1) != 0))
        p1 = slide(p1, top_bit_if((pch & 2) != 0))
        p2 = slide(p2, top_bit_if((pch & 4) != 0))
        am = slide(am, jnp.uint32(0))
        s_bot = s_bot + sliding.astype(jnp.int32)

        # --- Eq from char bit-planes: XNOR-reduce against the text char
        def plane_match(plane, bit):
            return jnp.where(((tch & bit) != 0)[:, None], plane, ~plane)

        eq = (plane_match(p0, 1) & plane_match(p1, 2) & plane_match(p2, 4)) | am

        # --- Myers column update; carries of (Eq & VP) + VP across words
        xv = eq | vn
        a = eq & vp
        t = a + vp
        generate = (t < a).astype(jnp.uint32)
        propagate = (t == ones).astype(jnp.uint32)
        distance = 1  # Kogge-Stone prefix scan of (generate, propagate)
        while distance < BW:
            generate = generate | (propagate & from_prev(generate, distance))
            propagate = propagate & from_prev(propagate, distance)
            distance *= 2
        summ = t + from_prev(generate)
        xh = (summ ^ vp) | eq
        ph = vn | ~(xh | vp)
        mh = vp & xh

        # --- score deltas at the static band-bottom bit
        d_bot = (ph[:, -1] >> 31).astype(jnp.int32) - (
            mh[:, -1] >> 31
        ).astype(jnp.int32)
        s_bot = s_bot + d_bot
        s_m = jnp.where(col == jstar, s_bot, s_m + jnp.where(sliding, 0, d_bot))

        # --- horizontal shift down one row; the entering top delta is +1
        # (pessimistic) once the top stored row is real, else 0
        pessimistic = jnp.where(sliding, col >= top_shift, m_frozen != 0)
        ph_in = jnp.where(first_word & pessimistic[:, None], one, jnp.uint32(0))
        ph_sh = (ph << one) | from_prev(ph >> 31) | ph_in
        mh_sh = (mh << one) | from_prev(mh >> 31)
        vp = mh_sh | ~(xv | ph_sh)
        vn = ph_sh & xv

        improves = (col < tlen) & (col >= jstar) & (s_m <= best)
        best = jnp.where(improves, s_m, best)
        best_end = jnp.where(improves, col, best_end)
        return vp, vn, p0, p1, p2, am, s_bot, s_m, best, best_end

    def step(j, state):
        word = j // CHARS_PER_WORD
        shift = (4 * (j % CHARS_PER_WORD)).astype(jnp.uint32)
        text_word = jax.lax.dynamic_index_in_dim(texts, word, 1, keepdims=False)
        stream_word = jax.lax.dynamic_index_in_dim(
            stream, word, 1, keepdims=False
        )
        return column(
            j + 1,
            (text_word >> shift) & jnp.uint32(0xF),
            (stream_word >> shift) & jnp.uint32(0xF),
            state,
        )

    state = (
        vp0,
        jnp.zeros_like(vp0),
        planes0[:, 0, :],
        planes0[:, 1, :],
        planes0[:, 2, :],
        planes0[:, 3, :],
        b_init,
        m_init,
        m_init,
        jnp.zeros_like(m_init),
    )
    # only columns col = j + 1 < max(tlen) can score: later ones are dead
    columns_needed = jnp.clip(jnp.max(tlen) - 1, 0, num_text)
    state = jax.lax.fori_loop(0, columns_needed, step, state)
    best, best_end = state[8], state[9]
    return best[:, None], best_end[:, None]


_banded_jit = jax.jit(banded_call, static_argnames=("band_words", "num_text"))


def pack_nibbles(chars: np.ndarray) -> np.ndarray:
    """Chars [T, Np] with values 0..15 (Np % 8 == 0) -> uint32 [T, Np/8],
    eight 4-bit nibbles per word, little-endian within the word."""
    T, Np = chars.shape
    arr = chars.reshape(T, Np // CHARS_PER_WORD, CHARS_PER_WORD).astype(
        np.uint32
    )
    shifts = (4 * np.arange(CHARS_PER_WORD, dtype=np.uint32))[None, None, :]
    return np.bitwise_or.reduce(arr << shifts, axis=2)


def prepare_banded_batch(
    patterns: list[np.ndarray],
    budgets: np.ndarray,
    band_words: int,
    num_text: int,
):
    """Vectorized host packing of per-task banded state.

    band_words/num_text are the bucket's static shape (band_words a
    multiple of BAND_WORDS_QUANTUM covering every task's nominal band;
    num_text a multiple of 8). The returned stream is nibble-packed (see
    module docstring)."""
    T = len(patterns)
    b_store = band_words * WORD
    vp0 = np.zeros((T, band_words), dtype=np.uint32)
    planes0 = np.zeros((T, 4, band_words), dtype=np.uint32)
    stream = np.full((T, num_text), 7, dtype=np.uint8)
    tlen = np.zeros((T, 1), dtype=np.int32)
    jstar = np.zeros((T, 1), dtype=np.int32)
    topshift = np.zeros((T, 1), dtype=np.int32)
    mfrozen = np.zeros((T, 1), dtype=np.int32)
    minit = np.zeros((T, 1), dtype=np.int32)
    binit = np.zeros((T, 1), dtype=np.int32)

    bit_idx = np.arange(b_store)

    def pack_bits(bits: np.ndarray) -> np.ndarray:
        """bool [b_store] -> little-endian uint32 words [bw]."""
        return np.packbits(bits, bitorder="little").view("<u4")

    for t, pattern in enumerate(patterns):
        m = len(pattern)
        k = int(budgets[t])
        rows = bit_idx + k - (b_store - 1)  # absolute row at band pos p
        vp0[t] = pack_bits(rows >= 1)
        pad_rows = rows <= 0
        in_pat = (rows >= 1) & (rows <= m)
        codes = np.full(b_store, 7, dtype=np.int64)  # matches nothing
        codes[in_pat] = pattern[np.clip(rows[in_pat] - 1, 0, m - 1)]
        for i in range(3):
            planes0[t, i] = pack_bits(((codes >> i) & 1) != 0)
        planes0[t, 3] = pack_bits(pad_rows)
        n_stream = min(num_text, max(0, m - k))
        if n_stream > 0:
            stream[t, :n_stream] = pattern[k : k + n_stream]
        jstar[t, 0] = m - k
        topshift[t, 0] = b_store - k
        mfrozen[t, 0] = 1 if m >= b_store else 0
        minit[t, 0] = m
        binit[t, 0] = k
    packed_stream = pack_nibbles(stream)
    return vp0, planes0, packed_stream, (
        tlen, jstar, topshift, mfrozen, minit, binit
    )


def myers_banded_device(
    patterns: list[np.ndarray],
    texts: np.ndarray,  # [T, Np] padded uint8
    text_lengths: np.ndarray,
    budgets: np.ndarray,
    band_words: int,
    sync: bool = True,
):
    """Banded kernel on host-packed inputs: returns (distance, end_col)
    per task, with the exactness contract of ops/myers_banded.py. Requires
    0 < budget < m and band_words*32 >= n - m + 2*budget + 1 for every
    task."""
    T = len(patterns)
    Np = texts.shape[1]
    num_text = -(-Np // CHARS_PER_WORD) * CHARS_PER_WORD

    vp0, planes0, stream, scalars = prepare_banded_batch(
        patterns, budgets, band_words, num_text
    )
    scalars[0][:, 0] = text_lengths

    texts_u8 = np.zeros((T, num_text), dtype=np.uint8)
    texts_u8[:, :Np] = texts
    dist, end = _banded_jit(
        jnp.asarray(vp0),
        jnp.asarray(planes0),
        jnp.asarray(pack_nibbles(texts_u8)),
        jnp.asarray(stream),
        tuple(jnp.asarray(s) for s in scalars),
        band_words=band_words,
        num_text=num_text,
    )
    if not sync:
        return dist[:, 0], end[:, 0]
    return np.asarray(dist)[:, 0], np.asarray(end)[:, 0]
