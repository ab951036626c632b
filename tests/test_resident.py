"""Device-resident gather path (ops/resident.py) vs the host slice paths.

The resident entry points must return bit-identical (distance, end) to the
host-packing kernels for every task — they are the same kernels fed by
on-device gathers. Runs the plain-XLA kernels on the CPU backend
(conftest)."""

import numpy as np
import pytest

import jax.numpy as jnp

from floxer_tpu.ops.banded import myers_banded_device
from floxer_tpu.ops.device_dp import pad_batch
from floxer_tpu.ops.myers import myers_distance
from floxer_tpu.ops.myers_banded import band_store_bits
from floxer_tpu.ops.resident import (
    ResidentBank,
    _gather_packed,
    addr_arrays,
    myers_banded_resident,
    myers_full_resident,
    pack_nibbles_flat,
)


def make_banks(rng, num_refs=3, num_reads=4, ref_len=2000, read_len=300):
    refs = [
        rng.integers(0, 6, size=int(rng.integers(ref_len // 2, ref_len)))
        .astype(np.uint8)
        for _ in range(num_refs)
    ]
    reads = [
        rng.integers(0, 6, size=int(rng.integers(read_len // 2, read_len)))
        .astype(np.uint8)
        for _ in range(num_reads)
    ]
    return refs, ResidentBank(refs), reads, ResidentBank(reads)


def test_gather_matches_host_packing():
    rng = np.random.default_rng(0)
    refs, ref_bank, _, _ = make_banks(rng)
    num_words = 16
    starts, slices = [], []
    for _ in range(20):
        ref_id = int(rng.integers(0, len(refs)))
        off = int(rng.integers(0, len(refs[ref_id]) - 1))
        starts.append(ref_bank.base(ref_id) + off)
        chars = np.zeros(num_words * 8, dtype=np.uint8)
        avail = refs[ref_id][off : off + num_words * 8]
        chars[: len(avail)] = avail
        slices.append(pack_nibbles_flat(chars))
    word0, phase = addr_arrays(np.asarray(starts))
    got = np.asarray(
        _gather_packed(
            ref_bank.flat, jnp.asarray(word0), jnp.asarray(phase), num_words
        )
    )
    for i, want in enumerate(slices):
        # chars past the sequence end are garbage in the gather; compare
        # only the in-sequence prefix nibble-by-nibble
        ref_id = int(np.searchsorted(
            [b + 1 for b in ref_bank.base_chars], starts[i]
        )) - 1
        valid = len(refs[ref_id]) - (starts[i] - ref_bank.base(ref_id))
        valid = min(valid, num_words * 8)
        got_chars = (
            (got[i][:, None] >> (4 * np.arange(8, dtype=np.uint32))) & 0xF
        ).reshape(-1)
        want_chars = (
            (want[:, None] >> (4 * np.arange(8, dtype=np.uint32))) & 0xF
        ).reshape(-1)
        np.testing.assert_array_equal(
            got_chars[:valid], want_chars[:valid], err_msg=f"slice {i}"
        )


def _random_tasks(rng, refs, ref_bank, reads, query_bank, count=8):
    """Random (pattern slice of a read, window slice of a ref) tasks."""
    tasks = []
    for _ in range(count):
        read_id = int(rng.integers(0, len(reads)))
        read = reads[read_id]
        m = int(rng.integers(40, min(200, len(read))))
        pfrom = int(rng.integers(0, len(read) - m + 1))
        budget = int(rng.integers(1, max(2, m // 6)))
        ref_id = int(rng.integers(0, len(refs)))
        ref = refs[ref_id]
        n = min(m + 2 * budget + int(rng.integers(0, 30)), len(ref))
        wfrom = int(rng.integers(0, len(ref) - n + 1))
        tasks.append(
            dict(
                pattern=read[pfrom : pfrom + m],
                window=ref[wfrom : wfrom + n],
                budget=budget,
                pat_addr=query_bank.base(read_id) + pfrom,
                win_addr=ref_bank.base(ref_id) + wfrom,
            )
        )
    return tasks


@pytest.mark.parametrize("seed", range(2))
def test_banded_resident_matches_host(seed):
    rng = np.random.default_rng(seed)
    refs, ref_bank, reads, query_bank = make_banks(rng)
    tasks = _random_tasks(rng, refs, ref_bank, reads, query_bank)

    band_bits = max(
        band_store_bits(len(t["pattern"]), len(t["window"]), t["budget"])
        for t in tasks
    )
    band_words = -(-(-(-band_bits // 32)) // 128) * 128
    txt, tlen = pad_batch([t["window"] for t in tasks])
    budgets = np.asarray([t["budget"] for t in tasks])
    want_d, want_e = myers_banded_device(
        [t["pattern"] for t in tasks], txt, tlen, budgets, band_words
    )

    from floxer_tpu.ops.banded import GROUP

    T = 2 * GROUP  # a padded batch, as the callers build it
    num_text = -(-txt.shape[1] // 1024) * 1024
    win_starts = np.zeros(T, dtype=np.int64)
    win_lens = np.ones(T, dtype=np.int64)
    pat_starts = np.zeros(T, dtype=np.int64)
    pat_lens = np.full(T, 2, dtype=np.int64)
    pads = np.ones(T, dtype=np.int64)
    for i, t in enumerate(tasks):
        win_starts[i] = t["win_addr"]
        win_lens[i] = len(t["window"])
        pat_starts[i] = t["pat_addr"]
        pat_lens[i] = len(t["pattern"])
        pads[i] = t["budget"]
    got_d, got_e = myers_banded_resident(
        ref_bank, query_bank, win_starts, win_lens, pat_starts, pat_lens,
        pads, band_words=band_words, num_text=num_text,
    )
    np.testing.assert_array_equal(got_d[: len(tasks)], want_d)
    np.testing.assert_array_equal(got_e[: len(tasks)], want_e)


def test_full_small_resident_matches_host():
    rng = np.random.default_rng(3)
    refs, ref_bank, reads, query_bank = make_banks(rng)
    tasks = _random_tasks(rng, refs, ref_bank, reads, query_bank, count=6)

    pat, plen = pad_batch([t["pattern"] for t in tasks])
    txt, tlen = pad_batch([t["window"] for t in tasks])
    want_d, want_e = (np.asarray(x) for x in myers_distance(pat, plen, txt, tlen))

    T = 16  # a padded batch, as the callers build it
    m_bucket = -(-pat.shape[1] // 128) * 128
    assert m_bucket <= 256, "stay on the small-kernel route"
    num_text = -(-txt.shape[1] // 8) * 8
    win_starts = np.zeros(T, dtype=np.int64)
    win_lens = np.ones(T, dtype=np.int64)
    pat_starts = np.zeros(T, dtype=np.int64)
    pat_lens = np.ones(T, dtype=np.int64)
    for i, t in enumerate(tasks):
        win_starts[i] = t["win_addr"]
        win_lens[i] = len(t["window"])
        pat_starts[i] = t["pat_addr"]
        pat_lens[i] = len(t["pattern"])
    got_d, got_e = myers_full_resident(
        ref_bank, query_bank, win_starts, win_lens, pat_starts, pat_lens,
        m_bucket=m_bucket, num_text=num_text,
    )
    np.testing.assert_array_equal(got_d[: len(tasks)], want_d)
    np.testing.assert_array_equal(got_e[: len(tasks)], want_e)


def test_full_large_resident_matches_host():
    rng = np.random.default_rng(4)
    refs, ref_bank, reads, query_bank = make_banks(
        rng, ref_len=3000, read_len=900
    )
    tasks = []
    for _ in range(3):
        read_id = int(rng.integers(0, len(reads)))
        read = reads[read_id]
        m = int(rng.integers(300, len(read)))
        pfrom = int(rng.integers(0, len(read) - m + 1))
        ref_id = int(rng.integers(0, len(refs)))
        ref = refs[ref_id]
        n = min(m + 60, len(ref))
        wfrom = int(rng.integers(0, len(ref) - n + 1))
        tasks.append(
            dict(
                pattern=read[pfrom : pfrom + m],
                window=ref[wfrom : wfrom + n],
                pat_addr=query_bank.base(read_id) + pfrom,
                win_addr=ref_bank.base(ref_id) + wfrom,
            )
        )

    pat, plen = pad_batch([t["pattern"] for t in tasks])
    txt, tlen = pad_batch([t["window"] for t in tasks])
    want_d, want_e = (np.asarray(x) for x in myers_distance(pat, plen, txt, tlen))

    T = 8  # a padded batch, as the callers build it
    m_bucket = -(-pat.shape[1] // 128) * 128
    assert m_bucket > 256, "stay on the large-kernel route"
    num_text = -(-txt.shape[1] // 128) * 128
    win_starts = np.zeros(T, dtype=np.int64)
    win_lens = np.ones(T, dtype=np.int64)
    pat_starts = np.zeros(T, dtype=np.int64)
    pat_lens = np.ones(T, dtype=np.int64)
    for i, t in enumerate(tasks):
        win_starts[i] = t["win_addr"]
        win_lens[i] = len(t["window"])
        pat_starts[i] = t["pat_addr"]
        pat_lens[i] = len(t["pattern"])
    got_d, got_e = myers_full_resident(
        ref_bank, query_bank, win_starts, win_lens, pat_starts, pat_lens,
        m_bucket=m_bucket, num_text=num_text,
    )
    np.testing.assert_array_equal(got_d[: len(tasks)], want_d)
    np.testing.assert_array_equal(got_e[: len(tasks)], want_e)
