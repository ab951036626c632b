"""Multi-host orchestration: read sharding and output merging.

The reference is strictly single-process (SURVEY.md section 2.4); floxer-tpu
scales across hosts with:

  - deterministic strided READ SHARDING: host h of H processes the queries
    whose internal id i satisfies i % H == h. Every host streams the same
    FASTQ and skips foreign records — no coordination, no manifest, and
    global internal ids (and with them output determinism) are preserved.
  - per-host shard outputs merged into one canonical SAM/BAM ordered by
    query internal id: because shards are strided, the merge is a
    round-robin interleave of per-query record groups. On a real cluster
    this runs on host 0 after a barrier (jax.experimental.multihost_utils);
    the same merge is exposed as `floxer_tpu.tools.merge_sam` for
    file-based workflows.
  - statistics merge: SearchAndAlignmentStatistics arrays are psum-mergeable
    (stats.merge_other_into_this on gathered TOML dicts, or psum of the
    histogram arrays on device).

CLI: --num-hosts / --host-id select the shard (default 1/0: single host).
"""

from __future__ import annotations

from typing import Iterable, Iterator


def shard_queries(
    queries: Iterable, host_id: int, num_hosts: int
) -> Iterator:
    """Strided query sharding by internal id (deterministic across hosts)."""
    for query in queries:
        if query.internal_id % num_hosts == host_id:
            yield query


def shard_output_path(path: str, host_id: int) -> str:
    """Per-process shard file next to the requested output, extension
    preserved so the SAM/BAM writer selection is unchanged:
    out.sam -> out.shard3.sam."""
    import os

    base, ext = os.path.splitext(path)
    return f"{base}.shard{host_id}{ext}"


_initialized = False


def maybe_initialize_distributed() -> tuple[int, int]:
    """Initialize jax.distributed from the standard env variables when a
    coordinator is configured; returns (process_index, process_count).

    Must run before any jax backend initialization. Safe to call again in
    the same process (returns the live process set)."""
    import os

    global _initialized
    coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator:
        return 0, 1
    import jax

    if not _initialized:
        kwargs = {}
        if os.environ.get("JAX_NUM_PROCESSES"):
            kwargs = dict(
                coordinator_address=coordinator,
                num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
                process_id=int(os.environ["JAX_PROCESS_ID"]),
            )
        jax.distributed.initialize(**kwargs)
        # multi-process CPU backends need a collectives implementation;
        # harmless (unused) on accelerator backends
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:  # noqa: BLE001 - older/newer jax without the knob
            pass
        _initialized = True
    # report from the distributed service state, NOT jax.process_count():
    # the latter initializes the backend, and callers must get to pick the
    # platform (ensure_backend) AFTER joining the process set
    from jax._src.distributed import global_state

    return int(global_state.process_id), int(global_state.num_processes)


def _read_sam_query_groups(path):
    """Yield (header_lines, groups) where groups are per-query record runs
    in file order."""
    header = []
    groups = []
    current_qname = None
    with open(path) as handle:
        for line in handle:
            line = line.rstrip("\n")
            if line.startswith("@"):
                header.append(line)
                continue
            qname = line.split("\t", 1)[0]
            if qname != current_qname:
                groups.append((qname, []))
                current_qname = qname
            groups[-1][1].append(line)
    return header, groups


def merge_sam_shards(shard_paths: list[str], output_path: str) -> int:
    """Round-robin interleave of strided shards into one SAM ordered by
    query internal id. Returns the number of merged queries."""
    shards = [_read_sam_query_groups(path) for path in shard_paths]
    header = shards[0][0]
    for other_header, _ in shards[1:]:
        if other_header != header:
            raise ValueError("shard headers disagree; not outputs of one run")

    groups = [groups for _, groups in shards]
    positions = [0] * len(shards)
    total = 0
    with open(output_path, "w") as out:
        for line in header:
            out.write(line + "\n")
        exhausted = 0
        shard = 0
        while exhausted < len(shards):
            if positions[shard] < len(groups[shard]):
                _, lines = groups[shard][positions[shard]]
                for line in lines:
                    out.write(line + "\n")
                positions[shard] += 1
                total += 1
                exhausted = 0
            else:
                exhausted += 1
            shard = (shard + 1) % len(shards)
    return total


class _BamShardCursor:
    """Streaming per-query-group cursor over a BGZF BAM shard. Decompresses
    incrementally through gzip.GzipFile so at most one group's record blobs
    (block_size prefix included, byte-for-byte) are resident — the merge of
    large-run shards must not hold every shard fully decompressed at once.
    `header_blob` is the raw uncompressed bytes from the BAM magic through
    the reference list."""

    def __init__(self, path):
        import gzip
        import struct

        self._struct = struct
        self._fh = gzip.open(path, "rb")
        magic = self._exact(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path} is not a BAM file")
        l_text = struct.unpack("<i", self._exact(4))[0]
        text = self._exact(l_text)
        n_ref_raw = self._exact(4)
        n_ref = struct.unpack("<i", n_ref_raw)[0]
        refs = bytearray()
        for _ in range(n_ref):
            l_name_raw = self._exact(4)
            l_name = struct.unpack("<i", l_name_raw)[0]
            refs += l_name_raw + self._exact(l_name + 4)
        self.header_blob = (
            magic + struct.pack("<i", l_text) + text + n_ref_raw + bytes(refs)
        )
        self._pending = self._next_blob()

    def _exact(self, n):
        data = self._fh.read(n)
        if len(data) != n:
            raise ValueError("truncated BAM stream")
        return data

    def _next_blob(self):
        size_raw = self._fh.read(4)
        if not size_raw:
            return None
        block_size = self._struct.unpack("<i", size_raw)[0]
        return size_raw + self._exact(block_size)

    @staticmethod
    def _qname(blob):
        l_read_name = blob[4 + 8]
        return blob[4 + 32 : 4 + 32 + l_read_name - 1]

    def next_group(self):
        """Next per-query run of record blobs, or None at end of shard."""
        if self._pending is None:
            return None
        qname = self._qname(self._pending)
        blobs = [self._pending]
        while True:
            blob = self._next_blob()
            if blob is None or self._qname(blob) != qname:
                self._pending = blob
                return blobs
            blobs.append(blob)

    def close(self):
        self._fh.close()


def merge_bam_shards(shard_paths: list[str], output_path: str) -> int:
    """Round-robin interleave of strided BAM shards into one BGZF BAM
    ordered by query internal id (the BAM counterpart of merge_sam_shards;
    reference writes BAM directly in all modes, output.cpp:25-108).
    Record blobs are copied byte-for-byte; only the BGZF framing is new.
    Shards are streamed group-by-group (never fully resident).
    Returns the number of merged queries."""
    from ..io.sam import _BgzfWriter

    shards = [_BamShardCursor(path) for path in shard_paths]
    try:
        header = shards[0].header_blob
        for other in shards[1:]:
            if other.header_blob != header:
                raise ValueError(
                    "shard headers disagree; not outputs of one run"
                )

        total = 0
        writer = _BgzfWriter(open(output_path, "wb"))
        try:
            writer.write(header)
            exhausted = 0
            shard = 0
            while exhausted < len(shards):
                blobs = shards[shard].next_group()
                if blobs is not None:
                    for blob in blobs:
                        writer.write(blob)
                    total += 1
                    exhausted = 0
                else:
                    exhausted += 1
                shard = (shard + 1) % len(shards)
        finally:
            writer.close()
    finally:
        for cursor in shards:
            cursor.close()
    return total
