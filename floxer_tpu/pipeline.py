"""End-to-end alignment pipeline.

Replaces the reference's thread-pool task runtime (src/lib/parallelization.cpp)
with a streaming host pipeline: the search/verify stages below operate on one
query at a time in the reference-semantics host path, and on padded query
batches in the device path (see parallel/ and ops/), where search is batched
FM-index gathers and verification is the banded Myers kernel. Per-query
logic (PEX tree, packages, per-orientation interval caches, output record
grouping) mirrors parallelization.cpp:45-293.
"""

from __future__ import annotations

import logging
import sys
import time

from .cli import CommandLineInput
from .index.fmindex import DEFAULT_SAMPLING_RATE, FmIndex
from .intervals import create_verified_intervals_per_reference
from .io.sam import AlignmentOutput
from .io.sequence_io import Queries, QueryRecord, References, read_references
from .ops.dp_reference import Orientation
from .output import write_alignments_for_query
from .pex import BuildStrategy, cached_pex_tree
from .search_host import (
    AnchorChoiceStrategy,
    AnchorGroupOrder,
    SearchConfig,
    Searcher,
)
from .io import sequence_io
from .stats import SearchAndAlignmentStatistics
from .verify import QueryAlignments, QueryVerifier, VerificationKind

logger = logging.getLogger("floxer-tpu")


_ACCELERATOR_AVAILABLE: bool | None = None


def _accelerator_available() -> bool:
    """True when a GPU backend is live, so the default (batched) engine can
    run its verification kernels on the card. CPU-only hosts keep the host
    DP path, which preserves byte-identical behavior in the test
    environment without paying XLA compile latency for tiny workloads. A
    GPU that fails to initialize raises (backend.ensure_backend)."""
    global _ACCELERATOR_AVAILABLE
    if _ACCELERATOR_AVAILABLE is None:
        from .backend import accelerator

        _ACCELERATOR_AVAILABLE = accelerator()
    return _ACCELERATOR_AVAILABLE


_WARMUP_STARTED = False
_WARMUP_THREAD = None
# set by server.serve(): the process hosts many jobs, so per-run shutdown
# steps (warmup abort) must not run — the warmup persists across jobs
_PERSISTENT_PROCESS = False
# set when the process is about to exit: the warmup stops issuing new
# device work
_WARMUP_ABORT = __import__("threading").Event()
# (programs_ok, fused_plans_ok) from the warmup's warm-shape replay; None
# until the replay has run. The server reports this as its readiness line
# so deployments can block until >=1 compiled fused plan is live on the
# device (VERDICT r4 item 2).
_WARM_REPLAY_RESULT = None
# the exception that ended the warmup thread, if any (see _accelerator_ready)
_WARMUP_ERROR = None

# server-process cache of the device-resident reference bank, keyed by
# reference file identity (path, size, mtime): jobs against the same
# genome reuse the uploaded bank instead of re-paying the packed upload.
# One entry: the service caches one genome at a time.
_RESIDENT_BANK_CACHE: dict = {}


def _get_resident_bank(cli, references):
    import os

    from .ops.resident import ResidentBank

    key = None
    try:
        stat = os.stat(cli.reference_path)
        key = (str(cli.reference_path), stat.st_size, stat.st_mtime_ns)
    except OSError:
        pass
    if key is not None and key in _RESIDENT_BANK_CACHE:
        logger.debug("resident reference bank: cache hit (%s)", key[0])
        return _RESIDENT_BANK_CACHE[key]
    bank = ResidentBank(
        [record.rank_sequence for record in references.records]
    )
    if key is not None and _PERSISTENT_PROCESS:
        _RESIDENT_BANK_CACHE.clear()
        _RESIDENT_BANK_CACHE[key] = bank

        # kick the packed upload NOW on a background thread so it
        # overlaps the job's index load and first search chunks instead
        # of stalling the first device wave. Guarded by the warmup's
        # readiness so a CPU-only server never touches an accelerator.
        import threading

        def preload() -> None:
            try:
                _join_device_warmup(timeout=600)
                if _ACCELERATOR_AVAILABLE:
                    bank.flat.block_until_ready()
                    logger.debug("resident bank preloaded to device")
            except Exception as error:  # noqa: BLE001 - best-effort
                logger.debug("resident bank preload failed: %s", error)

        threading.Thread(
            target=preload, name="bank-preload", daemon=True
        ).start()
    return bank


def _start_device_warmup() -> None:
    """Fire a tiny kernel on a daemon thread so the backend's one-time
    first-execution cost (and, on a GPU, the build of the CUDA banded
    kernel) overlaps the first chunk's host search instead of stalling the
    first verification wave. Safe to call repeatedly; only the first call
    acts."""
    global _WARMUP_STARTED
    if _WARMUP_STARTED:
        return
    _WARMUP_STARTED = True

    def warm() -> None:
        global _WARM_REPLAY_RESULT, _WARMUP_ERROR
        try:
            if not _accelerator_available() or _WARMUP_ABORT.is_set():
                return
            import numpy as np

            from .ops.myers import myers_distance

            pattern = np.ones((1, 16), dtype=np.uint8)
            myers_distance(
                pattern,
                np.full(1, 16, dtype=np.int32),
                np.ones((1, 128), dtype=np.uint8),
                np.full(1, 128, dtype=np.int32),
            )
            from .ops.banded_cuda import ensure_registered

            ensure_registered()
            # replay previously-seen bucket shapes so chunk 1 skips the
            # per-program first-execution cost (see warm_shapes.py)
            from .warm_shapes import replay

            _WARM_REPLAY_RESULT = replay(should_abort=_WARMUP_ABORT.is_set)
            # prime the routing cost model's round-trip probe OFF the align
            # loop: a first execution measured while the chunk loop's
            # Python threads churn the GIL both stalls the wave and poisons
            # the overhead EWMA toward never using the device
            from .verify_batch import _device_call_overhead

            _device_call_overhead()
            logger.debug("device warmup complete")
        except Exception as error:  # noqa: BLE001 - reported to the align loop
            _WARMUP_ERROR = error
            logger.debug("device warmup failed: %s", error)

    import threading

    global _WARMUP_THREAD
    _WARMUP_THREAD = threading.Thread(
        target=warm, name="device-warmup", daemon=True
    )
    _WARMUP_THREAD.start()


def _accelerator_ready() -> bool:
    """Non-blocking accelerator availability for the align loop's routing:
    True only once the background warmup finished AND found a GPU. While
    the warmup is still in flight this returns False WITHOUT touching the
    backend — first-execution probes must never run on the GIL-busy align
    loop. Early chunks simply route to the host engines; later chunks pick
    up the device. A warmup that failed on a live GPU raises here, so a
    broken card never turns into a quiet host run. Falls back to the
    blocking check when no warmup was ever started (non-pipelined
    callers)."""
    if _WARMUP_THREAD is None:
        return _accelerator_available()
    if _WARMUP_THREAD.is_alive():
        return False
    if _WARMUP_ERROR is not None:
        raise RuntimeError(
            f"device warmup failed: {_WARMUP_ERROR}"
        ) from _WARMUP_ERROR
    return bool(_ACCELERATOR_AVAILABLE)


def _join_device_warmup(timeout: float | None = None) -> None:
    """Block until the warmup kernel has executed (no-op if never started).

    Called right before the align loop goes GIL-busy: if the warmup is
    still in flight there (e.g. a cached-index run skipped the long
    GIL-free build phase), waiting on an otherwise idle interpreter costs
    its true cost — proceeding would let the chunk loop's Python threads
    starve it instead."""
    if _WARMUP_THREAD is not None and _WARMUP_THREAD.is_alive():
        import time as _time

        t0 = _time.monotonic()
        _WARMUP_THREAD.join(timeout)
        logger.debug(
            "waited %.1fs for device warmup", _time.monotonic() - t0
        )


def _pretty_elapsed_suffix(seconds: float) -> str:
    """' (MM:SS minutes)' for long durations (output.cpp:153-172 format);
    the numeric seconds stay in the message for machine consumers."""
    if seconds <= 60:
        return ""
    from .output import format_elapsed_time

    return f" ({format_elapsed_time(seconds)})"


def initialize_logger(logfile_path, console_debug_logs: bool) -> None:
    """Parity: output::initialize_logger (output.cpp:110-151). All diagnostics
    go to stderr; stdout stays empty (asserted by the reference's e2e test)."""
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()
    console = logging.StreamHandler(sys.stderr)
    console.setLevel(logging.DEBUG if console_debug_logs else logging.INFO)
    console.setFormatter(
        logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s")
    )
    logger.addHandler(console)
    if logfile_path:
        from logging.handlers import RotatingFileHandler

        file_handler = RotatingFileHandler(
            logfile_path, maxBytes=1024 * 1024 * 20, backupCount=5
        )
        file_handler.setLevel(logging.DEBUG)
        file_handler.setFormatter(
            logging.Formatter(
                "[thread %(thread)d] [%(asctime)s] [%(levelname)s] %(message)s"
            )
        )
        logger.addHandler(file_handler)


# (path, mtime, size) -> FmIndex; lets a long-lived server process (see
# server.py) skip re-loading an index file across jobs. Bounded: big
# indexes are the dominant memory object, keep at most two
_INDEX_CACHE: dict = {}


def _cache_index(cache_key, index) -> None:
    while len(_INDEX_CACHE) >= 2:
        _INDEX_CACHE.pop(next(iter(_INDEX_CACHE)))
    _INDEX_CACHE[cache_key] = index


def build_or_load_index(cli: CommandLineInput, references: References) -> FmIndex:
    """floxer.cpp:62-107: load the index if the file exists, otherwise build
    (sampling rate 4) and save it when an index path was given."""
    import os

    if cli.index_path and os.path.exists(cli.index_path):
        stat = os.stat(cli.index_path)
        cache_key = (os.path.abspath(cli.index_path), stat.st_mtime, stat.st_size)
        cached = _INDEX_CACHE.get(cache_key)
        if cached is not None:
            logger.info("reusing cached index for %s", cli.index_path)
            return cached
        logger.info("loading index from %s", cli.index_path)
        index = FmIndex.load(cli.index_path)
        # force the v3 artifact's lazily-memmapped SA samples to
        # materialize NOW, inside the load phase — otherwise the first
        # chunk's locate pays it inside the align phase (measured ~5.5 s
        # at 500 Mb genome scale, ~20 s projected at hg38) and stalls the
        # pipeline's first search stage
        index.sampled_rows
        _cache_index(cache_key, index)
        return index

    logger.info("building index")
    started = time.monotonic()
    index = FmIndex(
        [record.rank_sequence for record in references.records],
        sampling_rate=DEFAULT_SAMPLING_RATE,
    )
    build_elapsed = time.monotonic() - started
    logger.info(
        "building index took %.2f seconds%s",
        build_elapsed,
        _pretty_elapsed_suffix(build_elapsed),
    )
    if cli.index_path:
        logger.info("saving index to %s", cli.index_path)
        try:
            index.save(cli.index_path)
            stat = os.stat(cli.index_path)
            _cache_index(
                (os.path.abspath(cli.index_path), stat.st_mtime, stat.st_size),
                index,
            )
        except Exception as error:  # noqa: BLE001 - parity: warn and continue
            logger.warning(
                "An error occured while trying to write the index to the "
                "file %s. Continuing without saving the index. %s",
                cli.index_path,
                error,
            )
    return index


def make_searcher(cli: CommandLineInput, index: FmIndex, num_references: int):
    searcher = Searcher(
        index=index,
        num_reference_sequences=num_references,
        config=SearchConfig(
            max_num_anchors_hard=cli.max_num_anchors_hard,
            max_num_anchors_soft=cli.max_num_anchors_soft,
            anchor_group_order=AnchorGroupOrder(cli.anchor_group_order),
            anchor_choice_strategy=AnchorChoiceStrategy(cli.anchor_choice_strategy),
            erase_useless_anchors=not cli.dont_erase_useless_anchors,
        ),
        num_threads=cli.num_threads,
    )
    if getattr(cli, "index_shards", 1) > 1:
        from .backend import ensure_backend
        from .search_device import make_sharded_searcher

        ensure_backend()
        return make_sharded_searcher(searcher, index, cli.index_shards)
    if getattr(cli, "device_search", False):
        from .index.device_index import DeviceIndex
        from .search_device import DeviceSearcher

        return DeviceSearcher(searcher, DeviceIndex.from_host(index))
    return searcher


def prepare_query_tree(query: QueryRecord, cli: CommandLineInput):
    """PEX tree + seeds for one query (pure function of length/config)."""
    query_num_errors = sequence_io.num_errors_from_config(
        len(query.rank_sequence),
        cli.query_num_errors,
        cli.query_error_probability,
    )
    strategy = (
        BuildStrategy.BOTTOM_UP
        if cli.bottom_up_pex_tree_building
        else BuildStrategy.RECURSIVE
    )
    pex_tree = cached_pex_tree(
        len(query.rank_sequence),
        query_num_errors,
        cli.pex_seed_num_errors,
        strategy,
    )
    seeds = pex_tree.generate_seeds(cli.seed_sampling_step_size)
    return pex_tree, seeds


def search_query_pure(
    query: QueryRecord, cli: CommandLineInput, searcher: Searcher
):
    """Search stage for one query without stats side effects: PEX tree,
    seeds, fwd+rc FM search (parallelization.cpp:91-101). Thread-safe — the
    native search releases the GIL, so chunks parallelize across
    --threads host workers."""
    search_started = time.monotonic()

    pex_tree, seeds = prepare_query_tree(query, cli)

    forward_result = searcher.search_seeds(seeds, query.rank_sequence)
    rc_result = searcher.search_seeds(
        seeds, query.reverse_complement_rank_sequence
    )
    elapsed_ms = int((time.monotonic() - search_started) * 1000)
    return pex_tree, seeds, forward_result, rc_result, elapsed_ms


def _apply_search_stats(
    query, seeds, forward_result, rc_result, elapsed_ms, stats
):
    stats.add_query_length(len(query.rank_sequence))
    stats.add_statistics_for_seeds(seeds, seeds)
    stats.add_statistics_for_search_result(forward_result, rc_result)
    stats.add_milliseconds_spent_in_search_per_query(elapsed_ms)


def search_query(
    query: QueryRecord,
    cli: CommandLineInput,
    searcher: Searcher,
    stats: SearchAndAlignmentStatistics,
):
    """Search stage for one query: PEX tree, seeds, fwd+rc FM search, stats
    (parallelization.cpp:91-116)."""
    pex_tree, seeds, forward_result, rc_result, elapsed_ms = search_query_pure(
        query, cli, searcher
    )
    _apply_search_stats(
        query, seeds, forward_result, rc_result, elapsed_ms, stats
    )
    return pex_tree, forward_result, rc_result


def process_query(
    query: QueryRecord,
    cli: CommandLineInput,
    references: References,
    searcher: Searcher,
    output: AlignmentOutput,
    stats: SearchAndAlignmentStatistics,
) -> None:
    """One query through search + verification + output; mirrors the combined
    search/verification task bodies (parallelization.cpp:56-161, 198-281)."""
    pex_tree, forward_result, rc_result = search_query(
        query, cli, searcher, stats
    )

    verification_started = time.monotonic()
    kind = (
        VerificationKind.DIRECT_FULL
        if cli.direct_full_verification
        else VerificationKind.HIERARCHICAL
    )
    alignments = QueryAlignments(len(references.records))

    for orientation, result in (
        (Orientation.FORWARD, forward_result),
        (Orientation.REVERSE_COMPLEMENT, rc_result),
    ):
        oriented_query = (
            query.rank_sequence
            if orientation == Orientation.FORWARD
            else query.reverse_complement_rank_sequence
        )
        verified_intervals = create_verified_intervals_per_reference(
            len(references.records), cli.use_interval_optimization
        )
        # anchors are grouped into packages of --num-anchors-per-task, the
        # reference's verification-task granularity (create_anchor_packages,
        # parallelization.cpp:14-43; search.cpp:111-141). Executed here in
        # package order on one thread, so the boundary is output-neutral —
        # exactly as it is in the reference, where it only sets how many
        # anchors one pool task carries.
        anchors = list(result.iter_anchors())
        package_size = max(1, cli.num_anchors_per_verification_task)
        packages = [
            anchors[base : base + package_size]
            for base in range(0, len(anchors), package_size)
        ]
        for package in packages:
            for anchor in package:
                verifier = QueryVerifier(
                    pex_tree=pex_tree,
                    anchor=anchor,
                    pex_leaf_node=pex_tree.leaves[anchor.pex_leaf_index],
                    query=oriented_query,
                    orientation=orientation,
                    reference=references.records[anchor.reference_id],
                    kind=kind,
                    already_verified_intervals=verified_intervals[
                        anchor.reference_id
                    ],
                    extra_verification_ratio=cli.extra_verification_ratio,
                    without_cigar=cli.without_cigar,
                    alignments=alignments,
                    stats=stats,
                )
                verifier.verify()

    stats.add_num_alignments(alignments.size())
    stats.add_milliseconds_spent_in_verification_per_query(
        int((time.monotonic() - verification_started) * 1000)
    )
    for per_reference in alignments.per_reference:
        for alignment in per_reference:
            stats.add_alignment_edit_distance(alignment.num_errors)

    write_alignments_for_query(output, query, alignments, references.records)


def verify_and_write_chunk(
    chunk,
    searched,
    cli: CommandLineInput,
    references: References,
    output: AlignmentOutput,
    stats: SearchAndAlignmentStatistics,
    resident_ref=None,
    defer_finalize: bool = False,
    deadline_check=None,
):
    """Verification + output for a chunk whose search results are ready.

    With defer_finalize=True the heavy synchronous part (wave loop, device
    kernels) runs here, but root CIGAR tracebacks stay in flight on the
    traceback pool and ALL stats/output writing is packaged into the
    returned zero-arg closure — the caller runs closures in chunk order on
    a single finalize thread, overlapping tracebacks + SAM writing of chunk
    N with the verification of chunk N+1. Stats and the output file are
    then touched only by that finalize thread."""
    from .verify_batch import BatchVerifier, _QueryItem

    items = []
    for query, (pex_tree, seeds, forward_result, rc_result, ms) in zip(
        chunk, searched
    ):
        items.append(_QueryItem(query, pex_tree, forward_result, rc_result))

    verification_started = time.monotonic()
    verifier = BatchVerifier(
        references.records,
        kind=(
            VerificationKind.DIRECT_FULL
            if cli.direct_full_verification
            else VerificationKind.HIERARCHICAL
        ),
        extra_verification_ratio=cli.extra_verification_ratio,
        without_cigar=cli.without_cigar,
        use_interval_optimization=cli.use_interval_optimization,
        # lazily resolved: the batched engine only initializes/queries the
        # accelerator backend when a bucket is big enough to benefit, so
        # tiny workloads never touch the device; readiness is gated on the
        # background warmup so the align loop never pays a first-execution
        # stall (see _accelerator_ready)
        use_device=(
            True if cli.engine == "device" else _accelerator_ready
        ),
        resident_ref=resident_ref,
        defer_finalize=defer_finalize,
        deadline_check=deadline_check,
    )
    all_alignments = verifier.process(items)
    verification_ms = int((time.monotonic() - verification_started) * 1000)

    def complete() -> None:
        verifier.resolve_deferred()
        soa = all(
            hasattr(entry[2], "kept_useful")
            and hasattr(entry[3], "kept_useful")
            for entry in searched
        )
        if soa and searched:
            stats.add_search_statistics_for_chunk(
                [
                    (len(query.rank_sequence), seeds, fwd, rc)
                    for query, (_, seeds, fwd, rc, _) in zip(chunk, searched)
                ],
                search_ms=searched[0][4],
            )
        else:
            for query, (pex_tree, seeds, forward_result, rc_result, ms) in zip(
                chunk, searched
            ):
                _apply_search_stats(
                    query, seeds, forward_result, rc_result, ms, stats
                )
        for kind, value in verifier.last_stats_events:
            if kind == "aligned_root":
                stats.add_reference_span_size_aligned_root(value)
            elif kind == "aligned_inner":
                stats.add_reference_span_size_aligned_inner_node(value)
            elif kind == "avoided_root":
                stats.add_reference_span_size_avoided_root(value)
        # the SoA verifier reports avoided-root span lengths as one array
        stats.add_reference_span_sizes_avoided_root_many(
            verifier.last_avoided_lengths
        )

        import numpy as np

        per_query_ms = verification_ms // max(len(chunk), 1)
        sizes = []
        edit_distances = []
        for query, alignments in zip(chunk, all_alignments):
            sizes.append(alignments.size())
            for per_reference in alignments.per_reference:
                for alignment in per_reference:
                    edit_distances.append(alignment.num_errors)
            write_alignments_for_query(
                output, query, alignments, references.records
            )
        stats.histograms["alignments per query"].add_values(
            np.asarray(sizes, dtype=np.int64)
        )
        stats.histograms[
            "milliseconds spent in verification per query"
        ].add_values(np.full(len(chunk), per_query_ms, dtype=np.int64))
        stats.histograms["alignments edit distance"].add_values(
            np.asarray(edit_distances, dtype=np.int64)
        )

    if defer_finalize:
        return complete
    complete()
    return None


def run(cli: CommandLineInput, extra_log_handler=None) -> int:
    """Main driver; mirrors src/main/floxer.cpp:35-195.

    extra_log_handler: an optional logging.Handler attached for this run —
    the server mode (server.py) uses it to mirror logs to the client."""
    if getattr(cli, "cprofile_path", None):
        # host-side cProfile of the whole run; usable through the warm
        # server so steady-state chunks are what gets profiled
        import cProfile

        path = cli.cprofile_path
        cli.cprofile_path = None
        profiler = cProfile.Profile()
        try:
            return profiler.runcall(run, cli, extra_log_handler)
        finally:
            cli.cprofile_path = path
            profiler.dump_stats(path)
            logger.info("cProfile written to %s", path)
    # multi-process execution: when a jax.distributed coordinator is
    # configured (JAX_COORDINATOR_ADDRESS), join the process set BEFORE any
    # backend initialization and derive the query shard from it; explicit
    # --num-hosts/--host-id still override (file-level sharded workflows)
    from .parallel.multihost import maybe_initialize_distributed

    process_index, process_count = maybe_initialize_distributed()
    distributed = process_count > 1
    if distributed:
        if cli.num_hosts == 1:
            cli.num_hosts = process_count
            cli.host_id = process_index
        # pin the platform and create the (multi-process) backend now,
        # while the distributed service is the only jax state
        from .backend import ensure_backend

        ensure_backend()

    if cli.engine in ("device", "batched"):
        # start the backend here, so a GPU that cannot start fails the run
        # before any work; then fire the one-time first-execution warmup
        # (and the CUDA kernel build) NOW, while the upcoming heavy host
        # phases (reference read / index build or load / first search) are
        # still native and GIL-free. For the default batched engine this
        # also decides device readiness (_accelerator_ready): the earlier
        # the warmup finishes, the earlier waves may route to the card. On
        # CPU-only hosts the thread exits at once (host engines).
        from .backend import ensure_backend

        ensure_backend()
        _start_device_warmup()
    initialize_logger(cli.logfile_path, cli.console_debug_logs)
    if extra_log_handler is not None:
        logger.addHandler(extra_log_handler)
    logger.info("successfully parsed CLI input ... starting")
    logger.debug("command line call: %s", cli.command_line_call())

    try:
        references = read_references(cli.reference_path)
    except Exception as error:  # noqa: BLE001
        logger.error(
            "An error occured while trying to read the reference from the "
            "file %s. %s",
            cli.reference_path,
            error,
        )
        return -1

    import itertools
    import os

    try:
        index = build_or_load_index(cli, references)
    except Exception as error:  # noqa: BLE001 - parity: floxer.cpp:70-80
        logger.error(
            "An error occured while trying to load or build the index. %s",
            error,
        )
        return -1
    searcher = make_searcher(cli, index, len(references.records))

    # distributed runs write per-process shard files (extension preserved
    # so the SAM/BAM writer selection is unchanged); process 0 merges the
    # canonical output after the post-align barrier below
    if distributed:
        from .parallel.multihost import shard_output_path

        effective_output_path = shard_output_path(
            cli.output_path, cli.host_id
        )
    else:
        effective_output_path = cli.output_path

    # checkpoint/resume: a progress cursor on the (sharded) query stream —
    # the reference has no mid-run resume (SURVEY.md aux subsystem 4)
    progress_path = f"{effective_output_path}.progress"
    skip = 0
    if cli.resume and os.path.exists(progress_path):
        try:
            skip = int(open(progress_path).read().strip() or 0)
        except ValueError:
            skip = 0
        if skip:
            logger.info("resuming: skipping %d already-processed queries", skip)

    output = AlignmentOutput(
        effective_output_path,
        references.records,
        append=cli.resume and skip > 0,
    )
    stats = SearchAndAlignmentStatistics(cli.stats_input_hint)

    queries_stream = Queries(
        cli.queries_path,
        cli.query_num_errors,
        cli.query_error_probability,
        cli.pex_seed_num_errors,
    )
    if cli.num_hosts > 1:
        from .parallel.multihost import shard_queries

        queries = shard_queries(queries_stream, cli.host_id, cli.num_hosts)
    else:
        queries = iter(queries_stream)
    num_processed = 0
    if skip:
        queries = itertools.islice(queries, skip, None)
        num_processed = skip

    def record_progress() -> None:
        with open(progress_path, "w") as handle:
            handle.write(f"{num_processed}\n")

    if cli.engine in ("device", "batched"):
        # backend init, not alignment: the warmup was started before the
        # index build; finish it on a GIL-quiet interpreter before the
        # align loop's Python threads can starve it (see _join_device_warmup).
        # The default engine waits too, so its first waves see the card
        # ready instead of racing the warmup (seconds on a GPU; at once on
        # a CPU host, where the warmup finds no accelerator)
        _join_device_warmup()

    logger.info(
        "aligning queries against %d references and writing output file to %s",
        len(references.records),
        cli.output_path,
    )
    aligning_started = time.monotonic()
    timed_out = False

    profiling = False
    if cli.profile_dir:
        # jax.profiler trace of the alignment phase (SURVEY.md aux 1: the
        # reference only has wall-clock stopwatches)
        try:
            import jax

            from .backend import ensure_backend

            ensure_backend()
            jax.profiler.start_trace(cli.profile_dir)
            profiling = True
        except Exception as error:  # noqa: BLE001
            logger.warning("profiler unavailable: %s", error)

    def hit_timeout() -> bool:
        return (
            cli.timeout_seconds is not None
            and time.monotonic() - aligning_started > cli.timeout_seconds
        )

    failed = False
    stage_wall = None  # set by the batched engine; None => no stage split
    vb_timers_start = None
    if cli.engine == "reference":
        try:
            for query in queries:
                if hit_timeout():
                    timed_out = True
                    break
                process_query(query, cli, references, searcher, output, stats)
                num_processed += 1
                record_progress()
        except Exception as error:  # noqa: BLE001 - parity with the
            # reference's task-level abort (parallelization.cpp:149-157)
            logger.error(
                "An error occurred while reading/searching/verifying a "
                "query. Shutting down. The output file is likely "
                "incomplete. Error message: %s",
                error,
            )
            failed = True
    else:
        # double-buffered pipeline: the host searches chunk N+1 on a worker
        # thread (the native search releases the GIL) while the device
        # verifies chunk N — the reference's self-respawning streaming
        # property (parallelization.cpp:139-148), shaped for a device
        from concurrent.futures import ThreadPoolExecutor

        # device-resident reference bank: the packed upload happens
        # lazily on the first resident bucket dispatch (ops/resident.py),
        # so CPU-only or tiny runs never touch an accelerator here. In a
        # server process the bank is CACHED across jobs keyed by the
        # reference file identity, so a job does not re-upload it
        resident_ref = _get_resident_bank(cli, references)

        # per-stage wall attribution for the end-of-run "stage split" line
        # (VERDICT r4 item 6): stages OVERLAP (search of chunk N+1 runs
        # while chunk N verifies), so the sums can exceed the align wall —
        # they attribute where the time went, not how long the run took
        stage_wall = {"search": 0.0, "verify": 0.0, "finalize": 0.0}
        from .verify_batch import _BATCH_TIMERS as _vb_timers

        vb_timers_start = dict(_vb_timers)

        def next_chunk():
            chunk = []
            for query in queries:
                chunk.append(query)
                if len(chunk) >= cli.batch_size:
                    break
            return chunk

        def search_chunk(chunk):
            started = time.monotonic()
            many = getattr(searcher, "search_seeds_many", None)
            if many is None:
                result = [
                    search_query_pure(query, cli, searcher) for query in chunk
                ]
            else:
                # chunk-level batched search: every query's fwd+rc seeds in
                # one native call per seed class; per-query search ms is
                # chunk-averaged (a per-query timing does not exist in a
                # batched search, see docs/ARCHITECTURE.md deviations)
                prepared = []
                jobs = []
                for query in chunk:
                    pex_tree, seeds = prepare_query_tree(query, cli)
                    prepared.append((pex_tree, seeds))
                    jobs.append((seeds, query.rank_sequence))
                    jobs.append(
                        (seeds, query.reverse_complement_rank_sequence)
                    )
                searched = many(jobs)
                elapsed_ms = int((time.monotonic() - started) * 1000) // max(
                    len(chunk), 1
                )
                result = [
                    (
                        pex_tree,
                        seeds,
                        searched[2 * i],
                        searched[2 * i + 1],
                        elapsed_ms,
                    )
                    for i, (pex_tree, seeds) in enumerate(prepared)
                ]
            stage_wall["search"] += time.monotonic() - started
            logger.debug(
                "search chunk: %d queries in %.2fs",
                len(chunk),
                time.monotonic() - started,
            )
            return result

        # three overlapped stages per chunk, mirroring the reference's
        # streaming task runtime (parallelization.cpp:139-148):
        #   search pool:    host FM search of chunk N+1
        #   main thread:    wave loop + device kernels of chunk N
        #   finalize pool:  root tracebacks + stats + SAM writing of chunk
        #                   N-1 (single worker => output stays in order)
        with ThreadPoolExecutor(max_workers=1) as pool, ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="finalize"
        ) as finalize_pool:
            pending = None
            finalizing = None  # (chunk_len, future)
            try:
                while not timed_out:
                    chunk = next_chunk()
                    if len(chunk) >= 32:
                        # big enough that device verification will engage:
                        # overlap the backend's first-execution warmup with
                        # this chunk's host search
                        _start_device_warmup()
                    future = (
                        pool.submit(search_chunk, chunk) if chunk else None
                    )
                    if pending is not None:
                        from .verify_batch import VerificationTimeout

                        prev_chunk, prev_future = pending
                        t0_verify = time.monotonic()
                        try:
                            complete = verify_and_write_chunk(
                                prev_chunk,
                                prev_future.result(),
                                cli,
                                references,
                                output,
                                stats,
                                resident_ref=resident_ref,
                                defer_finalize=True,
                                deadline_check=hit_timeout,
                            )
                            stage_wall["verify"] += (
                                time.monotonic() - t0_verify
                            )
                        except VerificationTimeout:
                            # per-wave timeout check (parallelization.cpp:66,
                            # 203 parity): drop the in-flight chunk, output
                            # stays truncated like the reference's
                            timed_out = True
                            if future is not None:
                                future.cancel()
                            break
                        if finalizing is not None:
                            done_len, done_future = finalizing
                            done_future.result()
                            num_processed += done_len
                            record_progress()
                        def timed_complete(fn=complete):
                            t0 = time.monotonic()
                            try:
                                return fn()
                            finally:
                                stage_wall["finalize"] += (
                                    time.monotonic() - t0
                                )

                        finalizing = (
                            len(prev_chunk),
                            finalize_pool.submit(timed_complete),
                        )
                    if not chunk:
                        break
                    if hit_timeout():
                        timed_out = True
                        future.cancel()
                        break
                    pending = (chunk, future)
                if finalizing is not None:
                    done_len, done_future = finalizing
                    done_future.result()
                    num_processed += done_len
                    record_progress()
                    finalizing = None
            except Exception as error:  # noqa: BLE001 - see reference-engine
                # branch above
                logger.error(
                    "An error occurred during batched alignment. Shutting "
                    "down. The output file is likely incomplete. Error "
                    "message: %s",
                    error,
                )
                logger.debug(
                    "batched alignment failure traceback:", exc_info=True
                )
                failed = True

    if timed_out:
        logger.warning(
            "Timeout happened. Shutting down now. The output file might "
            "be incomplete."
        )

    output.close()

    if profiling:
        import jax

        jax.profiler.stop_trace()

    if timed_out or failed:
        return -1

    # a completed run needs no resume cursor
    if os.path.exists(progress_path):
        os.remove(progress_path)

    align_elapsed = time.monotonic() - aligning_started
    logger.info(
        "finished aligning successfully in %.2f seconds%s",
        align_elapsed,
        _pretty_elapsed_suffix(align_elapsed),
    )
    if stage_wall is not None:
        # machine-parsable per-stage attribution (VERDICT r4 item 6;
        # bench.py forwards these into its JSON line). Stages overlap, so
        # the sums can exceed the align wall; device_kernel_s is the
        # unhidden device time observed by the wave batcher this run.
        from .verify_batch import _BATCH_TIMERS as _vb_now

        device_kernel_s = _vb_now["kernel"] - (
            vb_timers_start.get("kernel", 0.0) if vb_timers_start else 0.0
        )
        fused = _vb_now.get("fused", 0) - (
            vb_timers_start.get("fused", 0) if vb_timers_start else 0
        )
        logger.info(
            "stage split: search=%.2fs verify=%.2fs finalize=%.2fs "
            "device_kernel=%.3fs fused_dispatches=%d",
            stage_wall["search"],
            stage_wall["verify"],
            stage_wall["finalize"],
            device_kernel_s,
            fused,
        )
        from .backend import accelerator

        if accelerator():
            import jax

            logger.debug(
                "device peak bytes in use: %s",
                [
                    (device.memory_stats() or {}).get("peak_bytes_in_use", 0)
                    for device in jax.local_devices()
                ],
            )

    # stop the device warmup OUTSIDE the align timer, so the process does
    # not exit with device work in flight on a daemon thread. A server
    # process skips this: the warmup persists across jobs (server.py sets
    # _PERSISTENT_PROCESS).
    if not _PERSISTENT_PROCESS:
        _WARMUP_ABORT.set()
        _join_device_warmup(timeout=10)

    if distributed:
        # cross-process stats merge as collectives (psum/pmin/pmax over a
        # one-device-per-process mesh), then a barrier so every shard file
        # is closed before process 0 interleaves the canonical output
        from jax.experimental import multihost_utils

        from .parallel.mesh import allreduce_stats
        from .parallel.multihost import merge_sam_shards, shard_output_path

        # the gloo CPU-collectives backend prints a connection banner to
        # raw stdout when its context forms; stdout must stay empty (the
        # reference's e2e contract), so route fd 1 to stderr around the
        # first collective
        saved_stdout = os.dup(1)
        os.dup2(2, 1)
        try:
            stats.apply_merged_arrays(
                *allreduce_stats(*stats.to_merge_arrays())
            )
            multihost_utils.sync_global_devices("floxer-shards-closed")
        finally:
            os.dup2(saved_stdout, 1)
            os.close(saved_stdout)
        if process_index == 0:
            from .parallel.multihost import merge_bam_shards

            shard_paths = [
                shard_output_path(cli.output_path, h)
                for h in range(process_count)
            ]
            merge = (
                merge_sam_shards
                if cli.output_path.endswith(".sam")
                else merge_bam_shards
            )
            merged = merge(shard_paths, cli.output_path)
            logger.info(
                "merged %d queries from %d shards into %s",
                merged, process_count, cli.output_path,
            )
        else:
            # one canonical stats report: only process 0 emits
            return 0

    if cli.stats_target is not None:
        if cli.stats_target == "terminal":
            for line in stats.format_for_terminal():
                logger.info("%s", line)
        else:
            with open(cli.stats_target, "w") as handle:
                handle.write(stats.format_as_toml())

    return 0
