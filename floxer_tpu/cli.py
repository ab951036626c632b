"""Command line interface.

Parity target: include/floxer_cli.hpp + src/lib/floxer_cli.cpp — same option
names (long and short), defaults, validators, the basic/advanced help tiers
(--advanced-help), cross-option validation (floxer_cli.cpp:173-204) and the
sanitized canonical command-line echo (floxer_cli.cpp:134-171).
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from typing import Optional

from . import __version__

REFERENCE_EXTENSIONS = (
    "fa", "fasta", "fna", "ffn", "fas", "faa", "mpfa", "frn",
    "fa.gz", "fasta.gz", "fna.gz", "ffn.gz", "fas.gz", "faa.gz",
    "mpfa.gz", "frn.gz",
)
QUERY_EXTENSIONS = ("fq", "fastq", "fq.gz", "fastq.gz")
OUTPUT_EXTENSIONS = ("bam", "sam")

ANCHOR_GROUP_ORDERS = ("count_first", "errors_first", "none")
ANCHOR_CHOICE_STRATEGIES = ("round_robin", "full_groups", "first_reported")
STATS_INPUT_HINTS = ("real_nanopore", "simulated")


@dataclass
class CommandLineInput:
    """Defaults mirror floxer_cli.hpp:41-70."""

    reference_path: str = ""
    queries_path: str = ""
    output_path: str = ""
    index_path: Optional[str] = None
    logfile_path: Optional[str] = None
    console_debug_logs: bool = False

    query_num_errors: Optional[int] = None
    query_error_probability: Optional[float] = None
    pex_seed_num_errors: int = 2

    max_num_anchors_hard: int = 500
    max_num_anchors_soft: int = 50
    anchor_group_order: str = "count_first"
    anchor_choice_strategy: str = "round_robin"
    seed_sampling_step_size: int = 1
    dont_erase_useless_anchors: bool = False

    bottom_up_pex_tree_building: bool = False
    use_interval_optimization: bool = False
    extra_verification_ratio: float = 0.05
    direct_full_verification: bool = False

    num_anchors_per_verification_task: int = 3000
    without_cigar: bool = False

    num_threads: int = 1
    timeout_seconds: Optional[int] = None
    stats_target: Optional[str] = None
    stats_input_hint: str = ""

    # extensions of this implementation (no reference counterpart)
    engine: str = "batched"  # reference | batched | device
    batch_size: int = 128
    num_hosts: int = 1
    host_id: int = 0
    resume: bool = False
    device_search: bool = False
    index_shards: int = 1
    profile_dir: Optional[str] = None
    cprofile_path: Optional[str] = None

    def command_line_call(self) -> str:
        """Sanitized canonical echo for logs (floxer_cli.cpp:134-171)."""

        def path_part(long_id: str, value: Optional[str]) -> str:
            if not value:
                return ""
            name = value.rsplit("/", 1)[-1]
            prefix = ".../" if "/" in value else ""
            return f" --{long_id} {prefix}{name}"

        parts = [
            "floxer",
            path_part("reference", self.reference_path),
            path_part("queries", self.queries_path),
            path_part("index", self.index_path),
            path_part("output", self.output_path),
            path_part("logfile", self.logfile_path),
            " --console-debug-logs" if self.console_debug_logs else "",
            (
                f" --query-errors {self.query_num_errors}"
                if self.query_num_errors is not None
                else ""
            ),
            (
                f" --error-probability {self.query_error_probability}"
                if self.query_error_probability is not None
                else ""
            ),
            f" --seed-errors {self.pex_seed_num_errors}",
            f" --max-anchors-hard {self.max_num_anchors_hard}",
            f" --max-anchors-soft {self.max_num_anchors_soft}",
            f" --anchor-group-order {self.anchor_group_order}",
            f" --anchor-choice-strategy {self.anchor_choice_strategy}",
            f" --seed-sampling-step-size {self.seed_sampling_step_size}",
            (
                " --dont-erase-useless-anchors"
                if self.dont_erase_useless_anchors
                else ""
            ),
            " --bottom-up-pex-tree" if self.bottom_up_pex_tree_building else "",
            " --interval-optimization" if self.use_interval_optimization else "",
            f" --extra-verification-ratio {self.extra_verification_ratio}",
            " --direct-full-verification" if self.direct_full_verification else "",
            f" --num-anchors-per-task {self.num_anchors_per_verification_task}",
            " --without-cigar" if self.without_cigar else "",
            f" --threads {self.num_threads}",
            (
                f" --timeout {self.timeout_seconds}"
                if self.timeout_seconds is not None
                else ""
            ),
            f" --stats {self.stats_target}" if self.stats_target else "",
            (
                f" --stats-input-hint {self.stats_input_hint}"
                if self.stats_input_hint
                else ""
            ),
        ]
        return "".join(parts)

    def validate(self) -> None:
        """Cross-option validation (floxer_cli.cpp:173-204)."""
        if self.query_num_errors is None and self.query_error_probability is None:
            raise ValueError(
                "Either a fixed number of errors in the query or an error "
                "probability must be given."
            )
        if (
            self.query_num_errors is not None
            and self.query_num_errors < self.pex_seed_num_errors
        ):
            raise ValueError(
                f"The number of errors per query ({self.query_num_errors}) must "
                "be greater or equal than the number of errors in the PEX tree "
                f"leaves ({self.pex_seed_num_errors})."
            )
        if self.max_num_anchors_hard < self.max_num_anchors_soft:
            raise ValueError(
                f"The hard maximum number of anchors ({self.max_num_anchors_hard}) "
                "should not be smaller than the soft maximum number of anchors "
                f"({self.max_num_anchors_soft})."
            )


def _check_extension(path: str, extensions, what: str) -> str:
    if not any(path.endswith("." + ext) for ext in extensions):
        raise argparse.ArgumentTypeError(
            f"{what} file {path} must have one of the extensions: "
            + ", ".join(extensions)
        )
    return path


def _ranged_int(lo: int, hi: int):
    def parse(value: str) -> int:
        number = int(value)
        if not lo <= number <= hi:
            raise argparse.ArgumentTypeError(
                f"value {number} not in range [{lo}, {hi}]"
            )
        return number

    return parse


def _probability(value: str) -> float:
    number = float(value)
    if not 0.00001 <= number <= 0.99999:
        raise argparse.ArgumentTypeError(
            f"error probability {number} not in range [0.00001, 0.99999]"
        )
    return number


def build_parser(advanced: bool = False) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="floxer-tpu",
        description=(
            "floxer-tpu: an exact longread aligner for GPUs using "
            "FM-index search with optimal search schemes, PEX hierarchical "
            "verification and CUDA banded edit-distance kernels"
        ),
        epilog=(
            None
            if advanced
            else "Run with --advanced-help to see research/tuning options."
        ),
        add_help=True,
    )

    def adv(**kwargs):
        """advanced options are hidden from the basic --help tier"""
        if not advanced:
            kwargs["help"] = argparse.SUPPRESS
        return kwargs

    parser.add_argument("--advanced-help", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--version", action="version", version=__version__)

    parser.add_argument(
        "-r", "--reference", dest="reference_path", required=True,
        type=lambda p: _check_extension(p, REFERENCE_EXTENSIONS, "reference"),
        help="The reference sequences in which floxer will search the queries, "
        "i.e. the haystack. Only valid DNA sequences using [AaCcGgTt] "
        "characters are allowed.",
    )
    parser.add_argument(
        "-q", "--queries", dest="queries_path", required=True,
        type=lambda p: _check_extension(p, QUERY_EXTENSIONS, "queries"),
        help="The queries which floxer will search in the reference, i.e. the "
        "needles. Queries that contain characters other than [AaCcGgTt] are "
        "skipped.",
    )
    parser.add_argument(
        "-o", "--output", dest="output_path", required=True,
        type=lambda p: _check_extension(p, OUTPUT_EXTENSIONS, "output"),
        help="The file where the alignment results will be stored.",
    )
    parser.add_argument(
        "-i", "--index", dest="index_path", default=None,
        help="The file where the constructed FM-index will be stored for later "
        "use. If the file already exists, the index will be read from it "
        "instead of newly constructed.",
    )
    parser.add_argument(
        "-l", "--logfile", dest="logfile_path", default=None,
        help="If a logfile path is given, debug information will be written "
        "to it.",
    )
    parser.add_argument(
        "-c", "--console-debug-logs", dest="console_debug_logs",
        action="store_true",
        help="Print debug and trace logs into stderr.",
    )
    parser.add_argument(
        "-e", "--query-errors", dest="query_num_errors", default=None,
        type=_ranged_int(0, 4096),
        help="The number of errors allowed in each query. This is only used if "
        "no error probability is given. Either this or an error probability "
        "must be given.",
    )
    parser.add_argument(
        "-p", "--error-probability", dest="query_error_probability",
        default=None, type=_probability,
        help="The error probability in the queries, per base. If this is "
        "given, it is used rather than the fixed number of errors.",
    )
    parser.add_argument(
        "-s", "--seed-errors", dest="pex_seed_num_errors", default=2,
        type=_ranged_int(0, 3),
        **adv(help="The number of errors in the leaves of the PEX tree that "
              "are used as seeds."),
    )
    parser.add_argument(
        "-M", "--max-anchors-hard", dest="max_num_anchors_hard", default=500,
        type=int,
        **adv(help="Seeds with at least this number of (raw) anchors are "
              "completely excluded from further steps of the algorithm."),
    )
    parser.add_argument(
        "-m", "--max-anchors-soft", dest="max_num_anchors_soft", default=50,
        type=int,
        **adv(help="At most this number of anchors per seed will be included "
              "into further steps of the algorithm."),
    )
    parser.add_argument(
        "-g", "--anchor-group-order", dest="anchor_group_order",
        default="count_first", choices=ANCHOR_GROUP_ORDERS,
        **adv(help="The way in which anchor groups returned from the FM Index "
              "search are ordered."),
    )
    parser.add_argument(
        "-y", "--anchor-choice-strategy", dest="anchor_choice_strategy",
        default="round_robin", choices=ANCHOR_CHOICE_STRATEGIES,
        **adv(help="The way in which anchors are chosen from anchor groups."),
    )
    parser.add_argument(
        "-C", "--seed-sampling-step-size", dest="seed_sampling_step_size",
        default=1, type=int,
        **adv(help="How many seeds from the PEX tree leaves are chosen. 1 "
              "means all of them, 2 means every second, and so on."),
    )
    parser.add_argument(
        "-E", "--dont-erase-useless-anchors", dest="dont_erase_useless_anchors",
        action="store_true",
        **adv(help="If given, useless (locally suboptimal) anchors are not "
              "erased before the verification."),
    )
    parser.add_argument(
        "-b", "--bottom-up-pex-tree", dest="bottom_up_pex_tree_building",
        action="store_true",
        **adv(help="Build PEX trees using the bottom up strategy."),
    )
    parser.add_argument(
        "-I", "--interval-optimization", dest="use_interval_optimization",
        action="store_true",
        **adv(help="Keep track of already verified intervals to avoid "
              "repeating alignment."),
    )
    parser.add_argument(
        "-v", "--extra-verification-ratio", dest="extra_verification_ratio",
        default=0.05, type=float,
        **adv(help="How much additional sequence should be verified around "
              "the verification intervals."),
    )
    parser.add_argument(
        "-d", "--direct-full-verification", dest="direct_full_verification",
        action="store_true",
        **adv(help="Instead of PEX hierarchical verification, directly verify "
              "the whole query for every anchor."),
    )
    parser.add_argument(
        "-u", "--num-anchors-per-task",
        dest="num_anchors_per_verification_task", default=3000,
        type=_ranged_int(1, 2**62),
        **adv(help="The number of anchors per verification batch. Accepted "
              "for reference CLI parity; the batched engines replace anchor "
              "packaging with shape-bucketed device batches (the reference's "
              "task granularity knob has no output effect there either), so "
              "this value is not consumed."),
    )
    parser.add_argument(
        "-w", "--without-cigar", dest="without_cigar", action="store_true",
        **adv(help="Do not include CIGAR strings in the output file."),
    )
    parser.add_argument(
        "-t", "--threads", dest="num_threads", default=1,
        type=_ranged_int(1, 4096),
        help="The number of threads/host workers to use.",
    )
    parser.add_argument(
        "-x", "--timeout", dest="timeout_seconds", default=None, type=int,
        **adv(help="If given, no new alignments will be started after this "
              "amount of seconds."),
    )
    parser.add_argument(
        "-S", "--stats", dest="stats_target", default=None,
        **adv(help="'terminal' to print stats to stderr, or a file path for "
              "TOML output."),
    )
    parser.add_argument(
        "-H", "--stats-input-hint", dest="stats_input_hint", default="",
        choices=("",) + STATS_INPUT_HINTS,
        **adv(help="Hint for the stats histogram binning."),
    )
    parser.add_argument(
        "--engine", dest="engine", default="batched",
        choices=("reference", "batched", "device"),
        **adv(help="Verification execution engine: 'reference' runs the "
              "sequential host path, 'batched' the level-synchronous batch "
              "engine on host, 'device' the batch engine with the Myers "
              "kernels on the JAX backend (GPU). All three produce "
              "identical output."),
    )
    parser.add_argument(
        "--batch-size", dest="batch_size", default=128,
        type=_ranged_int(1, 1 << 20),
        **adv(help="Queries per verification batch for the batched/device "
              "engines."),
    )
    parser.add_argument(
        "--num-hosts", dest="num_hosts", default=1, type=_ranged_int(1, 4096),
        **adv(help="Total number of hosts sharding the query stream "
              "(strided by query internal id)."),
    )
    parser.add_argument(
        "--host-id", dest="host_id", default=0, type=_ranged_int(0, 4095),
        **adv(help="This host's shard id in [0, num-hosts)."),
    )
    parser.add_argument(
        "--resume", dest="resume", action="store_true",
        **adv(help="Resume an interrupted run: skip queries recorded in the "
              "output's progress file and append to the output."),
    )
    parser.add_argument(
        "--profile", dest="profile_dir", default=None,
        **adv(help="Write a jax.profiler trace of the alignment phase to "
              "this directory (view with TensorBoard/Perfetto)."),
    )
    parser.add_argument(
        "--cprofile", dest="cprofile_path", default=None,
        **adv(help="Write a host-side cProfile of the whole run to this "
              ".pstats file (works inside the persistent server, so warm "
              "steady-state chunks can be profiled)."),
    )
    parser.add_argument(
        "--device-search", dest="device_search", action="store_true",
        **adv(help="Run the FM-index seed search as a masked-frontier "
              "traversal on the JAX backend instead of the native host DFS. "
              "Reports are produced in exact host-DFS order with the same "
              "dedup and cap-abort replay, so results are bit-identical to "
              "the host engines even when the anchor caps bind."),
    )
    parser.add_argument(
        "--index-shards", dest="index_shards", default=1,
        type=_ranged_int(1, 4096),
        **adv(help="Row-shard the FM-index (BWT, occ checkpoints, SA "
              "samples) across this many devices of an 'index' mesh axis "
              "and run the device seed search with collective rank "
              "queries — the configuration for references too large for "
              "one chip's HBM (hg38 scale). Implies --device-search."),
    )
    return parser


def parse_and_validate(argv=None) -> CommandLineInput:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--advanced-help" in argv:
        build_parser(advanced=True).parse_args(["--help"])
    args = build_parser().parse_args(argv)
    cli = CommandLineInput(
        **{
            key: value
            for key, value in vars(args).items()
            if key not in ("advanced_help",)
        }
    )
    cli.validate()
    return cli
