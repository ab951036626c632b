"""Benchmark: end-to-end align-phase reads/s/chip on a chr21-scale workload.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

The metric is the BASELINE.json headline — whole-pipeline reads per second
(the timed unit is everything the reference's `main` does after the index
is ready: streaming queries, PEX trees, FM search, hierarchical
verification, CIGARs, SAM output; the reference's src/main/floxer.cpp:35-195)
— on a deterministic chr21-scale workload: a seeded 46 Mb uniform-random
chromosome with 2000 x 20 kb reads at 8% exact edit-distance mutations
(simulated_dataset tool, reference shape simulated_dataset.cpp:234-239;
error probability 0.08 per BASELINE.json config 3).

The run is a REAL CLI invocation (fresh process, like a user would run it),
with the FM-index prebuilt and cached in the checkout's .data/bench/ so the
align phase is what gets timed. Passes, one process on the card at a time:

  - CPU pass: JAX_PLATFORMS=cpu — the 4-core native host engine
    (lane-parallel banded Myers, myers_host.cpp).
  - device passes: the PRODUCTION DEFAULT engine on the GPU, as fresh CLI
    processes and then as jobs of the warm service (--serve/--server),
    which starts only after the CLI passes — cost-model routing
    dispatches big verification waves to the card as single fused
    programs (ops/fused_verify.py); the JSON line reports how many fused
    device dispatches the best pass made.

`value` is the best device pass; with no GPU, or no device pass that
finished, the script prints `value: null` and exits non-zero — a CPU
figure is never reported under the device's name. `vs_baseline` is
device / CPU: the reference publishes no numbers (BASELINE.md), so the
baseline is the CPU engine of the same pipeline on the same machine. The
SAM outputs of all passes are compared.

`kernel_gcups` (secondary field): full-DP-equivalent GCUPS of the banded
verification kernel on the GPU at the PEX-root shape (the reference names
its DP engine as the bottleneck, CONTRIBUTING.md:3-4). Full-DP-equivalent
= T*M*N cells a full-matrix engine would compute for the same answers; the
banded kernel computes the provably sufficient band (ops/myers_banded.py).
`kernel_band_gcups` scores only the band cells actually computed.

Env knobs: FLOXER_BENCH_READS (default 2000), FLOXER_BENCH_SKIP_KERNEL,
FLOXER_BENCH_SKIP_CPU, FLOXER_BENCH_SKIP_SERVER, FLOXER_BENCH_PASSES,
FLOXER_BENCH_DATA_DIR (default <checkout>/.data/bench).
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CHROMOSOME_LENGTH = 46_000_000
READ_LENGTH = 20_000
ERROR_RATE = 0.07  # simulated mutation rate; aligned at -p 0.08 (BASELINE)
SEED = 20260819
ALIGN_SECONDS_RE = re.compile(
    r"finished aligning successfully in ([0-9.]+) seconds"
)
STAGE_SPLIT_RE = re.compile(
    r"stage split: search=([0-9.]+)s verify=([0-9.]+)s "
    r"finalize=([0-9.]+)s device_kernel=([0-9.]+)s fused_dispatches=(\d+)"
)


def _data_dir() -> Path:
    base = os.environ.get("FLOXER_BENCH_DATA_DIR")
    if base:
        return Path(base)
    return REPO / ".data" / "bench"


def _ensure_workload(num_reads: int) -> tuple[Path, Path, Path]:
    """Deterministic genome+reads+index, cached across runs."""
    data = _data_dir()
    data.mkdir(parents=True, exist_ok=True)
    tag = f"chr21s_{CHROMOSOME_LENGTH}_{num_reads}x{READ_LENGTH}_s{SEED}"
    genome = data / f"{tag}.fasta"
    reads = data / f"{tag}.fastq"
    index = data / f"{tag}.index.npz"
    if not (genome.exists() and reads.exists()):
        subprocess.run(
            [
                sys.executable, "-m", "floxer_tpu.tools.simulated_dataset",
                "create",
                "-g", str(genome), "-r", str(reads),
                "-c", str(CHROMOSOME_LENGTH), "-n", "1",
                "-l", str(READ_LENGTH), "-m", str(num_reads),
                "-e", str(ERROR_RATE), "-s", str(SEED),
            ],
            check=True,
            cwd=REPO,
        )
    return genome, reads, index


def _run_aligner(
    genome: Path,
    reads: Path,
    index: Path,
    out: Path,
    engine_args: list[str],
    env_extra: dict,
    timeout_s: int,
) -> tuple[float, int, dict] | None:
    """One CLI run; returns (align-phase seconds, fused device dispatches,
    per-stage seconds dict) or None on failure."""
    env = dict(os.environ)
    env.update(env_extra)
    command = [
        sys.executable, "-m", "floxer_tpu",
        "--reference", str(genome),
        "--queries", str(reads),
        "--output", str(out),
        "--index", str(index),
        "--error-probability", "0.08",
        "--interval-optimization",
        "--threads", "4",
        "--batch-size", "250",
        "--console-debug-logs",
        *engine_args,
    ]
    try:
        proc = subprocess.run(
            command,
            capture_output=True,
            text=True,
            env=env,
            cwd=REPO,
            timeout=timeout_s,
        )
    except subprocess.TimeoutExpired:
        return None
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-2000:] + "\n")
        return None
    match = ALIGN_SECONDS_RE.search(proc.stderr)
    if match is None:
        return None
    fused = proc.stderr.count("fused wave:")
    stages: dict = {}
    stage_match = STAGE_SPLIT_RE.search(proc.stderr)
    if stage_match is not None:
        stages = {
            "search_s": float(stage_match.group(1)),
            "verify_s": float(stage_match.group(2)),
            "io_s": float(stage_match.group(3)),
            "device_kernel_s": float(stage_match.group(4)),
        }
        # the pipeline's own fused counter is authoritative when present
        # (a server job's stderr is pumped by the service, not the client)
        fused = max(fused, int(stage_match.group(5)))
    return float(match.group(1)), fused, stages


def _start_bench_server(data: Path) -> dict:
    """Launch the warm alignment service (--serve) in the background.

    Production deployments run the aligner as a long-lived service
    (server.py): the backend's one-time per-process costs — first
    execution, fused-plan program loads — are paid once at service
    start, not per job. Started only after the CLI passes, so it is the
    one process on the card. Returns a handle for _server_device_passes
    / _stop_bench_server."""
    import threading

    sock = data / "bench_server.sock"
    try:
        sock.unlink()
    except OSError:
        pass
    server = subprocess.Popen(
        [sys.executable, "-m", "floxer_tpu", "--serve", str(sock)],
        stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
        text=True, cwd=REPO,
    )
    lines: list[str] = []

    def pump():
        for line in server.stderr:
            lines.append(line)

    threading.Thread(target=pump, daemon=True).start()
    return {"proc": server, "sock": sock, "lines": lines}


def _server_device_passes(
    handle: dict,
    genome: Path, reads: Path, index: Path, data: Path,
    deadline: float, passes: int,
) -> tuple[float, int] | None:
    """Run device passes through the warm service; returns the best
    (align seconds, fused dispatches) or None."""
    server, sock, lines = handle["proc"], handle["sock"], handle["lines"]
    ready = False
    ready_deadline = min(deadline, time.monotonic() + 600)
    while time.monotonic() < ready_deadline:
        if any("listening on" in line for line in lines) and any(
            "backend probe ok" in line for line in lines
        ):
            ready = True
            break
        if server.poll() is not None:
            break
        time.sleep(2)
    if not ready:
        sys.stderr.write("bench server never became ready\n")
        return None
    # block until the warm-shape replay reports its fused-plan count: a
    # job launched while the replay is still in flight routes every wave
    # to the host and burns a pass for nothing. Bounded, so a replay that
    # wedges cannot eat the whole device budget.
    warm_fused = None
    warm_deadline = min(deadline, time.monotonic() + 420)
    while time.monotonic() < warm_deadline:
        for line in lines:
            if "warm replay done fused=" in line:
                warm_fused = int(line.rsplit("=", 1)[1])
                break
        if warm_fused is not None or server.poll() is not None:
            break
        time.sleep(2)
    if warm_fused is not None:
        sys.stderr.write(f"bench server warm replay: {warm_fused} plans\n")
    else:
        sys.stderr.write("bench server warm replay never finished\n")
    best = None
    # at least 3 jobs: the first may run while the service warmup is
    # still in flight (all-host), the first CHIP-ENGAGED job pays any
    # fused-plan compiles not covered by the warm replay, and only the
    # one after that shows the steady service state
    for _ in range(max(passes, 3)):
        remaining = deadline - time.monotonic()
        if remaining < 120:
            break
        got = _run_aligner(
            genome, reads, index, data / "bench_dev.sam",
            ["--server", str(sock)], {},
            timeout_s=min(1200, int(remaining)),
        )
        if got is not None and (best is None or got[0] < best[0]):
            best = got
    return best


def _stop_bench_server(handle: dict) -> None:
    server, sock = handle["proc"], handle["sock"]
    try:
        subprocess.run(
            [sys.executable, "-m", "floxer_tpu",
             "--shutdown-server", str(sock)],
            timeout=30, cwd=REPO, capture_output=True,
        )
    except Exception:  # noqa: BLE001
        pass
    try:
        server.wait(timeout=15)
    except Exception:  # noqa: BLE001
        server.kill()


def _kernel_gcups() -> tuple[float, float, str]:
    """Banded verification kernel on the GPU at the PEX-root shape
    (floxer_tpu.tools.kernel_check's workload), warm, each call ending in
    block_until_ready. Returns (full_dp_equiv_gcups, band_cell_gcups,
    device_kind); raises when JAX's backend is not a GPU."""
    import jax

    from floxer_tpu.backend import accelerator
    from floxer_tpu.ops import banded
    from floxer_tpu.tools import kernel_check

    if not accelerator():
        raise RuntimeError(
            f"kernel bench needs a GPU, JAX has {jax.default_backend()}"
        )
    shape = kernel_check.ROOT_SHAPE
    patterns, texts = kernel_check._root_tasks()
    args, num_text = kernel_check._banded_device_inputs(patterns, texts)
    call = jax.jit(
        banded.banded_call, static_argnames=("band_words", "num_text")
    )
    run = lambda: call(  # noqa: E731
        *args, band_words=shape["band_words"], num_text=num_text
    )
    jax.block_until_ready(run())
    iters = 3
    started = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(run())
    elapsed = time.perf_counter() - started

    T, M, N, K = shape["tasks"], shape["m"], shape["n"], shape["budget"]
    full_cells = T * M * N * iters
    band_rows = min(N - M + 2 * K + 1, M)
    band_cells = T * band_rows * N * iters
    return (
        full_cells / elapsed / 1e9,
        band_cells / elapsed / 1e9,
        jax.devices()[0].device_kind,
    )


def main() -> int:
    num_reads = int(os.environ.get("FLOXER_BENCH_READS", "2000"))
    genome, reads, index = _ensure_workload(num_reads)
    data = _data_dir()
    cpu_env = {"JAX_PLATFORMS": "cpu"}

    # pre-build the native library so no timed pass pays the one-time g++
    # compile inside its align timing
    from floxer_tpu import native as _native

    _native.get_library()

    # index build (cached): its own phase, excluded from reads/s — the
    # reference reuses a saved index the same way (floxer.cpp:63-107).
    # A 1-read query file keeps the build pass from aligning the workload.
    if not index.exists():
        one_read = data / "bench_one_read.fastq"
        with open(reads) as src, open(one_read, "w") as dst:
            for _ in range(4):
                dst.write(src.readline())
        _run_aligner(
            genome, one_read, index, data / "bench_warm.sam",
            [], cpu_env, timeout_s=3600,
        )

    passes = int(os.environ.get("FLOXER_BENCH_PASSES", "2"))

    cpu_align_s = None
    cpu_stages: dict = {}
    if not os.environ.get("FLOXER_BENCH_SKIP_CPU"):
        for _ in range(passes):
            got = _run_aligner(
                genome, reads, index, data / "bench_cpu.sam",
                [], cpu_env, timeout_s=1800,
            )
            if got is not None and (
                cpu_align_s is None or got[0] < cpu_align_s
            ):
                cpu_align_s = got[0]
                cpu_stages = got[2]

    # device passes: fresh CLI processes with the PRODUCTION DEFAULT
    # engine on the GPU (the first pass also records and compiles the
    # fused plans; the best pass is what steady production looks like)
    device_align_s = None
    device_fused = 0
    device_stages: dict = {}
    device_mode = None
    device_deadline = time.monotonic() + float(
        os.environ.get("FLOXER_BENCH_DEVICE_BUDGET_S", "2400")
    )
    for _ in range(passes):
        remaining = device_deadline - time.monotonic()
        if remaining < 300:
            break
        got = _run_aligner(
            genome, reads, index, data / "bench_dev.sam",
            [], {}, timeout_s=min(1200, int(remaining)),
        )
        if got is not None and (
            device_align_s is None or got[0] < device_align_s
        ):
            device_align_s, device_fused, device_stages = got
            device_mode = "cold-cli"

    # warm-service passes: the service starts only now, after the CLI
    # passes, so it is the one process on the card
    if not os.environ.get("FLOXER_BENCH_SKIP_SERVER"):
        remaining = device_deadline - time.monotonic()
        if remaining > 300:
            handle = _start_bench_server(data)
            try:
                got = _server_device_passes(
                    handle, genome, reads, index, data,
                    deadline=device_deadline, passes=passes,
                )
            finally:
                _stop_bench_server(handle)
            if got is not None and (
                device_align_s is None or got[0] < device_align_s
            ):
                device_align_s, device_fused, device_stages = got
                device_mode = "warm-server"

    sam_identical = None
    if cpu_align_s is not None and device_align_s is not None:
        sam_identical = (
            (data / "bench_cpu.sam").read_bytes()
            == (data / "bench_dev.sam").read_bytes()
        )

    kernel_gcups = kernel_band_gcups = None
    kernel_device = None
    if not os.environ.get("FLOXER_BENCH_SKIP_KERNEL"):
        # its own process: the card holds one JAX process at a time
        proc = subprocess.run(
            [sys.executable, str(REPO / "bench.py"), "--kernel-bench"],
            capture_output=True, text=True, timeout=900, cwd=REPO,
        )
        for line in proc.stdout.splitlines():
            if line.startswith("KERNEL "):
                payload = json.loads(line[len("KERNEL "):])
                kernel_gcups = payload["gcups"]
                kernel_band_gcups = payload["band_gcups"]
                kernel_device = payload["device_kind"]
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-1000:] + "\n")

    value = num_reads / device_align_s if device_align_s else None
    cpu_rps = num_reads / cpu_align_s if cpu_align_s else None

    print(
        json.dumps(
            {
                "metric": "e2e_reads_per_sec_chr21_p008",
                "value": value,
                "unit": "reads/s/chip",
                # the reference publishes no numbers (BASELINE.md); the
                # baseline is the 4-core CPU engine of the SAME pipeline
                # on the same machine
                "vs_baseline": value / cpu_rps if value and cpu_rps else None,
                "cpu_reads_per_sec": cpu_rps,
                "device_align_seconds": device_align_s,
                "cpu_align_seconds": cpu_align_s,
                "fused_device_dispatches": device_fused,
                "device_mode": device_mode,
                # per-stage wall attribution; stages overlap in the
                # 3-stage pipeline so sums can exceed the align wall.
                # device_kernel_s = unhidden device time.
                "device_stages": device_stages or None,
                "cpu_stages": cpu_stages or None,
                "sam_identical": sam_identical,
                "kernel_gcups": kernel_gcups,
                "kernel_band_gcups": kernel_band_gcups,
                "kernel_device_kind": kernel_device,
                "workload": (
                    f"46Mb chr21-scale, {num_reads}x20kb reads @7% muts, "
                    f"-p 0.08 -I --threads 4"
                ),
            }
        )
    )
    return 0 if value is not None else 1


def _kernel_bench_subprocess() -> None:
    """--kernel-bench mode: run the kernel microbenchmark and print a
    single 'KERNEL {json}' line for the parent to parse."""
    sys.path.insert(0, str(REPO))
    gcups, band_gcups, device_kind = _kernel_gcups()
    print(
        "KERNEL "
        + json.dumps(
            {
                "gcups": gcups,
                "band_gcups": band_gcups,
                "device_kind": device_kind,
            }
        )
    )


if __name__ == "__main__":
    if "--kernel-bench" in sys.argv:
        _kernel_bench_subprocess()
    else:
        sys.exit(main())
