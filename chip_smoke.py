#!/usr/bin/env python3
"""Smoke test of the aligner's main path on the GPU, through the entry
points a user calls.

    python3 chip_smoke.py               # one card
    python3 chip_smoke.py --four-cards  # the --index-shards 4 path, 4 cards

Workload: BASELINE.json config 3 (chr21 scale) with the read shape of the
reference's evaluation (simulated_dataset.cpp:234-239) — a seeded
46,000,000-base one-record genome and 500 reads of 20,000 bases at 7%
simulated mutations, aligned with -p 0.08 --interval-optimization
--threads 4 --batch-size 250 (two chunks). Data and index go to
.data/smoke/ in the checkout; generating them and building the index run
on the CPU and count as set-up.

Phases (one card):
  1. device       JAX's platform, device kind and count; nvidia-smi's
                  name and power limit. A platform other than gpu fails.
  2. kernels      every device kernel compiled at real widths, compared
                  exactly with the plain references and timed
                  (floxer_tpu.tools.kernel_check), then the tests that
                  need the card (pytest -m gpu).
  3. host oracle  the CLI on the CPU (host engines); its SAM is the oracle.
  4. default      the default engine on the GPU: at least one fused
                  dispatch, device kernel time > 0, SAM byte-identical.
  5. device       --engine device: every wave through the fused program.
  6. devsearch    --device-search: the work-queue seed search on the GPU.
  7. server       --serve on the GPU, two jobs through --server, both SAMs
                  byte-identical, then shutdown.

--four-cards runs only the host oracle and the --index-shards 4 CLI over
four cards, requires a byte-identical SAM and prints the per-device peak
memory.

The parent process never imports JAX: every phase is a child process, one
at a time, so one process holds the card. Any failed phase exits non-zero
before the result line. The last line of standard output is one JSON
object, {"ok": true, "device": {"platform", "kind", "count"}}; each
child's output streams to chiprun_out/smoke/<phase>.out and .err.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DATA = REPO / ".data" / "smoke"
LOGS = REPO / "chiprun_out" / "smoke"

GENOME_LENGTH = 46_000_000
NUM_READS = 500
READ_LENGTH = 20_000
MUTATION_RATE = 0.07
SEED = 20260819
ALIGN_ARGS = [
    "--error-probability", "0.08",
    "--interval-optimization",
    "--threads", "4",
    "--batch-size", "250",
    "--console-debug-logs",
]
TIME_LIMIT_S = 1150.0  # the whole script, compilation included

ALIGN_SECONDS_RE = re.compile(
    r"finished aligning successfully in ([0-9.]+) seconds"
)
STAGE_SPLIT_RE = re.compile(
    r"stage split: search=([0-9.]+)s verify=([0-9.]+)s "
    r"finalize=([0-9.]+)s device_kernel=([0-9.]+)s fused_dispatches=(\d+)"
)
PEAK_BYTES_RE = re.compile(r"device peak bytes in use: \[([0-9, ]*)\]")
# the server's readiness: a real execution on the card, then the socket
SERVER_READY = ("backend probe ok", "listening on")


class SmokeFailure(Exception):
    pass


_STARTED = time.monotonic()


def _remaining() -> float:
    return TIME_LIMIT_S - (time.monotonic() - _STARTED)


def _say(message: str) -> None:
    print(message, flush=True)


def _env(cpu: bool = False) -> dict:
    env = dict(os.environ)
    env.pop("FLOXER_TPU_PLATFORM", None)
    if cpu:
        env["JAX_PLATFORMS"] = "cpu"
    return env


def _run(label: str, command: list[str], *, env: dict, timeout: float):
    """One child process to completion. Its output streams to
    LOGS/label.out and LOGS/label.err while it runs, so a child that is
    killed still leaves its log. A non-zero exit or the time limit fails
    the smoke test."""
    timeout = min(timeout, _remaining())
    if timeout <= 0:
        raise SmokeFailure(f"{label}: no time left")
    out_path, err_path = LOGS / f"{label}.out", LOGS / f"{label}.err"
    started = time.monotonic()
    with open(out_path, "w") as out, open(err_path, "w") as err:
        err.write(f"$ {' '.join(command)}\n")
        err.flush()
        try:
            returncode = subprocess.run(
                command, cwd=REPO, env=env, stdout=out, stderr=err,
                timeout=timeout,
            ).returncode
        except subprocess.TimeoutExpired as error:
            raise SmokeFailure(
                f"{label}: timed out after {timeout:.0f} s; see {err_path}"
            ) from error
    elapsed = time.monotonic() - started
    proc = subprocess.CompletedProcess(
        command, returncode, out_path.read_text(), err_path.read_text()
    )
    if returncode != 0:
        tail = (proc.stderr or proc.stdout)[-3000:]
        raise SmokeFailure(
            f"{label}: exit {returncode} after {elapsed:.1f} s\n{tail}"
        )
    return proc, elapsed


def _sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _aligner(output: Path, extra: list[str]) -> list[str]:
    return [
        sys.executable, "-m", "floxer_tpu",
        "--reference", str(DATA / "genome.fasta"),
        "--queries", str(DATA / "reads.fastq"),
        "--index", str(DATA / "genome.index.npz"),
        "--output", str(output),
        *ALIGN_ARGS,
        *extra,
    ]


def _align_stats(label: str, stderr: str) -> dict:
    stats = {}
    match = ALIGN_SECONDS_RE.search(stderr)
    if match is None:
        raise SmokeFailure(f"{label}: no 'finished aligning' line")
    stats["align_s"] = float(match.group(1))
    split = STAGE_SPLIT_RE.search(stderr)
    if split is not None:
        stats.update(
            search_s=float(split.group(1)),
            verify_s=float(split.group(2)),
            finalize_s=float(split.group(3)),
            device_kernel_s=float(split.group(4)),
            fused_dispatches=int(split.group(5)),
        )
    peaks = PEAK_BYTES_RE.search(stderr)
    if peaks is not None:
        stats["peak_bytes_in_use"] = [
            int(v) for v in peaks.group(1).split(",") if v.strip()
        ]
    return stats


def _check_same(label: str, sam: Path, oracle: Path) -> str:
    digest = _sha256(sam)
    if sam.read_bytes() != oracle.read_bytes():
        raise SmokeFailure(
            f"{label}: SAM {digest} differs from the host oracle "
            f"{_sha256(oracle)}"
        )
    return digest


# --- phases -------------------------------------------------------------------


def phase_device(expected_count: int) -> dict:
    probe = (
        "import json, jax; d = jax.devices(); print(json.dumps({"
        "'platform': d[0].platform, 'kind': d[0].device_kind, "
        "'count': len(d)}))"
    )
    proc, _ = _run(
        "device", [sys.executable, "-c", probe], env=_env(), timeout=180
    )
    device = json.loads(proc.stdout.strip().splitlines()[-1])
    if device["platform"] != "gpu":
        raise SmokeFailure(f"device: platform {device['platform']}, not gpu")
    if device["count"] < expected_count:
        raise SmokeFailure(
            f"device: {device['count']} devices, {expected_count} needed"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        raise SmokeFailure(f"device: nvidia-smi failed: {smi.stderr}")
    _say(f"phase device: {json.dumps(device)}")
    for line in smi.stdout.strip().splitlines():
        _say(line.strip())
    return device


def setup_workload() -> None:
    """Genome, reads and index, made once on the CPU (set-up time)."""
    DATA.mkdir(parents=True, exist_ok=True)
    done = DATA / "workload.done"
    if not done.exists():
        _run(
            "setup_dataset",
            [
                sys.executable, "-m", "floxer_tpu.tools.simulated_dataset",
                "create",
                "-g", str(DATA / "genome.fasta"),
                "-r", str(DATA / "reads.fastq"),
                "-c", str(GENOME_LENGTH), "-n", "1",
                "-l", str(READ_LENGTH), "-m", str(NUM_READS),
                "-e", str(MUTATION_RATE), "-s", str(SEED),
            ],
            env=_env(cpu=True), timeout=600,
        )
        one_read = DATA / "one_read.fastq"
        with open(DATA / "reads.fastq") as src, open(one_read, "w") as dst:
            for _ in range(4):
                dst.write(src.readline())
        (DATA / "genome.index.npz").unlink(missing_ok=True)
        command = _aligner(DATA / "setup.sam", [])
        command[command.index(str(DATA / "reads.fastq"))] = str(one_read)
        _run("setup_index", command, env=_env(cpu=True), timeout=900)
        done.write_text("ok\n")
    _say(f"set-up: workload ready in {DATA} ({time.monotonic() - _STARTED:.1f} s)")


def phase_kernels() -> None:
    proc, elapsed = _run(
        "kernels",
        [sys.executable, "-m", "floxer_tpu.tools.kernel_check",
         "--out", str(LOGS / "kernels.jsonl")],
        env=_env(), timeout=600,
    )
    for line in proc.stdout.splitlines():
        if line.startswith("kernel_check:"):
            _say(line)
        elif line.startswith("KERNEL "):
            record = json.loads(line[len("KERNEL "):])
            rate = record.get("band_cells_per_s", record.get("cells_per_s"))
            _say(
                f"  {record['kernel']}/{record['implementation']}: "
                f"median call {sorted(record['call_s'])[len(record['call_s']) // 2]:.4f} s, "
                f"{rate:.4g} cells/s, compile {record['compile_s']:.1f} s, "
                f"temp {record['memory'].get('temp_size_in_bytes')} B, "
                f"matches {record['matches']}"
            )
    proc, elapsed = _run(
        "kernels_pytest",
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "tests/"],
        env=_env(), timeout=600,
    )
    summary = proc.stdout.strip().splitlines()[-1]
    if "passed" not in summary or "skipped" in summary or "failed" in summary:
        raise SmokeFailure(f"kernels: pytest -m gpu: {summary}")
    _say(f"phase kernels: ok; pytest -m gpu: {summary}")


def phase_host_oracle() -> Path:
    oracle = DATA / "host.sam"
    proc, elapsed = _run(
        "host_oracle", _aligner(oracle, []), env=_env(cpu=True), timeout=600
    )
    stats = _align_stats("host_oracle", proc.stderr)
    _say(
        f"phase host oracle: sam {_sha256(oracle)} in {elapsed:.1f} s "
        f"{json.dumps(stats)}"
    )
    return oracle


def phase_gpu_cli(label: str, extra: list[str], oracle: Path) -> dict:
    sam = DATA / f"{label}.sam"
    proc, elapsed = _run(label, _aligner(sam, extra), env=_env(), timeout=600)
    stats = _align_stats(label, proc.stderr)
    digest = _check_same(label, sam, oracle)
    _say(
        f"phase {label}: sam identical {digest} in {elapsed:.1f} s "
        f"{json.dumps(stats)}"
    )
    return stats


def phase_server(oracle: Path) -> None:
    # relative to the checkout, where every child runs: short enough to bind
    socket_path = os.path.relpath(DATA / "server.sock", REPO)
    log_path = LOGS / "server.log"
    with open(log_path, "w") as log:
        server = subprocess.Popen(
            [sys.executable, "-m", "floxer_tpu", "--serve", socket_path],
            cwd=REPO, env=_env(), stdout=subprocess.DEVNULL, stderr=log,
        )
    try:
        deadline = time.monotonic() + min(300.0, _remaining())
        while True:
            text = log_path.read_text()
            if all(line in text for line in SERVER_READY):
                break
            if server.poll() is not None:
                raise SmokeFailure(
                    f"server: exited {server.returncode}\n{text[-3000:]}"
                )
            if time.monotonic() > deadline:
                raise SmokeFailure(f"server: not ready\n{text[-3000:]}")
            time.sleep(1.0)
        _say(f"phase server: ready after {time.monotonic() - _STARTED:.1f} s")
        for job in (1, 2):
            label = f"server_job{job}"
            sam = DATA / f"{label}.sam"
            command = [
                sys.executable, "-m", "floxer_tpu", "--server", socket_path,
                *_aligner(sam, [])[3:],
            ]
            proc, elapsed = _run(label, command, env=_env(), timeout=600)
            stats = _align_stats(label, proc.stderr)
            digest = _check_same(label, sam, oracle)
            _say(
                f"phase server job {job}: sam identical {digest} in "
                f"{elapsed:.1f} s {json.dumps(stats)}"
            )
        _run(
            "server_shutdown",
            [sys.executable, "-m", "floxer_tpu", "--shutdown-server",
             socket_path],
            env=_env(), timeout=60,
        )
        server.wait(timeout=60)
        if server.returncode != 0:
            raise SmokeFailure(f"server: exit {server.returncode} at shutdown")
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()


def main() -> int:
    parser = argparse.ArgumentParser(description="GPU smoke test")
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the host oracle and the --index-shards 4 CLI on four "
             "cards",
    )
    args = parser.parse_args()
    if not (REPO / "floxer_tpu" / "__main__.py").exists():
        print("chip_smoke: run from the root of a floxer checkout",
              file=sys.stderr)
        return 2
    LOGS.mkdir(parents=True, exist_ok=True)
    try:
        device = phase_device(4 if args.four_cards else 1)
        setup_workload()
        if args.four_cards:
            oracle = phase_host_oracle()
            stats = phase_gpu_cli("index_shards4", ["--index-shards", "4"], oracle)
            peaks = stats.get("peak_bytes_in_use")
            if not peaks or len(peaks) < 4:
                raise SmokeFailure(f"index_shards4: per-device peaks {peaks}")
            _say(f"phase index_shards4: per-device peak_bytes_in_use {peaks}")
        else:
            phase_kernels()
            oracle = phase_host_oracle()
            stats = phase_gpu_cli("default", [], oracle)
            if stats.get("fused_dispatches", 0) < 1:
                raise SmokeFailure(f"default: no fused dispatch {stats}")
            if stats.get("device_kernel_s", 0.0) <= 0.0:
                raise SmokeFailure(f"default: no device kernel time {stats}")
            phase_gpu_cli("device", ["--engine", "device"], oracle)
            phase_gpu_cli("devsearch", ["--device-search"], oracle)
            phase_server(oracle)
    except SmokeFailure as error:
        print(f"chip_smoke: FAILED: {error}", file=sys.stderr)
        return 1
    _say(f"chip_smoke: all phases ok in {time.monotonic() - _STARTED:.1f} s")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
