"""BASELINE ladder runner: one (genome, reads) config end-to-end.

Builds/reuses the FM-index artifact, runs the aligner CLI as a fresh
process (CPU pass and/or device pass), extracts the align-phase seconds
from the log, verifies accuracy with the simulated_dataset tool, and
prints one summary line per pass. SAMs of all passes are md5-compared.

Usage:
  python scripts/run_ladder.py --genome G.fasta --reads R.fastq \
      -p 0.08 [--reads-count N] [--passes cpu,device] [--batch-size 250] \
      [--index IDX.npz] [--out-dir DIR] [--index-shards K]
"""

import argparse
import hashlib
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
ALIGN_RE = re.compile(r"finished aligning successfully in ([0-9.]+) seconds")


def run_pass(name, env_extra, extra_args, args, index_path, out_dir):
    out_sam = out_dir / f"ladder_{name}.sam"
    log = out_dir / f"ladder_{name}.log"
    cmd = [
        sys.executable, "-m", "floxer_tpu",
        "--reference", args.genome,
        "--queries", args.reads,
        "--output", str(out_sam),
        "-i", str(index_path),
        "--error-probability", str(args.error_probability),
        "--interval-optimization",
        "--threads", str(args.threads),
        "--batch-size", str(args.batch_size),
    ] + extra_args
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env.update(env_extra)
    t0 = time.monotonic()
    with open(log, "w") as sink:
        code = subprocess.call(cmd, stdout=sink, stderr=sink, env=env)
    wall = time.monotonic() - t0
    text = log.read_text()
    match = ALIGN_RE.search(text)
    align_s = float(match.group(1)) if match else float("nan")
    md5 = (
        hashlib.md5(out_sam.read_bytes()).hexdigest()[:8]
        if out_sam.exists()
        else "-"
    )
    print(
        f"[{name}] exit={code} align={align_s:.1f}s wall={wall:.1f}s "
        f"sam_md5={md5} log={log}",
        flush=True,
    )
    return out_sam, align_s, code


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome", required=True)
    ap.add_argument("--reads", required=True)
    ap.add_argument("-p", "--error-probability", type=float, required=True)
    ap.add_argument("--passes", default="cpu,device")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=250)
    ap.add_argument("--index", default=None)
    ap.add_argument(
        "--out-dir",
        default=str(Path(__file__).resolve().parent.parent / ".data" / "ladder"),
    )
    ap.add_argument("--index-shards", type=int, default=0)
    ap.add_argument("--skip-verify", action="store_true")
    args = ap.parse_args()

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    index_path = Path(
        args.index or (out_dir / (Path(args.genome).stem + "_index.npz"))
    )

    reads_count = sum(1 for _ in open(args.reads)) // 4
    print(
        f"ladder: genome={args.genome} reads={reads_count} "
        f"p={args.error_probability} index={index_path}",
        flush=True,
    )

    results = {}
    for name in args.passes.split(","):
        if name == "cpu":
            env = {"FLOXER_TPU_PLATFORM": "cpu"}
            extra = []
        elif name == "default":
            # production default: cost-model routing (fused device waves
            # when the chip wins, native host engines otherwise)
            env = {}
            extra = []
            if args.index_shards:
                extra += ["--index-shards", str(args.index_shards)]
        elif name == "device":
            # device verify engine; search stays on the native host DFS
            env = {}
            extra = ["--engine", "device"]
            if args.index_shards:
                extra += ["--index-shards", str(args.index_shards)]
        elif name == "device-search":
            # fully on-device: device verify engine + frontier seed search
            env = {}
            extra = ["--engine", "device", "--device-search"]
            if args.index_shards:
                extra += ["--index-shards", str(args.index_shards)]
        else:
            raise SystemExit(f"unknown pass {name}")
        sam, align_s, code = run_pass(
            name, env, extra, args, index_path, out_dir
        )
        if code == 0:
            results[name] = (sam, align_s)
            rate = reads_count / align_s if align_s > 0 else float("nan")
            print(f"[{name}] reads/s = {rate:.1f}", flush=True)

    sams = [sam for sam, _ in results.values()]
    if len(sams) > 1:
        digests = {hashlib.md5(s.read_bytes()).hexdigest() for s in sams}
        print(
            "SAM equality: "
            + ("IDENTICAL" if len(digests) == 1 else f"DIFFER ({digests})"),
            flush=True,
        )

    if results and not args.skip_verify:
        sam = sams[0]
        code = subprocess.call(
            [
                sys.executable, "-m",
                "floxer_tpu.tools.simulated_dataset", "verify",
                "-a", str(sam), "-p", "0",
            ],
            env={**os.environ, "PYTHONPATH": str(REPO)},
        )
        print(f"verify(pos_diff=0) exit={code}", flush=True)


if __name__ == "__main__":
    main()
