"""Time the device seed search (search_device.DeviceSearcher) against the
native host DFS on one chunk of the chr21-scale smoke workload, on the GPU.

Usage: python scripts/devsearch_chunk.py [N_READS] [--host]

Reads the genome, reads and index that `python3 chip_smoke.py` leaves in
.data/smoke/ (its set-up phase makes them). Exits unless JAX's default
backend is a GPU: a CPU timing says nothing about the card.
"""

import sys
import time
from pathlib import Path

N = int(sys.argv[1]) if len(sys.argv) > 1 else 50
RUN_HOST = "--host" in sys.argv

from floxer_tpu.backend import accelerator  # noqa: E402

if not accelerator():
    sys.exit("devsearch_chunk: needs a GPU backend")

from floxer_tpu.cli import parse_and_validate  # noqa: E402
from floxer_tpu.io.sequence_io import Queries, read_references  # noqa: E402
from floxer_tpu.pipeline import (  # noqa: E402
    build_or_load_index,
    make_searcher,
    prepare_query_tree,
)

DATA = Path(__file__).resolve().parent.parent / ".data" / "smoke"

cli = parse_and_validate([
    "--reference", str(DATA / "genome.fasta"),
    "--queries", str(DATA / "reads.fastq"),
    "--index", str(DATA / "genome.index.npz"),
    "--output", str(DATA / "devsearch_chunk.sam"),
    "--error-probability", "0.08",
    "--interval-optimization",
    "--threads", "4",
])
references = read_references(cli.reference_path)
t = time.monotonic()
index = build_or_load_index(cli, references)
print(f"index load: {time.monotonic()-t:.2f}s", flush=True)
host_searcher = make_searcher(cli, index, len(references.records))

queries = []
for q in Queries(
    cli.queries_path, cli.query_num_errors, cli.query_error_probability,
    cli.pex_seed_num_errors,
):
    queries.append(q)
    if len(queries) >= N:
        break

jobs = []
for query in queries:
    _, seeds = prepare_query_tree(query, cli)
    jobs.append((seeds, query.rank_sequence))
    jobs.append((seeds, query.reverse_complement_rank_sequence))
num_seeds = sum(len(s) for s, _ in jobs)
print(f"{len(jobs)} jobs, {num_seeds} seeds", flush=True)

if RUN_HOST:
    for tag in ("host-warm", "host-1", "host-2"):
        t0 = time.monotonic()
        want = host_searcher.search_seeds_many(jobs)
        print(f"[{tag}] {time.monotonic()-t0:.2f}s", flush=True)

from floxer_tpu.index.device_index import DeviceIndex  # noqa: E402
from floxer_tpu.search_device import DeviceSearcher  # noqa: E402

t0 = time.monotonic()
device_index = DeviceIndex.from_host(index)
import jax  # noqa: E402

jax.block_until_ready(device_index.fwd.planes)
print(f"device index upload: {time.monotonic()-t0:.2f}s", flush=True)

device_searcher = DeviceSearcher(host_searcher, device_index)
for tag in ("dev-warm", "dev-1", "dev-2"):
    t0 = time.monotonic()
    got = device_searcher.search_seeds_many(jobs)
    print(
        f"[{tag}] {time.monotonic()-t0:.2f}s "
        f"(chunk dispatches so far: {DeviceSearcher._chunk_dispatches})",
        flush=True,
    )

if RUN_HOST:
    mismatch = 0
    for w, g in zip(want, got):
        lw = list(zip(*[a.tolist() for a in w.flat_arrays()]))
        lg = list(zip(*[a.tolist() for a in g.flat_arrays()]))
        mismatch += lw != lg
    print(f"jobs with flat-anchor mismatch: {mismatch}/{len(jobs)}", flush=True)
