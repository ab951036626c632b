"""Profile the host search stage alone (no device): PEX tree build + seed
generation + chunk-batched native FM search on one 250-read E. coli chunk.

Usage: python scripts/profile_search_stage.py [N_READS] [THREADS]
"""

import cProfile
import io
import pstats
import sys
import time

from floxer_tpu.cli import parse_and_validate
from floxer_tpu.io.sequence_io import Queries, read_references
from floxer_tpu.pipeline import build_or_load_index, make_searcher, prepare_query_tree

N = int(sys.argv[1]) if len(sys.argv) > 1 else 250
THREADS = int(sys.argv[2]) if len(sys.argv) > 2 else 4

cli = parse_and_validate(
    [
        "--reference", "/tmp/ecoli/genome1k.fasta",
        "--queries", "/tmp/ecoli/reads1k.fastq",
        "--index", "/tmp/ecoli/idx1k.npz",
        "--output", "/tmp/ecoli/profile_search.sam",
        "--error-probability", "0.07",
        "--interval-optimization",
        "--threads", str(THREADS),
    ]
)
references = read_references(cli.reference_path)
index = build_or_load_index(cli, references)
searcher = make_searcher(cli, index, len(references.records))

queries = []
stream = iter(
    Queries(cli.queries_path, cli.query_num_errors, cli.query_error_probability,
            cli.pex_seed_num_errors)
)
for q in stream:
    queries.append(q)
    if len(queries) >= N:
        break

def run_once():
    t0 = time.monotonic()
    prepared = []
    jobs = []
    for query in queries:
        pex_tree, seeds = prepare_query_tree(query, cli)
        prepared.append((pex_tree, seeds))
        jobs.append((seeds, query.rank_sequence))
        jobs.append((seeds, query.reverse_complement_rank_sequence))
    t1 = time.monotonic()
    searched = searcher.search_seeds_many(jobs)
    t2 = time.monotonic()
    print(f"prepare(pex+seeds): {t1-t0:.3f}s   native search_many: {t2-t1:.3f}s")
    return searched

# warm (caches PEX trees, scheme tables)
run_once()
print("--- warm run, timed ---")
run_once()

print("--- warm run, cProfile ---")
prof = cProfile.Profile()
prof.enable()
run_once()
prof.disable()
s = io.StringIO()
pstats.Stats(prof, stream=s).sort_stats("cumulative").print_stats(25)
print(s.getvalue())
