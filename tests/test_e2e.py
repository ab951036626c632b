"""Whole-program end-to-end test.

Parity with reference test/floxer_whole_program_via_cli_test.cpp: run the
aligner on the tiny reference + 6 queries with --query-errors 2
--extra-verification-ratio 2 --interval-optimization for seed errors 0 and 1,
and assert the exact SAM record expectations (lines 44-100 of the reference
test). Also covers BAM output, stats output and the without-cigar mode.
"""

import subprocess
import sys

import pytest


def run_aligner(tmp_path, data_dir, extra_args, out_name="out.sam"):
    import os

    output = tmp_path / out_name
    command = [
        sys.executable,
        "-m",
        "floxer_tpu",
        "--reference",
        str(data_dir / "reference.fasta"),
        "--queries",
        str(data_dir / "queries.fastq"),
        "--output",
        str(output),
        "--interval-optimization",
        "--console-debug-logs",
        *extra_args,
    ]
    env = dict(os.environ)
    # keep subprocess JAX work on the CPU in tests
    env["FLOXER_TPU_PLATFORM"] = "cpu"
    proc = subprocess.run(command, capture_output=True, text=True, env=env)
    return proc, output


def parse_sam(path):
    records = []
    for line in open(path):
        line = line.rstrip("\n")
        if line.startswith("@"):
            continue
        fields = line.split("\t")
        tags = {}
        for tag_field in fields[11:]:
            name, tag_type, value = tag_field.split(":", 2)
            tags[name] = int(value) if tag_type == "i" else value
        records.append(
            {
                "qname": fields[0],
                "flag": int(fields[1]),
                "rname": fields[2],
                "pos": int(fields[3]) - 1,  # back to 0-based
                "mapq": int(fields[4]),
                "cigar": fields[5],
                "seq": fields[9],
                "qual": fields[10],
                "tags": tags,
            }
        )
    return records


def check_output_records(records):
    """The reference e2e expectations (floxer_whole_program_via_cli_test.cpp:44-100)."""
    mentioned = set()
    for record in records:
        mentioned.add(record["qname"])
        qname = record["qname"]
        flag = record["flag"]
        reverse = bool(flag & 16)

        if qname in ("query1", "query6"):
            assert flag & 4, f"{qname} must be unmapped"
            continue

        assert not flag & 4, f"{qname} must be mapped"

        if qname == "query2" and reverse:
            assert record["pos"] == 48
            assert record["tags"]["NM"] == 0
            assert record["cigar"] == "12="
        elif qname == "query2":
            assert record["pos"] == 11
            assert record["tags"]["NM"] == 0
            assert record["cigar"] == "12="
        elif qname == "query3" and reverse:
            assert 17 <= record["pos"] <= 26
            assert record["tags"]["NM"] == 2
            assert record["cigar"] == "6=2I4="
        elif qname == "query3":
            assert 36 <= record["pos"] <= 44
            assert record["tags"]["NM"] == 2
            assert record["cigar"] == "4=2I6="
        elif qname == "query4" and reverse:
            assert 7 <= record["pos"] <= 61
            assert record["tags"]["NM"] == 2
            assert record["cigar"] == "2I10="
        elif qname == "query4":
            assert 54 <= record["pos"] <= 61
            assert record["tags"]["NM"] == 2
            assert record["cigar"] == "10=2I"
        elif qname == "query5" and reverse:
            assert record["pos"] == 53
            assert record["tags"]["NM"] == 0
            assert record["cigar"] == "12="
        elif qname == "query5":
            assert record["pos"] == 6
            assert record["tags"]["NM"] == 0
            assert record["cigar"] == "12="

    assert mentioned == {f"query{i}" for i in range(1, 7)}


@pytest.mark.parametrize("seed_errors", [0, 1])
def test_whole_program_via_cli(tmp_path, data_dir, seed_errors):
    proc, output = run_aligner(
        tmp_path,
        data_dir,
        [
            "--query-errors",
            "2",
            "--seed-errors",
            str(seed_errors),
            "--extra-verification-ratio",
            "2",
        ],
    )
    assert proc.returncode == 0, proc.stderr
    # all diagnostics must go to stderr; stdout stays empty
    assert proc.stdout == ""
    check_output_records(parse_sam(output))


def test_whole_program_bam_output(tmp_path, data_dir):
    proc, output = run_aligner(
        tmp_path,
        data_dir,
        ["--query-errors", "2", "--seed-errors", "1",
         "--extra-verification-ratio", "2"],
        out_name="out.bam",
    )
    assert proc.returncode == 0, proc.stderr

    # decode BGZF-BAM back into records and run the same checks
    import gzip
    import struct

    raw = gzip.decompress(open(output, "rb").read())
    assert raw[:4] == b"BAM\x01"
    l_text = struct.unpack("<i", raw[4:8])[0]
    offset = 8 + l_text
    n_ref = struct.unpack("<i", raw[offset : offset + 4])[0]
    offset += 4
    names = []
    for _ in range(n_ref):
        l_name = struct.unpack("<i", raw[offset : offset + 4])[0]
        names.append(raw[offset + 4 : offset + 4 + l_name - 1].decode())
        offset += 4 + l_name + 4
    records = []
    while offset < len(raw):
        block_size = struct.unpack("<i", raw[offset : offset + 4])[0]
        body = raw[offset + 4 : offset + 4 + block_size]
        offset += 4 + block_size
        ref_id, pos = struct.unpack("<ii", body[0:8])
        l_read_name = body[8]
        n_cigar, flag = struct.unpack("<HH", body[12:16])
        qname = body[32 : 32 + l_read_name - 1].decode()
        cigar_raw = struct.unpack(
            f"<{n_cigar}I", body[32 + l_read_name : 32 + l_read_name + 4 * n_cigar]
        )
        cigar = "".join(f"{c >> 4}{'MIDNSHP=X'[c & 15]}" for c in cigar_raw)
        # NM tag: scan the tail for 'NMi'
        tags = {}
        tail = body
        nm_idx = tail.rfind(b"NMi")
        if nm_idx >= 0:
            tags["NM"] = struct.unpack("<i", tail[nm_idx + 3 : nm_idx + 7])[0]
        records.append(
            {
                "qname": qname,
                "flag": flag,
                "rname": names[ref_id] if ref_id >= 0 else "",
                "pos": pos,
                "mapq": body[9],
                "cigar": cigar,
                "seq": "",
                "qual": "",
                "tags": tags,
            }
        )
    check_output_records(records)


def test_device_search_e2e(tmp_path, data_dir):
    """Full device pipeline: frontier search + batched verification must
    satisfy the reference e2e expectations (caps don't bind here)."""
    proc, output = run_aligner(
        tmp_path,
        data_dir,
        [
            "--query-errors", "2", "--seed-errors", "1",
            "--extra-verification-ratio", "2",
            "--engine", "device", "--device-search",
        ],
    )
    assert proc.returncode == 0, proc.stderr
    check_output_records(parse_sam(output))


@pytest.mark.parametrize("engine", ["batched", "device"])
def test_engines_produce_identical_sam(tmp_path, data_dir, engine):
    """The batched/device engines must emit byte-identical records to the
    sequential reference engine."""
    base_args = [
        "--query-errors", "2", "--seed-errors", "1",
        "--extra-verification-ratio", "2",
    ]
    _, ref_out = run_aligner(
        tmp_path, data_dir, base_args + ["--engine", "reference"], "ref.sam"
    )
    proc, engine_out = run_aligner(
        tmp_path, data_dir, base_args + ["--engine", engine], f"{engine}.sam"
    )
    assert proc.returncode == 0, proc.stderr
    assert parse_sam(ref_out) == parse_sam(engine_out)


def test_without_cigar_mode(tmp_path, data_dir):
    proc, output = run_aligner(
        tmp_path,
        data_dir,
        ["--query-errors", "2", "--seed-errors", "1",
         "--extra-verification-ratio", "2", "--without-cigar"],
    )
    assert proc.returncode == 0, proc.stderr
    records = parse_sam(output)
    mapped = [r for r in records if not r["flag"] & 4]
    assert mapped
    for record in mapped:
        assert record["cigar"] == "*"
        assert record["tags"]["NM"] in (0, 1, 2)


def test_multithreaded_matches_reference_expectations(tmp_path, data_dir):
    """Parity with the reference's 4-thread e2e variant
    (floxer_whole_program_via_cli_test.cpp:141-143)."""
    proc, output = run_aligner(
        tmp_path,
        data_dir,
        ["--query-errors", "2", "--seed-errors", "1",
         "--extra-verification-ratio", "2", "--threads", "4",
         "--engine", "batched"],
    )
    assert proc.returncode == 0, proc.stderr
    check_output_records(parse_sam(output))


def test_logfile_written(tmp_path, data_dir):
    logfile = tmp_path / "floxer.log"
    proc, _ = run_aligner(
        tmp_path,
        data_dir,
        ["--query-errors", "2", "--logfile", str(logfile)],
    )
    assert proc.returncode == 0, proc.stderr
    assert logfile.exists()
    assert "aligning queries" in logfile.read_text()


def test_timeout_truncates_and_fails(tmp_path, data_dir):
    import time as _time

    proc, output = run_aligner(
        tmp_path,
        data_dir,
        ["--query-errors", "2", "--timeout", "0"],
    )
    # exit -1 (=255) and a warning; output may be truncated
    assert proc.returncode == 255
    assert "Timeout happened" in proc.stderr


def test_stats_toml_output(tmp_path, data_dir):
    stats_path = tmp_path / "stats.toml"
    proc, _ = run_aligner(
        tmp_path,
        data_dir,
        ["--query-errors", "2", "--seed-errors", "1",
         "--extra-verification-ratio", "2", "--stats", str(stats_path)],
    )
    assert proc.returncode == 0, proc.stderr
    text = stats_path.read_text()
    assert "completely_excluded_queries" in text
    assert "[query_lengths]" in text
    assert "num_values = 6" in text


def test_sharded_index_search_e2e(tmp_path, data_dir):
    """--index-shards 2 on the virtual CPU mesh: byte-identical SAM to the
    default host search (the hg38-scale sharded-search configuration)."""
    import os

    base_proc, base_out = run_aligner(
        tmp_path,
        data_dir,
        ["--query-errors", "2", "--seed-errors", "1",
         "--extra-verification-ratio", "2"],
        out_name="base.sam",
    )
    assert base_proc.returncode == 0, base_proc.stderr

    output = tmp_path / "sharded.sam"
    command = [
        sys.executable, "-m", "floxer_tpu",
        "--reference", str(data_dir / "reference.fasta"),
        "--queries", str(data_dir / "queries.fastq"),
        "--output", str(output),
        "--interval-optimization", "--console-debug-logs",
        "--query-errors", "2", "--seed-errors", "1",
        "--extra-verification-ratio", "2",
        "--index-shards", "2",
    ]
    env = dict(os.environ)
    env["FLOXER_TPU_PLATFORM"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
    ).strip()
    proc = subprocess.run(command, capture_output=True, text=True, env=env)
    assert proc.returncode == 0, proc.stderr
    assert open(base_out).read() == open(output).read()


def test_num_anchors_per_task_is_consumed_and_neutral(tmp_path, data_dir):
    """--num-anchors-per-task sets the reference engine's verification
    package granularity (create_anchor_packages, parallelization.cpp:14-43);
    like in the reference, the boundary must not change the output."""
    _, base = run_aligner(
        tmp_path,
        data_dir,
        ["--query-errors", "2", "--extra-verification-ratio", "2",
         "--engine", "reference"],
        out_name="base.sam",
    )
    _, tiny = run_aligner(
        tmp_path,
        data_dir,
        ["--query-errors", "2", "--extra-verification-ratio", "2",
         "--engine", "reference", "--num-anchors-per-task", "1"],
        out_name="tiny.sam",
    )
    assert parse_sam(base) == parse_sam(tiny)
