#!/usr/bin/env python
"""Catalogue-scale streaming benchmark with kill-resume equality proof.

North-star config 4 (BASELINE.json): annotate a 100k-protein catalogue on
one host. Drives the REAL pipeline (full-size models, streaming engine +
checkpoint, ``--skip-matrix``) three ways:

1. ``uninterrupted`` — one timed run to ``results.tsv``;
2. ``killed`` — the same run in a fresh output dir, ``kill -9``'d (by
   exact pgid) once the streaming checkpoint shows real progress;
3. ``resumed`` — the same command re-run on the killed output dir: the
   checkpoint restores completed scores and the run finishes.

It then asserts ROW-LEVEL EQUALITY between the uninterrupted and the
killed+resumed ``results.tsv`` (sorted row multisets), reports per-run
stage timings, and projects device-hours for a 1M-protein catalogue from
the measured throughput.

    python benchmarks/catalog_benchmark.py [--size 100000]
        [--workdir DIR] [--threads 8]

Writes BENCH_CATALOG.json at the repo root. The parent process builds the
fixtures on the CPU and never opens the accelerator; only the pipeline
children do, one at a time.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "benchmarks"))

MODES = ["bp", "cc", "mf"]


def run_pipeline(size: int, workdir: Path, outdir: Path, threads: int):
    """One full pipeline run (search → align → predict → results.tsv)."""
    from e2e_benchmark import build_queries, build_structure_db, build_weights

    from metagenomic_deepfri_tpu import profiling
    from metagenomic_deepfri_tpu.pipeline import (
        hierarchical_database_search, load_query_file,
        predict_protein_function)
    from metagenomic_deepfri_tpu.utils import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    rng = np.random.default_rng(7)
    weights = workdir / "weights"
    structures = workdir / "structures"
    build_weights(weights)
    db_seqs = build_structure_db(structures, rng)
    qpath = workdir / f"queries_{size}.faa"
    if not qpath.exists():
        build_queries(qpath, np.random.default_rng(size), db_seqs, size)

    profiling.reset()
    t0 = time.perf_counter()
    qf = load_query_file(qpath)
    dbs = hierarchical_database_search(
        query_file=qf, output_path=outdir / "database_search",
        databases=[structures], skip_pdb=True, max_eval=1e-3,
        threads=threads)
    qf2 = load_query_file(qpath)
    predict_protein_function(
        query_file=qf2, databases=tuple(dbs), weights=weights,
        output_path=outdir, deepfri_processing_modes=list(MODES),
        skip_matrix=True, threads=threads)
    total = time.perf_counter() - t0
    rep = profiling.report()

    def phase(prefix):
        return round(sum(v["seconds"] for k, v in rep.items()
                         if k.startswith(prefix)), 2)

    gcn = rep.get("inference/gcn", {})
    return {
        "total_s": round(total, 2),
        "search_s": phase("search/"), "align_s": phase("align/"),
        "coords_s": phase("coords/"), "cmap_s": phase("cmap/"),
        "gcn_s": phase("inference/gcn"), "cnn_s": phase("inference/cnn"),
        "write_s": phase("write/"),
        "gcn_items": gcn.get("items", 0),
        "gcn_pps": gcn.get("items_per_sec") or 0.0,
    }


def _spawn(size, workdir, outdir, threads, env):
    cmd = [sys.executable, __file__, "--single-run", "--size", str(size),
           "--workdir", str(workdir), "--outdir", str(outdir),
           "--threads", str(threads)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True, env=env)


def _read_rows(path: Path):
    with open(path, encoding="utf-8") as f:
        header = f.readline()
        rows = sorted(f.read().splitlines())
    return header, rows


def _count_ckpt_rows(outdir: Path) -> int:
    ckpt = outdir / "checkpoints"
    if not ckpt.exists():
        return 0
    return sum(1 for p in ckpt.rglob("*") if p.is_file())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=100000)
    ap.add_argument("--workdir", default=str(
        Path(tempfile.gettempdir()) / "mdeepfri_catalog_bench"))
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--kill-progress-files", type=int, default=6,
                    help="kill -9 once the checkpoint dir holds this many "
                         "files (real mid-stream progress)")
    ap.add_argument("--out", default=str(REPO / "BENCH_CATALOG.json"))
    ap.add_argument("--single-run", action="store_true")
    ap.add_argument("--outdir", default=None)
    args = ap.parse_args()

    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)

    if args.single_run:
        row = run_pipeline(args.size, workdir, Path(args.outdir),
                           args.threads)
        print(json.dumps(row), flush=True)
        return

    # Only the pipeline children may open the accelerator: a JAX process
    # reserves most of the card's memory when it first uses it, so the
    # parent stays on the CPU while it builds the fixtures.
    child_env = dict(os.environ)
    os.environ["JAX_PLATFORMS"] = "cpu"

    # one-time fixture build so the timed child pays none of it
    from e2e_benchmark import build_queries, build_structure_db, build_weights
    rng = np.random.default_rng(7)
    build_weights(workdir / "weights")
    db_seqs = build_structure_db(workdir / "structures", rng)
    qpath = workdir / f"queries_{args.size}.faa"
    if not qpath.exists():
        build_queries(qpath, np.random.default_rng(args.size), db_seqs,
                      args.size)

    # --- run 1: uninterrupted ------------------------------------------------
    out_a = workdir / "out_uninterrupted"
    print(f"== uninterrupted {args.size} ==", flush=True)
    proc = _spawn(args.size, workdir, out_a, args.threads, child_env)
    stdout, _ = proc.communicate()
    if proc.returncode != 0:
        sys.stderr.write(stdout[-4000:])
        raise SystemExit("uninterrupted run failed")
    run_a = json.loads([ln for ln in stdout.splitlines()
                        if ln.startswith("{")][-1])
    print(json.dumps(run_a), flush=True)

    # --- run 2: killed mid-stream, then resumed ------------------------------
    out_b = workdir / "out_killed"
    print("== killed mid-stream ==", flush=True)
    proc = _spawn(args.size, workdir, out_b, args.threads, child_env)
    t0 = time.perf_counter()
    killed_at = None
    while proc.poll() is None:
        n = _count_ckpt_rows(out_b)
        if n >= args.kill_progress_files:
            killed_at = time.perf_counter() - t0
            os.killpg(proc.pid, signal.SIGKILL)  # exact pgid, never pattern
            break
        if time.perf_counter() - t0 > 3600:
            os.killpg(proc.pid, signal.SIGKILL)
            raise SystemExit("no checkpoint progress within an hour")
        time.sleep(2.0)
    proc.wait()
    if killed_at is None:
        raise SystemExit("run finished before the kill fired — lower "
                         "--kill-progress-files so mid-stream progress "
                         "triggers it earlier")
    ckpt_files_at_kill = _count_ckpt_rows(out_b)
    print(f"killed -9 at {killed_at:.1f}s with {ckpt_files_at_kill} "
          "checkpoint file(s)", flush=True)

    print("== resumed ==", flush=True)
    proc = _spawn(args.size, workdir, out_b, args.threads, child_env)
    stdout, _ = proc.communicate()
    if proc.returncode != 0:
        sys.stderr.write(stdout[-4000:])
        raise SystemExit("resumed run failed")
    run_b = json.loads([ln for ln in stdout.splitlines()
                        if ln.startswith("{")][-1])
    print(json.dumps(run_b), flush=True)

    # --- row-level equality --------------------------------------------------
    hdr_a, rows_a = _read_rows(out_a / "results.tsv")
    hdr_b, rows_b = _read_rows(out_b / "results.tsv")
    assert hdr_a == hdr_b, "results.tsv headers differ"
    equal = rows_a == rows_b
    if not equal:
        only_a = set(rows_a) - set(rows_b)
        only_b = set(rows_b) - set(rows_a)
        print(f"MISMATCH: {len(only_a)} rows only in uninterrupted, "
              f"{len(only_b)} only in resumed", flush=True)
        for r in list(only_a)[:5]:
            print("A:", r)
        for r in list(only_b)[:5]:
            print("B:", r)
    per_run = [dict(run, run=name) for name, run in
               (("uninterrupted", run_a), ("killed+resumed", run_b))]

    pps = args.size / run_a["total_s"]
    chip_hours_1m = 1_000_000 / pps / 3600.0
    payload = {
        "description": f"{args.size}-query catalogue annotation "
                       "(full-size models, streaming engine + checkpoint, "
                       "--skip-matrix), with a kill -9 mid-stream and a "
                       "checkpoint resume; row-level results equality "
                       "asserted against the uninterrupted run.",
        "command": "python benchmarks/catalog_benchmark.py "
                   f"--size {args.size}",
        "runs": per_run,
        "kill": {"killed_at_s": round(killed_at, 1),
                 "checkpoint_files_at_kill": ckpt_files_at_kill},
        "resume_rows_equal": equal,
        "result_rows": len(rows_a),
        "measured_catalogue_pps": round(pps, 1),
        "projection_1m_catalogue_chip_hours": round(chip_hours_1m, 2),
        "projection_note": "1M-protein device-hours from the measured "
                           "uninterrupted wall clock",
    }
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps({"metric": "catalogue_pps", "value": round(pps, 1),
                      "unit": "proteins/s",
                      "resume_rows_equal": equal,
                      "chip_hours_1m": round(chip_hours_1m, 2)}))
    if not equal:
        raise SystemExit("resumed results differ from uninterrupted run")


if __name__ == "__main__":
    main()
