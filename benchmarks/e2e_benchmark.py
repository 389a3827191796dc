#!/usr/bin/env python
"""Scripted end-to-end pipeline benchmark.

Mirrors the reference's published per-size tables
(``/root/reference/benchmark/README.md:20-66``,
``benchmark_results.tsv``: 10/100/1000/10000 sequences with per-phase
Search/Inference timings) as ONE reproducible command:

    python benchmarks/e2e_benchmark.py [--sizes 10,100,1000,10000]
        [--workdir DIR] [--out FILE] [--threads N]

It synthesises a fixed structure-directory database (500 random-walk
backbones written as .pdb files) and per-size query sets (70% point-mutated
copies of database entries → structure hits → GCN; 30% novel sequences →
CNN fallback), then drives the REAL pipeline — `load_query_file` →
`hierarchical_database_search` → `predict_protein_function` with synthetic
ONNX weights imported through the production ONNX path — and reports the
per-phase wall-clock from :mod:`metagenomic_deepfri_tpu.profiling`:

    n_seqs  total_s  search_s  align_s  coords_s  cmap_s  gcn_s  cnn_s
    write_s  other_s  gcn_pps

The database build and weights export are done once per workdir and cached,
so the timed region is exactly the reference's benchmarked surface (their
DB also pre-exists when the table is produced). The parent process builds
those fixtures on the CPU and never opens the accelerator: each size runs
in a child process that has the card to itself.
"""

import argparse
import csv
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

MODES = ["bp", "cc", "mf"]
AAS = list("ACDEFGHIKLMNPQRSTVWY")
DB_SIZE = 500
HIT_FRACTION = 0.7
MUTATION_RATE = 0.1


def _rand_seq(rng, n):
    return "".join(rng.choice(AAS, size=n))


def _walk(rng, n):
    steps = rng.normal(size=(n, 3)).astype(np.float32)
    steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
    return np.cumsum(3.8 * steps, axis=0).astype(np.float32)


def _mutate(rng, seq, rate):
    out = list(seq)
    for pos in rng.choice(len(seq), size=int(rate * len(seq)),
                          replace=False):
        out[pos] = rng.choice(AAS)
    return "".join(out)


def _calibrate_head(params, n_labels: int, rng):
    """Give a random-weight model a realistic sparse score profile.

    Untouched random heads emit per-term scores clustered near 0.5, so
    ~half of all GO terms clear the 0.1 results threshold — thousands of
    results.tsv rows per protein, nothing like a calibrated model. Scaling
    the head kernel down and biasing class 1 pushes the baseline score to
    ~e^-6 while ~1% of terms (random subset, varying with the input through
    the scaled kernel) stay confidently high — the shape real DeepFRI
    weights produce.
    """
    import numpy as _np

    kernel = _np.asarray(params["head"]["kernel"])
    params["head"]["kernel"] = kernel * 1e-4
    bias = _np.zeros(2 * n_labels, _np.float32)
    bias[1::2] = 6.0
    positives = rng.choice(n_labels, size=max(4, n_labels // 100),
                           replace=False)
    for t in positives:
        bias[2 * t] = 6.0
        bias[2 * t + 1] = 0.0
    params["head"]["bias"] = bias


def build_weights(weights_dir: Path):
    """Synthetic DeepFRI weight set exported to ONNX and loaded back through
    the production import path (real vocabulary sizes per mode).

    Runs entirely on the CPU backend: this is a one-time export of random
    weights (device-irrelevant), made of many small eager init ops.
    """
    import jax

    from metagenomic_deepfri_tpu.models.deepfri import (CNNConfig, GCNConfig,
                                                        init_cnn, init_gcn)
    from metagenomic_deepfri_tpu.models.onnx_import import (export_cnn_to_onnx,
                                                            export_gcn_to_onnx)
    from metagenomic_deepfri_tpu.utils import generate_config_json

    if (weights_dir / "model_config.json").exists():
        return
    weights_dir.mkdir(parents=True, exist_ok=True)
    with jax.default_device(jax.devices("cpu")[0]):
        _build_weights_body(weights_dir)
    generate_config_json(weights_dir, "1.1")  # v1.1: no EC mode


def _build_weights_body(weights_dir: Path):
    import jax

    from metagenomic_deepfri_tpu.models.deepfri import (CNNConfig, GCNConfig,
                                                        init_cnn, init_gcn)
    from metagenomic_deepfri_tpu.models.onnx_import import (export_cnn_to_onnx,
                                                            export_gcn_to_onnx)
    # real per-mode vocabulary sizes (reference *_model_params.json)
    n_labels = {"bp": 3992, "cc": 320, "mf": 489}
    key = jax.random.PRNGKey(0)
    shared_trunk = None  # the published models share one frozen LSTM-LM
    for mode in MODES:
        k1, k2, key = jax.random.split(key, 3)
        # FULL-SIZE architecture — the library defaults, matching the
        # published `DeepFRI-…gcd_512-512-512_fcd_1024` models (reference
        # __init__.py:70-80): lm 512×2, embed 1024, gc 512³, fc 1024.
        # The table must be measured at real model scale.
        gcn_cfg = GCNConfig(n_labels=n_labels[mode])
        cnn_cfg = CNNConfig(n_labels=n_labels[mode])
        gcn_name = (f"DeepFRI-MERGED_GraphConv_gcd_512-512-512_fcd_1024_"
                    f"ca_10.0_{mode}.onnx")
        cnn_name = f"DeepCNN-MERGED_{mode}.onnx"
        gcn_params = init_gcn(k1, gcn_cfg)
        # Mirror the published weight sets: one pretrained LM is baked into
        # every mode's MERGED export, so the engine's shared-trunk
        # detection fires exactly as it does on real weights.
        if shared_trunk is None:
            shared_trunk = {k: gcn_params[k]
                            for k in ("lm", "lm_embed", "aa_embed")}
        else:
            gcn_params.update(shared_trunk)
        _calibrate_head(gcn_params, n_labels[mode],
                        np.random.default_rng(zlib.crc32(mode.encode())))
        export_gcn_to_onnx(gcn_params, gcn_cfg,
                           str(weights_dir / gcn_name))
        cnn_params = init_cnn(k2, cnn_cfg)
        _calibrate_head(cnn_params, n_labels[mode],
                        np.random.default_rng(
                            zlib.crc32(("c" + mode).encode())))
        export_cnn_to_onnx(cnn_params, cnn_cfg,
                           str(weights_dir / cnn_name))
        terms = [f"GO:{i:07d}" for i in range(n_labels[mode])]
        names = [f"term {i}" for i in range(n_labels[mode])]
        for name in (gcn_name, cnn_name):
            with open(weights_dir / (name[:-5] + "_model_params.json"),
                      "w", encoding="utf-8") as f:
                json.dump({"goterms": terms, "gonames": names}, f)


def build_structure_db(db_dir: Path, rng) -> dict:
    """500 synthetic structures as on-disk .pdb files; returns id→seq."""
    from metagenomic_deepfri_tpu.data.structures import write_ca_pdb

    manifest = db_dir / "manifest.json"
    if manifest.exists():
        with open(manifest, "r", encoding="utf-8") as f:
            return json.load(f)
    db_dir.mkdir(parents=True, exist_ok=True)
    seqs = {}
    for i in range(DB_SIZE):
        sid = f"db_{i:04d}"
        seqs[sid] = _rand_seq(rng, int(rng.integers(60, 450)))
        write_ca_pdb(db_dir / f"{sid}.pdb", seqs[sid],
                     _walk(rng, len(seqs[sid])))
    with open(manifest, "w", encoding="utf-8") as f:
        json.dump(seqs, f)
    return seqs


def build_queries(path: Path, rng, db_seqs: dict, n: int):
    from metagenomic_deepfri_tpu.data.fasta import write_fasta

    ids = list(db_seqs)
    queries = {}
    n_hits = int(n * HIT_FRACTION)
    for i in range(n):
        if i < n_hits:
            src = db_seqs[ids[int(rng.integers(len(ids)))]]
            queries[f"q{i:05d}"] = _mutate(rng, src, MUTATION_RATE)
        else:
            queries[f"q{i:05d}"] = _rand_seq(rng, int(rng.integers(60, 450)))
    write_fasta(path, queries)
    return queries


def run_one(size: int, workdir: Path, threads: int,
            skip_matrix: bool = False) -> dict:
    from metagenomic_deepfri_tpu import profiling
    from metagenomic_deepfri_tpu.pipeline import (
        hierarchical_database_search, load_query_file,
        predict_protein_function)

    rng = np.random.default_rng(7)
    weights = workdir / "weights"
    structures = workdir / "structures"
    build_weights(weights)
    db_seqs = build_structure_db(structures, rng)
    qpath = workdir / f"queries_{size}.faa"
    build_queries(qpath, np.random.default_rng(size), db_seqs, size)

    out = workdir / f"out_{size}"
    profiling.reset()
    t0 = time.perf_counter()
    qf = load_query_file(qpath)
    dbs = hierarchical_database_search(
        query_file=qf, output_path=out / "database_search",
        databases=[structures], skip_pdb=True, max_eval=1e-3,
        threads=threads)
    qf2 = load_query_file(qpath)  # reference reloads between phases
    predict_protein_function(
        query_file=qf2, databases=tuple(dbs), weights=weights,
        output_path=out, deepfri_processing_modes=list(MODES),
        skip_matrix=skip_matrix, threads=threads)
    total = time.perf_counter() - t0

    rep = profiling.report()

    def phase(prefix):
        return round(sum(v["seconds"] for k, v in rep.items()
                         if k.startswith(prefix)), 2)

    gcn = rep.get("inference/gcn", {})
    row = {
        "n_seqs": size,
        "total_s": round(total, 2),
        "search_s": phase("search/"),
        "align_s": phase("align/"),
        "coords_s": phase("coords/"),
        "cmap_s": phase("cmap/"),
        "gcn_s": phase("inference/gcn"),
        "cnn_s": phase("inference/cnn"),
        "write_s": phase("write/"),
    }
    row["other_s"] = round(total - sum(v for k, v in row.items()
                                       if k.endswith("_s")
                                       and k != "total_s"), 2)
    row["gcn_pps"] = gcn.get("items_per_sec") or 0.0
    n_results = sum(1 for _ in open(out / "results.tsv",
                                    encoding="utf-8")) - 1
    assert n_results > 0, "pipeline produced an empty results.tsv"
    row["result_rows"] = n_results
    return row


MODEL_CONFIG_NOTE = ("gcn: lm 512x2 + embed 1024 + gc 512-512-512 + fc 1024"
                     " (library defaults, = published gcd_512-512-512_fcd_"
                     "1024); cnn: 512 filters k8+k16, fc 1024; vocab "
                     "bp 3992 / cc 320 / mf 489")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="10,100,1000,10000")
    ap.add_argument("--workdir", default=str(
        Path(tempfile.gettempdir()) / "mdeepfri_e2e_bench_full"))
    ap.add_argument("--out", default=None,
                    help="results table (default: <workdir>/e2e_results.tsv)")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--skip-matrix", action="store_true",
                    help="skip prediction-matrix TSVs; enables the engine's "
                         "top-k score fetch (results.tsv is unchanged)")
    ap.add_argument("--single", type=int, default=None,
                    help="(internal) run ONE size in this process and print "
                         "its row as JSON")
    ap.add_argument("--same-process", action="store_true",
                    help="run all sizes in this one process (shares warm "
                         "compiled programs across rows — NOT the published "
                         "protocol; rows are labelled warm_process)")
    args = ap.parse_args()

    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    out_path = Path(args.out) if args.out else workdir / "e2e_results.tsv"
    child_env = dict(os.environ)
    if args.single is None and not args.same_process:
        # Only the per-size children may open the accelerator: a JAX
        # process reserves most of the card's memory when it first uses
        # it, so a parent holding it would starve every child.
        os.environ["JAX_PLATFORMS"] = "cpu"

    from metagenomic_deepfri_tpu.utils import enable_persistent_compile_cache
    enable_persistent_compile_cache()

    if args.single is not None:
        row = run_one(args.single, workdir, args.threads,
                      skip_matrix=args.skip_matrix)
        print(json.dumps(row), flush=True)
        return

    sizes = [int(s) for s in args.sizes.split(",")]
    # One-time fixture build (DB + weights pre-exist when the reference's
    # table is produced too) so the first timed row doesn't pay it.
    build_weights(workdir / "weights")
    build_structure_db(workdir / "structures", np.random.default_rng(7))

    rows = []
    for size in sizes:
        print(f"== {size} sequences ==", flush=True)
        if args.same_process:
            row = run_one(size, workdir, args.threads,
                          skip_matrix=args.skip_matrix)
            row["protocol"] = "warm_process"
        else:
            # Each size in a FRESH process — per-run wall clocks like the
            # reference's published table (no warm compiled programs or
            # device state carried across rows).
            cmd = [sys.executable, __file__, "--single", str(size),
                   "--workdir", str(workdir), "--threads",
                   str(args.threads)]
            if args.skip_matrix:
                cmd.append("--skip-matrix")
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  env=child_env)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-4000:])
                raise SystemExit(f"size {size} failed")
            line = [ln for ln in proc.stdout.splitlines()
                    if ln.strip().startswith("{")][-1]
            row = json.loads(line)
            row["protocol"] = "fresh_process"
        print(json.dumps(row), flush=True)
        rows.append(row)

    cols = list(rows[0].keys())
    with open(out_path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(cols)
        for row in rows:
            w.writerow([row[c] for c in cols])
    with open(out_path.with_suffix(".meta.json"), "w",
              encoding="utf-8") as f:
        json.dump({"model_config": MODEL_CONFIG_NOTE,
                   "protocol": rows[-1]["protocol"],
                   "threads": args.threads,
                   "skip_matrix": bool(args.skip_matrix),
                   "db_size": DB_SIZE, "hit_fraction": HIT_FRACTION},
                  f, indent=1)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
