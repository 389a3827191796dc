#!/usr/bin/env python
"""GPU smoke test: the annotation pipeline end to end, at published widths.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py          # phases 1-4 on exactly one GPU
    python chip_smoke.py --four   # phase 5 only, on exactly four GPUs

All weights and data are synthetic and made from a seed: full-width DeepFRI
GCN/CNN models (LSTM-LM 512x2, embed 1024, GraphConv 512-512-512, FC 1024;
bp 3992 / cc 320 / mf 489 labels) exported to ONNX and imported through the
production path, a 500-entry database of CA-only PDB files, and 1000 queries
(about 70% structure hits, 16 of them 1025-2000 residues long, the rest
no-hit queries that fall back to the CNN).

Phases, one JSON line each:

1. device — platform, device kind and count from JAX; the card's name and
   power limit from nvidia-smi; the compile-cache directory in effect.
2. pipeline — device memory at the default batch rule for buckets 512 and
   2048; ``predict-function`` through ``cli.main`` cold, warm, and with
   ``--skip-matrix`` (whose results.tsv must be identical).
3. parity — ``verify-weights`` on all six models; the pipeline's score
   matrices against the numpy ``OnnxExecutor`` fed the host-built aligned
   contact map; bf16 engine batches at buckets 512 and 2048 against the
   same reference; the wire formats round-tripped on the device.
4. server — ``AnnotationServer`` over its Unix socket, scores against the
   pipeline's.
5. ``--four`` — ``predict-function`` data-parallel over four GPUs against a
   single-device engine on the same inputs.

The last line is ``{"ok": true, "device": {...}}``. Any failed check raises,
so the script exits non-zero and never prints that line; it also exits
non-zero, before any work, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "benchmarks"))

MODES = ["bp", "cc", "mf"]
SEED = 7
DB_SIZE = 500
N_LONG = 16            # hits of LONG_LEN residues: bucket 2048 runs
LONG_LEN = (1025, 2001)
N_QUERIES = 1000
HIT_FRACTION = 0.7
THREADS = 8
F32_TOL = 1e-4         # parity.DEFAULT_TOLERANCE
SERVER_TOL = 1e-5
# The server protocol rounds scores to 4 decimals.
SERVER_ROUNDING = 5e-5
# bf16 keeps 8 significant bits (relative rounding 2^-9 ≈ 2e-3) in every
# matmul operand; the GraphConv sums run over up to L neighbours and the
# pooled features over L residues, so logits carry a relative error of a
# few 1e-3, and a score's error is at most a quarter of its logit's
# (d sigmoid <= 1/4). Checked against the f32 reference on the same batches.
BF16_TOL = 2e-2
PARITY_PICKS = 32      # GCN-hit and CNN queries compared per mode
REQUEST_SIZES = (1, 16)  # proteins per server request, alternating

_t0 = time.perf_counter()
_LOG_PATH: Path | None = None


def check(ok, what) -> None:
    """Fail the run unless ``ok``; ``what`` says what was checked."""
    if not ok:
        raise AssertionError(what)


def note(msg: str) -> None:
    """Progress to stderr (stdout carries the phase records)."""
    print(f"[{time.perf_counter() - _t0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def _log_to_file() -> None:
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s %(levelname)-7s %(name)s :: "
                               "%(message)s",
                        handlers=[logging.FileHandler(_LOG_PATH)])


def run_cli(argv) -> None:
    """``cli.main(argv)`` in this process, its log kept in the log file."""
    from metagenomic_deepfri_tpu import cli

    try:
        with open(_LOG_PATH, "a", encoding="utf-8") as f, \
                contextlib.redirect_stdout(f):
            rc = cli.main(argv)
    finally:
        _log_to_file()  # cli.main points logging at stdout
    if rc:
        raise RuntimeError(f"cli {argv[0]} returned {rc}")


# ---------------------------------------------------------------------------
# Phase 1: device
# ---------------------------------------------------------------------------

def device_phase(expected_count: int) -> dict:
    import jax

    from metagenomic_deepfri_tpu.utils import enable_persistent_compile_cache

    cache_dir = enable_persistent_compile_cache()
    devices = jax.devices()
    d = devices[0]
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (platform "
                         f"{d.platform!r}); nothing was run")
    if len(devices) != expected_count:
        raise SystemExit(f"chip_smoke: expected {expected_count} GPU(s), "
                         f"JAX sees {len(devices)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    device = {"platform": d.platform, "kind": d.device_kind,
              "count": len(devices)}
    emit("device", **device, nvidia_smi=smi.splitlines(),
         compile_cache_dir=cache_dir,
         jax_compilation_cache_dir=jax.config.jax_compilation_cache_dir,
         jax_version=jax.__version__)
    return device


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

def build_fixtures(work: Path, n_queries: int, db_size: int, n_long: int):
    """Weights, structure DB and query FASTA; returns (weights, structures,
    queries path, {qid: seq})."""
    from e2e_benchmark import (MUTATION_RATE, _mutate, _rand_seq, _walk,
                               build_weights)

    from metagenomic_deepfri_tpu.data.fasta import write_fasta
    from metagenomic_deepfri_tpu.data.structures import write_ca_pdb

    weights = work / "weights"
    build_weights(weights)
    rng = np.random.default_rng(SEED)
    structures = work / "structures"
    structures.mkdir(parents=True, exist_ok=True)
    db = {}
    for i in range(db_size):
        lo, hi = LONG_LEN if i < n_long else (60, 451)
        sid = f"db_{i:04d}"
        db[sid] = _rand_seq(rng, int(rng.integers(lo, hi)))
        write_ca_pdb(structures / f"{sid}.pdb", db[sid],
                     _walk(rng, len(db[sid])))
    ids = list(db)
    queries = {}
    n_hits = int(n_queries * HIT_FRACTION)
    for i in range(n_queries):
        if i < n_long:
            src = db[ids[i]]
        elif i < n_hits:
            src = db[ids[int(rng.integers(n_long, len(ids)))]]
        else:
            queries[f"q{i:05d}"] = _rand_seq(rng, int(rng.integers(60, 451)))
            continue
        queries[f"q{i:05d}"] = _mutate(rng, src, MUTATION_RATE)
    qpath = work / "queries.faa"
    write_fasta(qpath, queries)
    return weights, structures, qpath, queries


def read_matrices(out: Path) -> dict:
    """{mode: {qid: (network, float32 scores)}} from prediction_matrix TSVs."""
    mats = {}
    for mode in MODES:
        rows = {}
        for path in sorted(out.glob(f"prediction_matrix_{mode}*.tsv")):
            with open(path, encoding="utf-8") as f:
                next(f)
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    rows[parts[0]] = (parts[1],
                                      np.asarray(parts[2:], np.float32))
        mats[mode] = rows
    return mats


def read_alignment_summary(out: Path) -> dict:
    """{qid: target_id or None}."""
    with open(out / "alignment_summary.tsv", encoding="utf-8") as f:
        next(f)
        return {p[0]: (p[2] if p[1] == "True" else None)
                for p in (ln.rstrip("\n").split("\t") for ln in f)}


def pipeline_alignments(out: Path, structures: Path, qids) -> dict:
    """The pipeline's own alignments for ``qids``, with target coordinates:
    the same search table, aligner and coordinate extraction it ran."""
    from metagenomic_deepfri_tpu.align.pairwise import align_mmseqs_results
    from metagenomic_deepfri_tpu.search.database import build_database
    from metagenomic_deepfri_tpu.search.pdb import extract_calpha_coords

    db = build_database(input_path=structures, output_path=structures.parent,
                        threads=THREADS)
    alns = align_mmseqs_results(
        best_matches_filepath=out / "database_search"
        / f"{db.name}_results.tsv",
        sequence_db=db.sequence_db, threads=THREADS)
    wanted = set(qids)
    by_q = {a.query_name: a for a in alns if a.query_name in wanted}
    picked = list(by_q.values())
    coords = extract_calpha_coords(
        db, [a.target_name.rsplit(".", 1)[0] for a in picked],
        [a.query_name for a in picked], threads=THREADS)
    for a, c in zip(picked, coords):
        a.coords = c
    return by_q


def projections(alns: dict) -> list:
    """Engine items (qid, seq, proj_coords, ins_mask) for alignments."""
    from metagenomic_deepfri_tpu.bio_utils import build_align_projection

    items = []
    for qid, aln in alns.items():
        _, proj = build_align_projection(aln)
        if proj is None:
            raise AssertionError(f"projection failed for {qid}")
        items.append((qid, aln.query_sequence, proj[0], proj[1]))
    return items


# ---------------------------------------------------------------------------
# Phase 2: pipeline through the CLI
# ---------------------------------------------------------------------------

def bucket_memory(weights: Path) -> dict:
    """Device memory of the default-rule 3-mode GCN batch at buckets 2048
    and 512 (in that order: the process peak only grows)."""
    import jax

    from metagenomic_deepfri_tpu.batching.buckets import gcn_batch_size
    from metagenomic_deepfri_tpu.batching.engine import BatchedPredictor
    from metagenomic_deepfri_tpu.models.registry import load_models

    gcn, _, _ = load_models(weights, MODES)
    engine = BatchedPredictor(gcn_models=gcn)
    out = {}
    for bucket in (2048, 512):
        t = time.perf_counter()
        engine.warmup(nets=("gcn_coords",), buckets=(bucket,),
                      background=False)
        stats = jax.devices()[0].memory_stats() or {}
        out[str(bucket)] = {
            "batch": gcn_batch_size(bucket),
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "bytes_limit": stats.get("bytes_limit"),
            "compile_and_run_s": time.perf_counter() - t}
    del engine, gcn
    return out


def pipeline_phase(work: Path, weights: Path, structures: Path,
                   qpath: Path) -> dict:
    import jax

    from metagenomic_deepfri_tpu import profiling

    memory = bucket_memory(weights)
    note(f"bucket memory {memory}")
    runs = {}
    for name, extra in (("cold", []), ("warm", []),
                        ("skip_matrix", ["--skip-matrix"])):
        out = work / f"out_{name}"
        profiling.reset()
        t = time.perf_counter()
        run_cli(["predict-function", "-i", str(qpath), "-o", str(out),
                 "-d", str(structures), "-w", str(weights), "--skip-pdb",
                 "-t", str(THREADS), *extra])
        wall = time.perf_counter() - t
        stages = {k: v["seconds"] for k, v in profiling.report().items()}
        runs[name] = {"wall_s": wall, "stages_s": stages,
                      "peak_bytes_in_use": (jax.devices()[0].memory_stats()
                                            or {}).get("peak_bytes_in_use")}
        note(f"pipeline {name}: {wall:.1f}s")
    results = {n: (work / f"out_{n}" / "results.tsv").read_bytes()
               for n in runs}
    rows = results["cold"].count(b"\n") - 1
    check(rows > 0, "empty results.tsv")
    check(results["skip_matrix"] == results["cold"],
          "--skip-matrix results.tsv differs from the dense run")
    summary = read_alignment_summary(work / "out_cold")
    n_gcn = sum(1 for t in summary.values() if t)
    emit("pipeline", bucket_memory=memory, runs=runs, result_rows=rows,
         gcn_queries=n_gcn, cnn_queries=len(summary) - n_gcn,
         skip_matrix_results_identical=True,
         warm_results_identical=results["warm"] == results["cold"])
    return summary


# ---------------------------------------------------------------------------
# Phase 3: parity with the numpy ONNX executor
# ---------------------------------------------------------------------------

class Reference:
    """The numpy ``OnnxExecutor`` per (net, mode): shares no code with the
    JAX path. GCN inputs are host-built aligned contact maps."""

    def __init__(self, weights: Path):
        from metagenomic_deepfri_tpu.models.onnx_import import (
            OnnxExecutor, graph_input_roles)
        from metagenomic_deepfri_tpu.models.onnx_reader import load_onnx
        from metagenomic_deepfri_tpu.utils import load_deepfri_config

        config = load_deepfri_config(weights)
        self.models = {}
        for net in ("gcn", "cnn"):
            for mode in MODES:
                graph = load_onnx(config[net][mode])
                self.models[net, mode] = (OnnxExecutor(graph),
                                          graph_input_roles(graph))

    def gcn(self, mode, aln) -> np.ndarray:
        from metagenomic_deepfri_tpu.bio_utils import build_align_contact_map
        from metagenomic_deepfri_tpu.ops.one_hot import seq2onehot

        _, cmap = build_align_contact_map(aln, threshold=6.0,
                                          generated_contacts=2)
        ex, roles = self.models["gcn", mode]
        (out,) = ex.run({roles["A"]: cmap[None].astype(np.float32),
                         roles["S"]: seq2onehot(aln.query_sequence)[None]})
        return out[0, :, 0]

    def cnn(self, mode, seq) -> np.ndarray:
        from metagenomic_deepfri_tpu.ops.one_hot import seq2onehot

        ex, roles = self.models["cnn", mode]
        (out,) = ex.run({roles["S"]: seq2onehot(seq)[None]})
        return out[0, :, 0]


def _max_diff(pairs) -> float:
    return max(float(np.max(np.abs(np.asarray(a, np.float64)
                                   - np.asarray(b, np.float64))))
               for a, b in pairs)


def device_adjacency_check(alns: dict) -> dict:
    """The adjacency the engine builds on the device from projected
    coordinates must equal the host-built aligned contact map (the
    reference's O(L²) scatter) entry for entry."""
    import jax

    from metagenomic_deepfri_tpu.batching.engine import _pad_batch_coords
    from metagenomic_deepfri_tpu.bio_utils import build_align_contact_map
    from metagenomic_deepfri_tpu.ops.cmap_align import \
        aligned_contacts_from_coords

    items = projections(alns)
    bucket = max(len(it[1]) for it in items)
    tokens, lengths, coords, ins = _pad_batch_coords(items, bucket,
                                                     len(items))
    adj = np.asarray(jax.jit(aligned_contacts_from_coords)(coords, ins,
                                                           lengths))
    bad = 0
    for i, (qid, seq, _, _) in enumerate(items):
        _, cmap = build_align_contact_map(alns[qid], threshold=6.0,
                                          generated_contacts=2)
        L = len(seq)
        bad += int((adj[i, :L, :L] != cmap).sum())
        bad += int(adj[i, L:].sum() + adj[i, :, L:].sum())
    return {"proteins": len(items), "mismatched_entries": bad}


def wire_roundtrip(items) -> dict:
    """Flat and fixed-record wire buffers unpacked on the device must give
    back the packed coordinates bit for bit."""
    import jax

    from metagenomic_deepfri_tpu.batching.engine import (_flat_capacity,
                                                         _pack_coords_flat,
                                                         _pack_coords_mega,
                                                         _unpack_coords_flat,
                                                         _unpack_coords_mega)
    from metagenomic_deepfri_tpu.ops.one_hot import seq2tokens

    bucket = max(512, max(len(it[1]) for it in items))
    batch = len(items)
    cap = _flat_capacity(sum(len(it[1]) for it in items), bucket, batch)
    flat = jax.jit(_unpack_coords_flat, static_argnames=("batch", "bucket"))(
        jax.device_put(_pack_coords_flat(items, batch, cap)),
        batch=batch, bucket=bucket)
    mega = jax.jit(_unpack_coords_mega)(
        jax.device_put(_pack_coords_mega(items, bucket, batch)))
    for name, (coords, tokens, ins, lengths) in (("flat", flat),
                                                 ("fixed", mega)):
        coords, tokens, ins, lengths = map(np.asarray,
                                           (coords, tokens, ins, lengths))
        for i, (qid, seq, proj, ins_mask) in enumerate(items):
            L = len(seq)
            check(lengths[i] == L, (name, qid))
            bits = np.asarray(proj, np.float32).view(np.uint32)
            check(np.array_equal(coords[i, :L].view(np.uint32), bits),
                  (name, qid))
            check(np.array_equal(tokens[i, :L], seq2tokens(seq)), (name, qid))
            check(np.array_equal(ins[i, :L], ins_mask), (name, qid))
    return {"proteins": len(items), "bucket": bucket, "bit_exact": True}


def parity_phase(work: Path, weights: Path, structures: Path, queries: dict,
                 summary: dict) -> dict:
    import dataclasses

    from metagenomic_deepfri_tpu.batching.engine import (BatchedPredictor,
                                                         ModelHandle)
    from metagenomic_deepfri_tpu.models.registry import load_models
    from metagenomic_deepfri_tpu.parity import DEFAULT_TOLERANCE
    from metagenomic_deepfri_tpu.parity import verify_weights

    check(DEFAULT_TOLERANCE == F32_TOL, "f32 tolerance is the parity default")
    t = time.perf_counter()
    vw = verify_weights(weights, n_proteins=2, max_len=1001, seed=SEED)
    verify = {f"{r.net}/{r.mode}": {"scores": r.max_abs_diff,
                                    "logits": r.max_logit_diff, "ok": r.ok}
              for r in vw}
    check(len(vw) == 6 and all(r.ok for r in vw), verify)
    note(f"verify-weights {time.perf_counter() - t:.1f}s")

    out = work / "out_cold"
    mats = read_matrices(out)
    gcn_q = sorted(q for q, tgt in summary.items() if tgt)
    cnn_q = sorted(q for q, tgt in summary.items() if not tgt)
    long_q = [q for q in gcn_q if len(queries[q]) >= LONG_LEN[0]]
    short_q = [q for q in gcn_q if len(queries[q]) < LONG_LEN[0]]
    check(long_q, "no long query was a structure hit")
    rng = np.random.default_rng(SEED)
    gcn_pick = long_q[:4] + list(rng.choice(short_q, PARITY_PICKS - 4,
                                            replace=False))
    cnn_pick = list(rng.choice(cnn_q, PARITY_PICKS, replace=False))
    b512 = [q for q in gcn_pick if 256 < len(queries[q]) <= 512]
    b2048 = [q for q in gcn_pick if q in long_q]
    check(b512, "no picked structure hit falls in bucket 512")
    alns = pipeline_alignments(out, structures, gcn_pick)
    adjacency = device_adjacency_check(alns)
    check(adjacency["mismatched_entries"] == 0, adjacency)
    ref = Reference(weights)

    def ref_gcn(args):
        mode, q = args
        return (mode, q), ref.gcn(mode, alns[q])

    def ref_cnn(args):
        mode, q = args
        return (mode, q), ref.cnn(mode, queries[q])

    t = time.perf_counter()
    with ThreadPoolExecutor(THREADS) as pool:
        r_gcn = dict(pool.map(ref_gcn, [(m, q) for m in MODES
                                        for q in gcn_pick]))
        r_cnn = dict(pool.map(ref_cnn, [(m, q) for m in MODES
                                        for q in cnn_pick]))
    note(f"reference executor {time.perf_counter() - t:.1f}s")
    pipe = {}
    for mode in MODES:
        for q in gcn_pick:
            net, row = mats[mode][q]
            check(net == "gcn", (mode, q, net))
            pipe[mode, q, "gcn"] = (row, r_gcn[mode, q])
        for q in cnn_pick:
            net, row = mats[mode][q]
            check(net == "cnn", (mode, q, net))
            pipe[mode, q, "cnn"] = (row, r_cnn[mode, q])
    pipe_gcn = _max_diff(v for k, v in pipe.items() if k[2] == "gcn")
    pipe_cnn = _max_diff(v for k, v in pipe.items() if k[2] == "cnn")
    check(pipe_gcn <= F32_TOL and pipe_cnn <= F32_TOL, (pipe_gcn, pipe_cnn))

    # bf16 engine batches at buckets 512 and 2048 vs the f32 reference
    gcn, _, _ = load_models(weights, MODES)
    bf16 = {m: ModelHandle(h.net_type, m,
                           dataclasses.replace(h.config,
                                               compute_dtype="bfloat16"),
                           h.params, h.goterms, h.gonames)
            for m, h in gcn.items()}
    engine = BatchedPredictor(gcn_models=bf16)
    check(engine.matmul_precision is None, "bf16 engine keeps XLA precision")
    bf16_diff = {}
    for bucket, qs in (("512", b512), ("2048", b2048)):
        items = projections({q: alns[q] for q in qs})
        got = engine.predict_gcn_from_coords(items)
        bf16_diff[bucket] = {
            "proteins": len(items),
            "max_abs_diff": _max_diff((got[m][q], r_gcn[m, q])
                                      for m in MODES for q in qs)}
    check(all(v["max_abs_diff"] <= BF16_TOL for v in bf16_diff.values()),
          bf16_diff)
    wire = wire_roundtrip(projections({q: alns[q] for q in b512}))
    emit("parity", verify_weights=verify, tolerance=F32_TOL,
         long_hits=len(long_q),
         device_adjacency=adjacency,
         pipeline_vs_executor={"gcn_max_abs_diff": pipe_gcn,
                               "cnn_max_abs_diff": pipe_cnn,
                               "gcn_queries": len(gcn_pick),
                               "long_gcn_queries": len(b2048),
                               "cnn_queries": len(cnn_pick)},
         bf16_vs_f32_reference=bf16_diff, bf16_tolerance=BF16_TOL,
         wire_roundtrip=wire)
    return mats


# ---------------------------------------------------------------------------
# Phase 4: server
# ---------------------------------------------------------------------------

def server_phase(work: Path, weights: Path, structures: Path,
                 queries: dict, summary: dict, mats: dict) -> None:
    import threading

    from metagenomic_deepfri_tpu.serving import (AnnotationServer,
                                                 annotate_over_socket)

    server = AnnotationServer(weights, databases=[structures],
                              max_eval=1e-3, threads=THREADS)
    sock = Path(tempfile.mkdtemp(prefix="mdf")) / "s"
    ready = threading.Event()
    thread = threading.Thread(target=server.serve_unix, args=(sock, ready),
                              daemon=True)
    thread.start()
    check(ready.wait(60), "server listening within 60 s")
    rng = np.random.default_rng(SEED + 1)
    hits = [q for q, tgt in summary.items() if tgt]
    misses = [q for q, tgt in summary.items() if not tgt]
    worst = 0.0
    n_proteins = 0
    latencies = []
    try:
        for r, size in enumerate(list(REQUEST_SIZES) * 4):
            pool = hits if r % 4 < 2 else misses
            qs = list(rng.choice(pool, size, replace=False))
            if size > 1:  # mix hits and no-hits within a request
                qs[: size // 2] = rng.choice(misses if pool is hits
                                             else hits, size // 2,
                                             replace=False)
            t = time.perf_counter()
            resp = annotate_over_socket(sock, {q: queries[q] for q in qs})
            latencies.append(time.perf_counter() - t)
            check("error" not in resp, resp)
            for q in qs:
                entry = resp["results"][q]
                want_net = "gcn" if summary[q] else "cnn"
                check(entry["network"] == want_net, (q, entry["network"]))
                if summary[q]:
                    check(entry["target"] == summary[q], (q, entry))
                for mode in MODES:
                    net, row = mats[mode][q]
                    got = {t: s for t, s, _ in entry["scores"].get(mode, [])}
                    for i in np.nonzero(row >= 0.1 + SERVER_TOL)[0]:
                        term = f"GO:{i:07d}"
                        check(term in got, (q, mode, term))
                    for term, s in got.items():
                        i = int(term[3:])
                        d = abs(s - float(row[i]))
                        worst = max(worst, d)
                        check(d <= SERVER_ROUNDING + SERVER_TOL,
                              (q, mode, term, s, float(row[i])))
                n_proteins += 1
    finally:
        server.shutdown()
        thread.join(30)
    emit("server", requests=len(latencies), proteins=n_proteins,
         latency_s=latencies,
         max_abs_diff_vs_pipeline=worst,
         tolerance=f"{SERVER_TOL} after the protocol's 4-decimal rounding")


# ---------------------------------------------------------------------------
# Phase 5: four GPUs
# ---------------------------------------------------------------------------

def four_phase(work: Path, weights: Path, structures: Path, qpath: Path,
               queries: dict) -> None:
    import jax

    from metagenomic_deepfri_tpu.batching.engine import BatchedPredictor
    from metagenomic_deepfri_tpu.models.registry import load_models

    out = work / "out_four"
    t = time.perf_counter()
    run_cli(["predict-function", "-i", str(qpath), "-o", str(out),
             "-d", str(structures), "-w", str(weights), "--skip-pdb",
             "-t", str(THREADS)])
    wall = time.perf_counter() - t
    with open(_LOG_PATH, encoding="utf-8") as f:
        check("Sharding inference over 4 devices" in f.read(),
              '"Sharding inference over 4 devices" in f.read()')
    mats = read_matrices(out)
    summary = read_alignment_summary(out)
    gcn_q = [q for q, tgt in summary.items() if tgt]
    cnn_q = [q for q, tgt in summary.items() if not tgt]
    items = projections(pipeline_alignments(out, structures, gcn_q))
    gcn, cnn, _ = load_models(weights, MODES)
    with jax.default_device(jax.devices()[0]):
        engine = BatchedPredictor(gcn_models=gcn, cnn_models=cnn)
        one_gcn = engine.predict_gcn_from_coords(items)
        one_cnn = engine.predict_cnn([(q, queries[q]) for q in cnn_q])
    diff = _max_diff([(mats[m][q][1], one_gcn[m][q])
                      for m in MODES for q in gcn_q]
                     + [(mats[m][q][1], one_cnn[m][q])
                        for m in MODES for q in cnn_q])
    check(diff <= SERVER_TOL, diff)
    emit("four", devices=len(jax.devices()), wall_s=wall,
         gcn_queries=len(gcn_q), cnn_queries=len(cnn_q),
         max_abs_diff_vs_single_device=diff, tolerance=SERVER_TOL)


def main(argv=None) -> int:
    global _LOG_PATH
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU data-parallel phase")
    args = ap.parse_args(argv)
    device = device_phase(4 if args.four else 1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        _LOG_PATH = work / "pipeline.log"
        _log_to_file()
        try:
            if args.four:
                weights, structures, qpath, queries = build_fixtures(
                    work, n_queries=200, db_size=DB_SIZE, n_long=4)
                four_phase(work, weights, structures, qpath, queries)
            else:
                weights, structures, qpath, queries = build_fixtures(
                    work, N_QUERIES, DB_SIZE, N_LONG)
                note("fixtures built")
                summary = pipeline_phase(work, weights, structures, qpath)
                mats = parity_phase(work, weights, structures, queries,
                                    summary)
                server_phase(work, weights, structures, queries, summary,
                             mats)
        except BaseException:
            with open(_LOG_PATH, encoding="utf-8") as f:
                tail = f.readlines()[-40:]
            sys.stderr.write("".join(tail))
            raise
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
