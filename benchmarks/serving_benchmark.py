#!/usr/bin/env python
"""Resident-server latency benchmark → BENCH_SERVING.json.

Measures what the serving design exists for: after a one-time startup
(models on device, databases indexed, engine warm), what does an
annotation request cost? Uses the same synthetic weights + 500-structure
database as the e2e benchmark (cached per workdir) and drives
``AnnotationServer.annotate`` in-process:

- cold first request (pays any residual compile/first-execution),
- warm single-protein requests (the interactive latency),
- warm 16-protein batch requests,
- 8 concurrent 4-protein requests (micro-batch coalescing),

reporting wall-clock percentiles over repeated warm requests.
"""

import argparse
import json
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from e2e_benchmark import build_structure_db, build_weights  # noqa: E402


def _requests(db_seqs: dict, rng, n: int, size: int):
    """n request dicts of `size` proteins: mutated copies of DB entries."""
    from e2e_benchmark import MUTATION_RATE, _mutate

    ids = list(db_seqs)
    reqs = []
    for r in range(n):
        proteins = {}
        for j in range(size):
            src = db_seqs[ids[int(rng.integers(len(ids)))]]
            proteins[f"r{r}_p{j}"] = _mutate(rng, src, MUTATION_RATE)
        reqs.append(proteins)
    return reqs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=str(
        Path(tempfile.gettempdir()) / "mdeepfri_e2e_bench_full"))
    ap.add_argument("--out", default="BENCH_SERVING.json")
    ap.add_argument("--warm-reps", type=int, default=20)
    args = ap.parse_args()

    from metagenomic_deepfri_tpu.serving import AnnotationServer
    from metagenomic_deepfri_tpu.utils import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    weights = workdir / "weights"
    structures = workdir / "structures"
    build_weights(weights)
    db_seqs = build_structure_db(structures, rng)

    t0 = time.perf_counter()
    server = AnnotationServer(weights=weights, databases=[structures],
                              db_workdir=workdir / "serving_db", threads=4)
    # constructor starts a background engine warmup; wait for it so the
    # "warm" numbers measure the steady server, not the warm race
    server._warmup_future.result()
    startup_s = time.perf_counter() - t0

    req_rng = np.random.default_rng(11)

    def timed(proteins):
        t = time.perf_counter()
        out = server.annotate(proteins)
        dt = time.perf_counter() - t
        assert out["results"], "empty annotation response"
        return dt

    cold_s = timed(_requests(db_seqs, req_rng, 1, 1)[0])
    singles = [timed(r) for r in
               _requests(db_seqs, req_rng, args.warm_reps, 1)]
    batches16 = [timed(r) for r in
                 _requests(db_seqs, req_rng, max(5, args.warm_reps // 4),
                           16)]

    conc_reqs = _requests(db_seqs, req_rng, 8, 4)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(server.annotate, conc_reqs))
    concurrent_s = time.perf_counter() - t0

    def pct(xs):
        xs = sorted(xs)
        return {"p50_ms": round(1000 * xs[len(xs) // 2], 1),
                "p90_ms": round(1000 * xs[int(len(xs) * 0.9)], 1),
                "min_ms": round(1000 * xs[0], 1)}

    from metagenomic_deepfri_tpu.bench_utils import device_record

    payload = {
        "startup_s": round(startup_s, 2),
        "cold_first_request_s": round(cold_s, 2),
        "warm_single_protein": pct(singles),
        "warm_batch16": {**pct(batches16),
                         "proteins_per_sec":
                         round(16 / (sorted(batches16)[len(batches16) // 2]),
                               1)},
        "concurrent_8x4_total_s": round(concurrent_s, 2),
        "device": device_record(),
    }
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps({"metric": "serving_warm_single_p50_ms",
                      "value": payload["warm_single_protein"]["p50_ms"],
                      "unit": "ms",
                      "vs_baseline": None,
                      "detail": payload}))


if __name__ == "__main__":
    main()
