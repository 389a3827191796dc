#!/usr/bin/env python
"""Headline benchmark: GCN MF-branch inference throughput on one device.

Prints exactly ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": ...}
and exits non-zero if the measurement fails. The record's ``detail.device``
names the platform, device kind and count JAX reports, and the card's name
and power limit.

Baseline = reference ONNX per-protein GCN inference (20.2 proteins/s median
on 200-400 aa proteins, 1 CPU core; see BASELINE.md and
metagenomic_deepfri_tpu/bench_utils.py).

Modes (each still prints one JSON line; sidecar files carry the detail):
  (default)        headline GCN point with MFU + device-only companion
  --realvocab      real vocabulary sizes (MF 489 / BP 3992) + CNN lines
                   → BENCH_REALVOCAB.json
  --multimode      3-mode shared-LM trunk pass vs per-mode dispatch
                   → BENCH_MULTIMODE.json
  --mesh           virtual 8-device CPU mesh batch-scaling efficiency
                   → BENCH_MESH.json (collective structure proxy, not perf)
  --roofline       per-stage device-only split (adjacency | LSTM-LM |
                   GraphConv | FC/head) → BENCH_ROOFLINE.json
  --device-loop    force a fresh device-only measurement (refreshes cache)
  --no-device-loop never run the device-only loop (cache still consulted)

``MDEEPFRI_BENCH_TINY=1`` pins the CPU and shrinks the workload: a protocol
test of this script, not a measurement.
"""

import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def run_measurement(args):
    if os.environ.get("MDEEPFRI_BENCH_TINY"):
        import jax

        jax.config.update("jax_platforms", "cpu")
    from metagenomic_deepfri_tpu import bench_utils
    from metagenomic_deepfri_tpu.utils import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    if "--multimode" in args:
        return bench_utils.run_multimode_benchmark()
    if "--realvocab" in args:
        return bench_utils.run_realvocab_benchmark()
    if "--mesh" in args:
        return bench_utils.run_mesh_benchmark()
    if "--roofline" in args:
        return bench_utils.run_roofline_benchmark()
    if "--device-loop" in args:
        with_device_loop = True
    elif "--no-device-loop" in args:
        with_device_loop = False
    else:
        with_device_loop = "auto"
    if os.environ.get("MDEEPFRI_BENCH_TINY"):
        return bench_utils.run_gcn_benchmark(
            bucket=32, batches=2, n_labels=8, batch_cap=2,
            with_device_loop=False, device_only_cache=None)
    return bench_utils.run_gcn_benchmark(bucket=512, batches=4, n_labels=512,
                                         with_device_loop=with_device_loop)


def main():
    print(run_measurement(set(sys.argv[1:])))


if __name__ == "__main__":
    main()
