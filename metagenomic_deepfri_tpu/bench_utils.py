"""Benchmark harness: GCN inference throughput on the local device.

North-star metric (BASELINE.json): proteins/sec/chip for the GCN MF branch.
Baseline: the reference's per-protein ONNX GCN inference on proteins of
200-400 aa — median 49.5 ms ⇒ 20.2 proteins/s — computed from the raw data in
reference ``weight_convert/inference_times.csv.gz`` (400 GCN rows; see
BASELINE.md). ``vs_baseline`` is our proteins/s divided by that number.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

# reference ONNX GCN, 200-400 aa proteins, 1 CPU core (BASELINE.md)
REFERENCE_GCN_PROTEINS_PER_SEC = 20.2

# Where the device-only companion measurement is cached between runs.
DEVICE_ONLY_CACHE = "BENCH_DEVICE_ONLY.json"


def make_random_items(n: int, min_len: int, max_len: int, seed: int = 0,
                      contact_threshold: float = 6.0, form: str = "dense"):
    """Random proteins with random-walk backbones (realistic contact density).

    ``form='dense'`` → (id, seq, dense_cmap) for the dense-adjacency engine
    path; ``form='coords'`` → (id, seq, proj_coords, ins_mask) for the fused
    on-device-adjacency path (identity alignment, i.e. the query's own
    structure).
    """
    from metagenomic_deepfri_tpu.ops.contact import calculate_contact_map

    rng = np.random.default_rng(seed)
    aas = list("ACDEFGHIKLMNPQRSTVWY")
    items = []
    for i in range(n):
        L = int(rng.integers(min_len, max_len))
        seq = "".join(rng.choice(aas, size=L))
        # random-walk backbone gives realistic contact density
        steps = rng.normal(size=(L, 3)).astype(np.float32)
        steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
        coords = np.cumsum(3.8 * steps, axis=0).astype(np.float32)
        if form == "coords":
            items.append((f"bench{i}", seq, coords,
                          np.zeros(L, dtype=bool)))
        else:
            cmap = calculate_contact_map(coords, threshold=contact_threshold)
            items.append((f"bench{i}", seq, cmap))
    return items


def run_gcn_benchmark(bucket: int = 512, batches: int = 8,
                      n_labels: int = 512, batch_cap: int | None = None,
                      compute_dtype: str = "bfloat16", seed: int = 0,
                      path: str = "coords", with_device_loop="auto",
                      device_only_cache: str | None = DEVICE_ONLY_CACHE,
                      time_budget_s: float = 150.0) -> str:
    """Time full-size GCN forwards; returns the bench JSON line.

    ``path='coords'`` (default, the production pipeline path) measures the
    fused on-device-adjacency step — strictly MORE work per protein than the
    reference baseline (contact-map construction + GCN vs GCN only), shipped
    as O(L) coords. ``path='dense'`` measures the dense-adjacency path
    (reference-style inputs).

    ``with_device_loop`` controls the device-only companion number that
    feeds ``device_only_pps``/``transfer_share``: ``'auto'`` (default)
    reuses a cached measurement from ``device_only_cache`` when its
    configuration — device kind included — matches, and only runs the
    fori_loop program fresh if no valid cache exists AND the headline
    measurement has used less than ``time_budget_s`` wall-clock. ``True``
    forces a fresh loop, ``False`` skips it (cache still consulted).
    """
    import os

    import jax

    from metagenomic_deepfri_tpu.batching.buckets import gcn_batch_size
    from metagenomic_deepfri_tpu.batching.engine import (BatchedPredictor,
                                                         ModelHandle)
    from metagenomic_deepfri_tpu.models.deepfri import GCNConfig, init_gcn

    config = GCNConfig(n_labels=n_labels, compute_dtype=compute_dtype)
    params = init_gcn(jax.random.PRNGKey(seed), config)
    handle = ModelHandle("gcn", "mf", config, params)
    engine = BatchedPredictor(gcn_models={"mf": handle},
                              buckets=(bucket,),
                              batch_cap=batch_cap)

    batch = batch_cap or gcn_batch_size(bucket)
    lo = max(bucket * 2 // 5, 16)
    hi = max(bucket * 3 // 5, lo + 1)
    form = "coords" if path == "coords" else "dense"
    items = make_random_items(batch * batches, lo, hi, seed=seed, form=form)
    run = (engine.predict_gcn_from_coords if path == "coords"
           else engine.predict_gcn)

    # edges/protein estimate from a sample (diagonal + thresholded pairs),
    # for the edges/s throughput figure
    sample = items[:: max(1, len(items) // 64)][:64]
    if form == "coords":
        from metagenomic_deepfri_tpu.ops.contact import pairwise_sqeuclidean

        nnz = [int((pairwise_sqeuclidean(it[2]) < 36.0).sum())
               for it in sample]
    else:
        nnz = [int(np.asarray(it[2]).sum()) for it in sample]
    edges_per_protein = float(np.mean(nnz))

    # Executed matmul work per protein at the padded bucket length → MFU
    # against the device's bf16 peak (padding waste counts against us, which
    # is the honest utilisation figure for a bucketed engine).
    flops_per_protein = analytic_gcn_matmul_flops(config, bucket)
    device = device_record()
    peak = device_peak_bf16_flops(jax.devices()[0])

    # Compile + warm on one batch, then best of 4 timed passes over the
    # full item set (one warm batch alone has no pack/dispatch/drain
    # pipelining, so it would under-read steady throughput).
    t_start = time.perf_counter()
    run(items[:batch])
    passes = []
    for _ in range(4):
        t0 = time.perf_counter()
        run(items)
        passes.append(time.perf_counter() - t0)
    elapsed = min(passes)
    pps = len(items) / elapsed
    detail = {
        "bucket": bucket,
        "batch": batch,
        "n_proteins": len(items),
        "n_labels": n_labels,
        "elapsed_s": round(elapsed, 3),
        "elapsed_passes_s": [round(e, 3) for e in passes],
        "compute_dtype": compute_dtype,
        "path": path,
        "edges_per_sec": round(pps * edges_per_protein, 1),
        "edges_per_protein": round(edges_per_protein, 1),
        "flops_per_protein": round(flops_per_protein),
        "peak_bf16_flops": peak if peak else "none: cpu run",
        "mfu": round(pps * flops_per_protein / peak, 4) if peak else None,
        "device": device,
    }
    result = {
        "metric": "gcn_proteins_per_sec_per_chip",
        "value": round(pps, 2),
        "unit": "proteins/s",
        "vs_baseline": round(pps / REFERENCE_GCN_PROTEINS_PER_SEC, 2),
        "detail": detail,
    }
    # device-only companion number: cache-first, budget-guarded; the key
    # names the device kind so a record from another device never matches
    cache_key = {"bucket": bucket, "n_labels": n_labels,
                 "compute_dtype": compute_dtype, "batch": batch,
                 "device_kind": device["device_kind"]}
    dev = None
    dev_source = None
    if with_device_loop is not True and device_only_cache:
        dev = read_device_only_cache(device_only_cache, cache_key)
        dev_source = "cache" if dev is not None else None
    if dev is None and with_device_loop is not False:
        spent = time.perf_counter() - t_start
        if with_device_loop is True or spent < time_budget_s:
            dev = device_only_gcn_pps(bucket=bucket, n_labels=n_labels,
                                      compute_dtype=compute_dtype,
                                      batch_cap=batch_cap, seed=seed, reps=8)
            dev_source = "measured"
            if device_only_cache:
                with open(device_only_cache, "w", encoding="utf-8") as f:
                    json.dump({"config": cache_key, "measurement": dev},
                              f, indent=1)
    if dev is not None:
        detail["device_only_pps"] = dev["device_only_pps"]
        detail["device_only_mfu"] = (
            round(dev["device_only_pps"] * flops_per_protein / peak, 4)
            if peak else None)
        detail["transfer_share"] = round(
            max(0.0, 1.0 - pps / dev["device_only_pps"]), 3)
        detail["device_only_source"] = dev_source
    else:
        detail["device_only_pps"] = None
        detail["transfer_share"] = None
        detail["device_only_source"] = "skipped (over budget)"
    return json.dumps(result)


def read_device_only_cache(path: str, cache_key: dict) -> dict | None:
    """The cached device-only measurement for ``cache_key``, else None.

    A record whose configuration differs in any key — the device kind
    included — is ignored.
    """
    import os

    if not os.path.exists(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as f:
            cached = json.load(f)
    except (OSError, ValueError):
        return None
    if cached.get("config") != cache_key:
        return None
    return cached.get("measurement")


def device_record() -> dict:
    """What every benchmark record says about the device it ran on: JAX's
    platform, device kind and count, plus the card's name and power limit
    from ``nvidia-smi`` (None where there is no NVIDIA card)."""
    import subprocess

    import jax

    d = jax.devices()[0]
    card = None
    if d.platform == "gpu":
        try:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError):
            card = None
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices()),
            "card_name_power_limit": card}


def run_cnn_benchmark(bucket: int = 512, batches: int = 8,
                      n_labels: int = 512,
                      compute_dtype: str = "float32", seed: int = 0) -> str:
    """Time the CNN (sequence-only fallback) path; returns a JSON line.

    Baseline: the reference's per-protein ONNX CNN at ~2.7× its TF2 speed —
    no published proteins/s, so ``vs_baseline`` reuses the GCN reference
    point for scale (the CNN is strictly cheaper per protein).
    """
    import jax

    from metagenomic_deepfri_tpu.batching.buckets import cnn_batch_size
    from metagenomic_deepfri_tpu.batching.engine import (BatchedPredictor,
                                                         ModelHandle)
    from metagenomic_deepfri_tpu.models.deepfri import CNNConfig, init_cnn

    config = CNNConfig(n_labels=n_labels, compute_dtype=compute_dtype)
    params = init_cnn(jax.random.PRNGKey(seed), config)
    handle = ModelHandle("cnn", "mf", config, params)
    engine = BatchedPredictor(cnn_models={"mf": handle}, buckets=(bucket,))

    batch = cnn_batch_size(bucket)
    lo = max(bucket * 2 // 5, 16)
    hi = max(bucket * 3 // 5, lo + 1)
    rng = np.random.default_rng(seed)
    aas = list("ACDEFGHIKLMNPQRSTVWY")
    items = [(f"c{i}", "".join(rng.choice(aas,
                                          size=int(rng.integers(lo, hi)))))
             for i in range(batch * batches)]

    engine.predict_cnn(items)
    passes = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.predict_cnn(items)
        passes.append(time.perf_counter() - t0)
    pps = len(items) / min(passes)
    flops = analytic_cnn_matmul_flops(config, bucket)
    peak = device_peak_bf16_flops(jax.devices()[0])
    return json.dumps({
        "metric": "cnn_proteins_per_sec_per_chip",
        "value": round(pps, 2),
        "unit": "proteins/s",
        "vs_baseline": round(pps / REFERENCE_GCN_PROTEINS_PER_SEC, 2),
        "detail": {"bucket": bucket, "batch": batch,
                   "n_proteins": len(items), "n_labels": n_labels,
                   "compute_dtype": compute_dtype,
                   "elapsed_passes_s": [round(e, 3) for e in passes],
                   "flops_per_protein": round(flops),
                   "mfu": round(pps * flops / peak, 5) if peak else None,
                   "device": device_record()},
    })


def run_multimode_benchmark(bucket: int = 512, batches: int = 4,
                            compute_dtype: str = "bfloat16",
                            seed: int = 0,
                            out_path: str = "BENCH_MULTIMODE.json") -> str:
    """3-mode (bp/cc/mf) GCN pass with the shared-LM trunk vs per-mode dispatch.

    Mirrors the production situation: the published DeepFRI models share one
    frozen pretrained LSTM-LM, so the engine's shared-trunk detection fires
    and a 3-mode batch computes the LM + adjacency once. Reports
    mode-annotations/s (proteins × modes / s) for both engines and the
    measured speedup. Real vocabulary sizes per mode (BP 3992 / CC 320 /
    MF 489, reference per-model ``*_model_params.json``).
    """
    import jax

    from metagenomic_deepfri_tpu.batching.buckets import gcn_batch_size
    from metagenomic_deepfri_tpu.batching.engine import (BatchedPredictor,
                                                         ModelHandle)
    from metagenomic_deepfri_tpu.models.deepfri import GCNConfig, init_gcn

    labels = {"bp": 3992, "cc": 320, "mf": 489}
    handles = {}
    base = None
    for i, (mode, n_labels) in enumerate(labels.items()):
        cfg = GCNConfig(n_labels=n_labels, compute_dtype=compute_dtype)
        params = init_gcn(jax.random.PRNGKey(seed + i), cfg)
        if base is None:
            base = params
        else:
            params["lm"] = base["lm"]
            params["lm_embed"] = base["lm_embed"]
            params["aa_embed"] = base["aa_embed"]
        # calibrated sparse score profile (real models emit few terms
        # ≥ 0.1; untouched random heads emit ~n_labels/2) so the top-k
        # configuration is measured in its design regime
        kernel = np.asarray(params["head"]["kernel"]) * 1e-4
        bias = np.zeros(2 * n_labels, np.float32)
        bias[1::2] = 6.0
        rng_b = np.random.default_rng(seed + 17 * i)
        for t in rng_b.choice(n_labels, size=max(4, n_labels // 100),
                              replace=False):
            bias[2 * t] = 6.0
            bias[2 * t + 1] = 0.0
        params["head"] = {"kernel": kernel, "bias": bias}
        handles[mode] = ModelHandle("gcn", mode, cfg, params)

    shared_engine = BatchedPredictor(gcn_models=handles, buckets=(bucket,))
    assert shared_engine._gcn_shared is not None
    control = BatchedPredictor(gcn_models=handles, buckets=(bucket,))
    control._gcn_shared = None  # identical engine, per-mode dispatch
    topk_engine = BatchedPredictor(gcn_models=handles, buckets=(bucket,),
                                   score_topk=256)

    batch = gcn_batch_size(bucket)
    lo = max(bucket * 2 // 5, 16)
    hi = max(bucket * 3 // 5, lo + 1)
    items = make_random_items(batch * batches, lo, hi, seed=seed,
                              form="coords")

    def timed(engine):
        engine.predict_gcn_from_coords(items)  # compile + warm
        passes = []
        for _ in range(3):
            t0 = time.perf_counter()
            engine.predict_gcn_from_coords(items)
            passes.append(time.perf_counter() - t0)
        return min(passes), passes

    t_shared, p_shared = timed(shared_engine)
    t_control, p_control = timed(control)
    t_topk, p_topk = timed(topk_engine)
    n_ann = len(items) * len(labels)
    aps_shared = n_ann / t_shared
    aps_control = n_ann / t_control
    aps_topk = n_ann / t_topk

    # Device-only split (inputs resident, scores reduced on device): the
    # end-to-end number above also carries host packing and transfers,
    # which can hide part of the compute saving.
    dev = _device_only_multimode(shared_engine, control, handles, bucket,
                                 batch, seed=seed)
    # all-modes FLOPs per protein: per-mode totals minus the trunk counted
    # (n_modes - 1) extra times when shared
    per_mode_flops = [analytic_gcn_matmul_flops(h.config, bucket)
                      for h in handles.values()]
    trunk = analytic_gcn_trunk_flops(handles["mf"].config, bucket)
    flops = sum(per_mode_flops) - (len(labels) - 1) * trunk
    peak = device_peak_bf16_flops(jax.devices()[0])
    payload = {
        "device": device_record(), "bucket": bucket, "batch": batch,
        "n_proteins": len(items), "modes": list(labels),
        "compute_dtype": compute_dtype,
        "shared": {"annotations_per_sec": round(aps_shared, 1),
                   "elapsed_passes_s": [round(e, 3) for e in p_shared]},
        "per_mode": {"annotations_per_sec": round(aps_control, 1),
                     "elapsed_passes_s": [round(e, 3) for e in p_control]},
        "shared_topk256": {"annotations_per_sec": round(aps_topk, 1),
                           "elapsed_passes_s": [round(e, 3)
                                                for e in p_topk]},
        "speedup": round(aps_shared / aps_control, 3),
        "speedup_with_topk": round(aps_topk / aps_control, 3),
        "device_only": dev,
        "flops_per_protein_all_modes": round(flops),
        "mfu_device_only_shared": (
            round(dev["shared_aps"] / len(labels) * flops / peak, 4)
            if peak else None),
    }
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1)
    return json.dumps({
        "metric": "gcn_3mode_annotations_per_sec_per_chip",
        "value": round(aps_topk, 1), "unit": "annotations/s",
        "vs_baseline": round((aps_topk / len(labels))
                             / REFERENCE_GCN_PROTEINS_PER_SEC, 2),
        "detail": {"per_mode_dispatch_aps": round(aps_control, 1),
                   "shared_trunk_aps": round(aps_shared, 1),
                   "shared_trunk_speedup": payload["speedup"],
                   "speedup_with_topk": payload["speedup_with_topk"],
                   "device_only_shared_aps": dev["shared_aps"],
                   "device_only_per_mode_aps": dev["per_mode_aps"],
                   "device_only_speedup": dev["speedup"],
                   "mfu_device_only_shared":
                       payload["mfu_device_only_shared"],
                   "flops_per_protein_all_modes": round(flops),
                   "bucket": bucket, "batch": batch,
                   "n_proteins": len(items), "out": out_path},
    })


def _device_only_multimode(shared_engine, control, handles, bucket: int,
                           batch: int, reps: int = 6, seed: int = 0) -> dict:
    """fori_loop timing of the 3-mode shared-trunk program vs per-mode
    programs with all inputs device-resident (see device_only_gcn_pps for
    the methodology: every tensor input varied with the loop index, scores
    reduced on device, best-of-3)."""
    import jax
    import jax.numpy as jnp

    modes = tuple(handles)
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(batch, bucket, 3)).astype(np.float32)
    steps /= np.linalg.norm(steps, axis=2, keepdims=True) + 1e-9
    coords = np.cumsum(3.8 * steps, axis=1).astype(np.float32)
    tokens = rng.integers(0, 20, (batch, bucket)).astype(np.uint8)
    ins = np.zeros((batch, bucket), dtype=bool)
    lengths = rng.integers(max(bucket // 2, 1), bucket + 1,
                           size=(batch,)).astype(np.int32)

    def vary(i, c, t, ln):
        return (c + i.astype(jnp.float32) * 1e-4,
                ((t.astype(jnp.int32) + i) % 20).astype(jnp.uint8),
                jnp.maximum(ln - (i % 2), 1))

    shared_p, pm = shared_engine._multi_params(modes)

    # Re-derive the unjitted forwards (a fori_loop body wants the raw
    # functions, not the engine's jitted steps).
    from metagenomic_deepfri_tpu.models.deepfri import gcn_forward_multimode
    from metagenomic_deepfri_tpu.ops.cmap_align import \
        aligned_contacts_from_coords

    cfgs = {m: handles[m].config for m in modes}
    thr = shared_engine.contact_threshold
    gen = shared_engine.generated_contacts

    def multi_fwd(shared_p, pm, c, t, ins, ln):
        adj = aligned_contacts_from_coords(c, ins, ln, threshold=thr,
                                           generated_contacts=gen)
        return gcn_forward_multimode(shared_p, pm, cfgs, t, adj, ln)

    def shared_loop(shared_p, pm, coords, tokens, ins, lengths):
        def body(i, acc):
            c, t, ln = vary(i, coords, tokens, lengths)
            out = multi_fwd(shared_p, pm, c, t, ins, ln)
            return acc + sum(jnp.sum(v.astype(jnp.float32))
                             for v in out.values())
        return jax.lax.fori_loop(0, reps, body, jnp.float32(0.0))

    per_fwds = {m: control._gcn_coords_forward(m) for m in modes}
    params_by_mode = {m: handles[m].params for m in modes}

    def control_loop(params_by_mode, coords, tokens, ins, lengths):
        def body(i, acc):
            c, t, ln = vary(i, coords, tokens, lengths)
            for m in modes:
                acc = acc + jnp.sum(
                    per_fwds[m](params_by_mode[m], c, t, ins, ln)
                    .astype(jnp.float32))
            return acc
        return jax.lax.fori_loop(0, reps, body, jnp.float32(0.0))

    def time_loop(fn, *args):
        jitted = jax.jit(fn)
        dev_args = jax.device_put(args)
        assert np.isfinite(float(jitted(*dev_args)))
        passes = []
        for _ in range(3):
            t0 = time.perf_counter()
            acc = float(jitted(*dev_args))
            passes.append(time.perf_counter() - t0)
            assert np.isfinite(acc)
        return min(passes)

    t_shared = time_loop(shared_loop, shared_p, pm, coords, tokens, ins,
                         lengths)
    t_control = time_loop(control_loop, params_by_mode, coords, tokens, ins,
                          lengths)
    n_ann = batch * reps * len(modes)
    return {"shared_aps": round(n_ann / t_shared, 1),
            "per_mode_aps": round(n_ann / t_control, 1),
            "speedup": round(t_control / t_shared, 3),
            "reps": reps, "batch": batch}


def run_realvocab_benchmark(out_path: str = "BENCH_REALVOCAB.json") -> str:
    """Bench points at the real published vocabulary sizes.

    DeepFRI v1.1 per-model `goterms` counts: MF ≈ 489, BP ≈ 3992
    (reference per-model ``*_model_params.json``; the BP head multiplies
    the head matmul and the D2H score volume ~8×). Runs GCN MF/BP and CNN
    MF/BP, writes all four lines to ``out_path`` and returns a summary.
    """
    points = [
        ("gcn", "mf", 489), ("gcn", "bp", 3992),
        ("cnn", "mf", 489), ("cnn", "bp", 3992),
    ]
    rows = []
    for net, mode, n_labels in points:
        if net == "gcn":
            line = json.loads(run_gcn_benchmark(bucket=512, batches=4,
                                                n_labels=n_labels))
        else:
            line = json.loads(run_cnn_benchmark(bucket=512, batches=4,
                                                n_labels=n_labels))
        rows.append({"net": net, "mode": mode, "n_labels": n_labels,
                     "pps": line["value"], "detail": line["detail"]})
        print(f"# {net}/{mode} ({n_labels} terms): {line['value']} p/s",
              file=sys.stderr, flush=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump({"points": rows}, f, indent=1)
    gcn_bp = next(r["pps"] for r in rows
                  if r["net"] == "gcn" and r["mode"] == "bp")
    return json.dumps({
        "metric": "gcn_bp_realvocab_proteins_per_sec_per_chip",
        "value": gcn_bp, "unit": "proteins/s",
        "vs_baseline": round(gcn_bp / REFERENCE_GCN_PROTEINS_PER_SEC, 2),
        "detail": {"points": {f"{r['net']}/{r['mode']}": r["pps"]
                              for r in rows}, "out": out_path},
    })


# ---------------------------------------------------------------------------
# Analytic FLOPs + MFU
# ---------------------------------------------------------------------------

# Dense peak rates per device kind, keyed by JAX's ``device_kind``.
# Source: NVIDIA H100 SXM data sheet (dense, no sparsity), at the full 700 W
# power limit; a card set below it cannot hold its top clock under a
# matrix-heavy load, so records carry the card's power limit beside them.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def device_peaks(device) -> dict | None:
    """Peak rates for ``device``; None on the CPU, which has no peak (CPU
    runs are protocol tests only). An accelerator missing from
    :data:`DEVICE_PEAKS` is an error, never a default."""
    if device.platform == "cpu":
        return None
    kind = device.device_kind
    if kind not in DEVICE_PEAKS:
        raise KeyError(f"no peak rates recorded for device kind {kind!r}; "
                       "add its data-sheet figures to DEVICE_PEAKS")
    return DEVICE_PEAKS[kind]


def device_peak_bf16_flops(device) -> float | None:
    peaks = device_peaks(device)
    return peaks["bf16_flops"] if peaks else None


def analytic_gcn_matmul_flops(config, L: int) -> float:
    """Matmul FLOPs (2·MACs) for ONE protein at padded length L.

    Counts the matmul work actually executed per padded row of a batch:
    LSTM input+recurrent matmuls, the two embedding projections, the
    GraphConv A·X aggregations and kernels, the FC stack, and the per-term
    head. Elementwise/normalisation work (O(L²) adds, gate nonlinearities)
    is excluded — it is not the MFU numerator.
    """
    V, H, E = config.vocab, config.lm_hidden, config.embed_dim
    dirs = 2 if config.lm_bidirectional else 1
    f = 0.0
    in_dim = V
    for _ in range(config.lm_layers):
        f += dirs * L * 2.0 * in_dim * 4 * H   # x @ W  (precomputed bulk)
        f += dirs * L * 2.0 * H * 4 * H        # h @ R  (per-step scan)
        in_dim = H * dirs
    f += L * 2.0 * in_dim * E                  # lm_embed
    f += L * 2.0 * V * E                       # aa_embed
    d_in = E
    for d_out in config.gc_dims:
        f += 2.0 * L * L * d_in                # A · X aggregation
        f += 2.0 * L * d_in * d_out            # GraphConv kernel
        d_in = d_out
    in_dim = sum(config.gc_dims)
    for d in config.fc_dims:
        f += 2.0 * in_dim * d
        in_dim = d
    f += 2.0 * in_dim * 2 * config.n_labels
    return f


def analytic_gcn_trunk_flops(config, L: int) -> float:
    """Matmul FLOPs of the shared GCN trunk (LSTM-LM + the two embedding
    projections) for ONE protein at padded length L — the part a multi-mode
    shared-trunk pass computes once instead of once per mode."""
    V, H, E = config.vocab, config.lm_hidden, config.embed_dim
    dirs = 2 if config.lm_bidirectional else 1
    f = 0.0
    in_dim = V
    for _ in range(config.lm_layers):
        f += dirs * L * 2.0 * in_dim * 4 * H
        f += dirs * L * 2.0 * H * 4 * H
        in_dim = H * dirs
    f += L * 2.0 * in_dim * E
    f += L * 2.0 * V * E
    return f


def analytic_cnn_matmul_flops(config, L: int) -> float:
    """Matmul-equivalent FLOPs for ONE protein at padded length L (conv
    branches as implicit matmuls + FC stack + head)."""
    V, F = config.vocab, config.conv_filters
    f = 0.0
    for k in config.conv_kernels:
        f += L * 2.0 * k * V * F
    in_dim = F * len(config.conv_kernels)
    for d in config.fc_dims:
        f += 2.0 * in_dim * d
        in_dim = d
    f += 2.0 * in_dim * 2 * config.n_labels
    return f


# ---------------------------------------------------------------------------
# Device-only throughput (inputs pre-staged; splits transfer from compute)
# ---------------------------------------------------------------------------

def device_only_gcn_pps(bucket: int = 512, n_labels: int = 512,
                        compute_dtype: str = "bfloat16",
                        reps: int = 20,
                        batch_cap: int | None = None,
                        seed: int = 0) -> dict:
    """Time the engine's exact per-batch GCN program with inputs resident
    on device: a fori_loop of ``reps`` forwards inside ONE jit, every
    tensor input varied with the loop index (otherwise XLA hoists the
    invariant computation out of the loop), timed by fetching the reduced
    scalar. This isolates device compute from host work and transfers.
    """
    import jax
    import jax.numpy as jnp

    from metagenomic_deepfri_tpu.batching.buckets import gcn_batch_size
    from metagenomic_deepfri_tpu.batching.engine import (BatchedPredictor,
                                                         ModelHandle)
    from metagenomic_deepfri_tpu.models.deepfri import GCNConfig, init_gcn

    config = GCNConfig(n_labels=n_labels, compute_dtype=compute_dtype)
    params = init_gcn(jax.random.PRNGKey(seed), config)
    handle = ModelHandle("gcn", "mf", config, params)
    engine = BatchedPredictor(gcn_models={"mf": handle}, buckets=(bucket,))
    fwd = engine._gcn_coords_forward("mf")

    B = batch_cap or gcn_batch_size(bucket)
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(B, bucket, 3)).astype(np.float32)
    steps /= np.linalg.norm(steps, axis=2, keepdims=True) + 1e-9
    coords = np.cumsum(3.8 * steps, axis=1).astype(np.float32)
    tokens = rng.integers(0, 20, (B, bucket)).astype(np.uint8)
    ins = np.zeros((B, bucket), dtype=bool)
    lengths = rng.integers(max(bucket // 2, 1), bucket + 1,
                           size=(B,)).astype(np.int32)

    def loop(params, coords, tokens, ins, lengths):
        def body(i, acc):
            c = coords + (i.astype(jnp.float32) * 1e-4)
            t = ((tokens.astype(jnp.int32) + i) % 20).astype(jnp.uint8)
            ln = jnp.maximum(lengths - (i % 2), 1)
            out = fwd(params, c, t, ins, ln)
            return acc + jnp.sum(out.astype(jnp.float32))
        return jax.lax.fori_loop(0, reps, body, jnp.float32(0.0))

    jitted = jax.jit(loop)
    dev_args = jax.device_put((params, coords, tokens, ins, lengths))
    float(jitted(*dev_args))  # compile + first execution
    passes = []
    for _ in range(3):  # best-of-3
        t0 = time.perf_counter()
        acc = float(jitted(*dev_args))
        passes.append(time.perf_counter() - t0)
        assert np.isfinite(acc)
    elapsed = min(passes)
    pps = B * reps / elapsed
    return {"device_only_pps": round(pps, 2), "batch": B, "reps": reps,
            "elapsed_s": round(elapsed, 3),
            "elapsed_passes_s": [round(e, 3) for e in passes],
            "flops_per_protein": analytic_gcn_matmul_flops(config, bucket)}


def run_roofline_benchmark(bucket: int = 512, n_labels: int = 512,
                           compute_dtype: str = "bfloat16",
                           reps: int = 20, seed: int = 0,
                           batch_cap: int | None = None,
                           out_path: str = "BENCH_ROOFLINE.json") -> str:
    """Per-stage device-only split of the fused GCN step (roofline view).

    Times each pipeline stage as its own fori_loop program with inputs
    resident on device — adjacency construction (coords → normalised A),
    the LSTM-LM trunk (one-hot → scan → embedding merge), the GraphConv
    stack (A·X aggregations + kernels), and the pooled FC/head — plus the
    full fused step for comparison. Each stage's analytic matmul FLOPs
    give a per-stage MFU, locating the device-MFU plateau: the LSTM scan
    serialises L small (H×4H) matmuls per layer while the GraphConv stack
    runs L×L×E batched einsums, so their attainable utilisations differ
    by construction. Writes the split to ``out_path`` and returns a
    one-line JSON summary.
    """
    import jax
    import jax.numpy as jnp

    from metagenomic_deepfri_tpu.batching.buckets import gcn_batch_size
    from metagenomic_deepfri_tpu.models.deepfri import (
        GCNConfig, _dense, graphconv_apply, init_gcn, normalize_adjacency)
    from metagenomic_deepfri_tpu.models.lstm import lstm_stack_forward
    from metagenomic_deepfri_tpu.ops.cmap_align import \
        aligned_contacts_from_coords
    from metagenomic_deepfri_tpu.ops.one_hot import tokens2onehot

    config = GCNConfig(n_labels=n_labels, compute_dtype=compute_dtype)
    params = init_gcn(jax.random.PRNGKey(seed), config)
    dtype = jnp.dtype(compute_dtype)
    B = batch_cap or gcn_batch_size(bucket)
    L = bucket
    E = config.embed_dim

    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(B, L, 3)).astype(np.float32)
    steps /= np.linalg.norm(steps, axis=2, keepdims=True) + 1e-9
    coords = np.cumsum(3.8 * steps, axis=1).astype(np.float32)
    tokens = rng.integers(0, 20, (B, L)).astype(np.uint8)
    ins = np.zeros((B, L), dtype=bool)
    lengths = rng.integers(max(L // 2, 1), L + 1, size=(B,)).astype(np.int32)
    x_embed = rng.normal(size=(B, L, E)).astype(np.float32)

    def loop(body):
        def outer(*args):
            def step(i, acc):
                return acc + body(i, *args)
            return jax.lax.fori_loop(0, reps, step, jnp.float32(0.0))
        return outer

    def time_loop(fn, *args):
        jitted = jax.jit(loop(fn))
        dev = jax.device_put(args)
        float(jitted(*dev))  # compile + first execution
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            acc = float(jitted(*dev))
            best = min(best, time.perf_counter() - t0)
            assert np.isfinite(acc)
        return best

    thr, gen = 6.0, 2  # engine defaults (BatchedPredictor.__init__)

    def adj_stage(i, coords, ins, lengths):
        c = coords + i.astype(jnp.float32) * 1e-4
        ln = jnp.maximum(lengths - (i % 2), 1)
        adj = aligned_contacts_from_coords(c, ins, ln, threshold=thr,
                                           generated_contacts=gen)
        adj = normalize_adjacency(adj.astype(jnp.float32),
                                  config.adj_norm).astype(dtype)
        return jnp.sum(adj.astype(jnp.float32))

    def lm_stage(i, tokens, lengths):
        t = ((tokens.astype(jnp.int32) + i) % 20).astype(jnp.uint8)
        ln = jnp.maximum(lengths - (i % 2), 1)
        onehot = tokens2onehot(t, dtype=jnp.float32)
        valid = (jnp.arange(L, dtype=jnp.int32)[None, :]
                 < ln[:, None]).astype(jnp.float32)
        onehot = onehot * valid[:, :, None]
        lm_out = lstm_stack_forward(params["lm"], onehot, ln,
                                    compute_dtype=dtype)
        x = (_dense(params["lm_embed"], lm_out)
             + _dense(params["aa_embed"], onehot))
        return jnp.sum(jax.nn.relu(x).astype(jnp.float32))

    # adjacency built ONCE on device for the GraphConv stage input
    adj_once = jax.jit(lambda c, m, ln: normalize_adjacency(
        aligned_contacts_from_coords(c, m, ln, threshold=thr,
                                     generated_contacts=gen)
        .astype(jnp.float32), config.adj_norm).astype(dtype))(
            coords, ins, lengths)

    def gc_stage(i, x0, adj):
        x = (x0 + i.astype(jnp.float32) * 1e-4).astype(dtype)
        outs = []
        for layer in params["gc"]:
            agg = jnp.einsum("bij,bjd->bid", adj, x,
                             preferred_element_type=jnp.float32)
            x = graphconv_apply(layer, agg, dtype)
            outs.append(x)
        concat = jnp.concatenate(outs, axis=-1).astype(jnp.float32)
        return jnp.sum(concat) * 1e-6

    pooled_host = rng.normal(size=(B, sum(config.gc_dims))).astype(np.float32)

    def fc_stage(i, pooled):
        p = pooled + i.astype(jnp.float32) * 1e-4
        for layer in params["fc"]:
            p = jax.nn.relu(_dense(layer, p))
        logits = _dense(params["head"], p)
        logits = logits.reshape(*logits.shape[:-1], config.n_labels, 2)
        return jnp.sum(jax.nn.softmax(logits, axis=-1)[..., 0])

    # FLOPs split (matmul-only, per protein at padded L)
    total_f = analytic_gcn_matmul_flops(config, L)
    lm_f = analytic_gcn_trunk_flops(config, L)
    fc_f = 0.0
    in_dim = sum(config.gc_dims)
    for d in config.fc_dims:
        fc_f += 2.0 * in_dim * d
        in_dim = d
    fc_f += 2.0 * in_dim * 2 * config.n_labels
    gc_f = total_f - lm_f - fc_f

    peak = device_peak_bf16_flops(jax.devices()[0])
    stages = [
        ("adjacency", adj_stage, (coords, ins, lengths), 0.0),
        ("lm_trunk", lm_stage, (tokens, lengths), lm_f),
        ("graphconv", gc_stage, (x_embed, adj_once), gc_f),
        ("fc_head", fc_stage, (pooled_host,), fc_f),
    ]
    cells = []
    for name, fn, args, flops in stages:
        print(f"roofline: timing stage {name}...", file=sys.stderr,
              flush=True)
        elapsed = time_loop(fn, *args)
        pps = B * reps / elapsed
        cells.append({
            "stage": name,
            "elapsed_s": round(elapsed, 4),
            "us_per_protein": round(1e6 / pps, 2),
            "stage_mfu": (round(pps * flops / peak, 4)
                          if peak and flops else None),
            "flops_per_protein": round(flops),
        })

    # the fused production step, for the sum-of-stages comparison
    engine_dev = device_only_gcn_pps(bucket=bucket, n_labels=n_labels,
                                     compute_dtype=compute_dtype,
                                     reps=reps, seed=seed,
                                     batch_cap=batch_cap)
    fused_us = 1e6 / engine_dev["device_only_pps"]
    stage_sum_us = sum(c["us_per_protein"] for c in cells)
    total_us = sum(c["us_per_protein"] for c in cells)
    for c in cells:
        c["share_of_stages"] = round(c["us_per_protein"] / total_us, 3)

    report = {
        "bucket": bucket, "batch": B, "n_labels": n_labels,
        "compute_dtype": compute_dtype, "reps": reps,
        "device": device_record(),
        "stages": cells,
        "fused_us_per_protein": round(fused_us, 2),
        "stage_sum_us_per_protein": round(stage_sum_us, 2),
        "fused_mfu": (round(engine_dev["device_only_pps"] * total_f / peak, 4)
                      if peak else None),
    }
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1)

    lm_share = next(c["share_of_stages"] for c in cells
                    if c["stage"] == "lm_trunk")
    return json.dumps({
        "metric": "gcn_roofline_lm_share",
        "value": lm_share,
        "unit": "fraction_of_device_time",
        "vs_baseline": 0,
        "detail": {k: report[k] for k in ("bucket", "batch",
                                          "fused_us_per_protein",
                                          "stage_sum_us_per_protein",
                                          "fused_mfu")} | {
            "stages": {c["stage"]: c["share_of_stages"] for c in cells},
            "out_path": out_path},
    })


def run_mesh_benchmark() -> str:
    """Spawn the virtual-mesh scaling benchmark in a fresh process.

    ``bench_mesh`` needs 8 forced host CPU devices, which must be
    configured before jax initialises — impossible in a process that may
    already have touched the accelerator, hence the child process.
    """
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    flags = env.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (flags + " "
                            "--xla_force_host_platform_device_count=8").strip()
    proc = subprocess.run(
        [sys.executable, "-m", "metagenomic_deepfri_tpu.bench_mesh"],
        env=env, capture_output=True, text=True, timeout=1800,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if proc.returncode != 0:
        raise RuntimeError(f"bench_mesh failed:\n{proc.stderr[-2000:]}")
    # the child prints exactly one JSON line on stdout
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("{")][-1]
    return line
