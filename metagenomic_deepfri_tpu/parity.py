"""Numerical parity harness: JAX forward vs the ONNX graph, on real weights.

The reference validates its ONNX conversion against the original TF2 models
at ≤1e-5 abs diff on 100 random proteins (reference
``weight_convert/README.md:5-6``). This module provides the same oracle for
the JAX reimplementation: every model in a weights folder is imported
(:mod:`.models.registry`) and its scores compared against executing the
actual ONNX graph with the self-contained executor
(:class:`.models.onnx_import.OnnxExecutor`) on random proteins — the
BASELINE config-1 milestone, runnable offline and on CPU.

``trace=True`` additionally returns per-node ONNX activations for localising
a divergence (per-layer parity debugging).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

DEFAULT_TOLERANCE = 1e-4  # matches the reference's own conversion bound 1e-5
                          # with headroom for non-deterministic reductions


@dataclass
class ParityResult:
    net: str
    mode: str
    n_proteins: int
    max_abs_diff: float       # post-softmax scores
    tolerance: float
    # Pre-softmax logits, scaled: max |Δ| / (1 + |onnx_logit|). The sharp
    # oracle — softmax saturation can hide arbitrarily large logit errors
    # from the score comparison, while plain |Δ| would flag benign f32
    # accumulation noise on sum-pooled logits of O(10³) magnitude.
    max_logit_diff: float = float("nan")
    logit_tolerance: float = float("nan")

    @property
    def ok(self) -> bool:
        import math

        score_ok = self.max_abs_diff <= self.tolerance
        if math.isnan(self.max_logit_diff) \
                or math.isnan(self.logit_tolerance):
            return score_ok
        return score_ok and self.max_logit_diff <= self.logit_tolerance


def _random_protein(rng, min_len: int, max_len: int):
    from metagenomic_deepfri_tpu.ops.contact import calculate_contact_map

    aas = list("ACDEFGHIKLMNPQRSTVWY")
    L = int(rng.integers(min_len, max_len))
    seq = "".join(rng.choice(aas, size=L))
    steps = rng.normal(size=(L, 3)).astype(np.float32)
    steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
    coords = np.cumsum(3.8 * steps, axis=0).astype(np.float32)
    cmap = calculate_contact_map(coords, threshold=6.0).astype(np.float32)
    # identity diagonal, as produced by the aligned-cmap path
    np.fill_diagonal(cmap, 1.0)
    return seq, cmap


def check_model_parity(net: str, mode: str, model_path, params_json,
                       n_proteins: int = 10, min_len: int = 40,
                       max_len: int = 300,
                       tolerance: float = DEFAULT_TOLERANCE,
                       logit_tolerance: Optional[float] = None,
                       seed: int = 0) -> ParityResult:
    """Compare JAX forward vs ONNX-graph execution for one model.

    Parity is judged at TWO levels: post-softmax scores (the product
    contract, reference ``predict.pyx:98-102``) and **pre-softmax logits**
    (the sharp oracle — the per-term two-way softmax can saturate scores to
    exactly 0/1 on untrained random weights, hiding real logit divergence;
    the logit comparison has no such blind spot). The ONNX-side logits are
    read from the Softmax node's input in the execution trace.

    Both paths run under ``matmul_precision='highest'`` — on the GPU a
    float32 matmul may otherwise run in TF32 (about three decimal digits),
    and the two execution orders would diverge at ~1e-3 in logits
    regardless of semantic parity.
    """
    import jax

    from metagenomic_deepfri_tpu.models.deepfri import (cnn_forward_logits,
                                                        forward_pass_single,
                                                        gcn_forward_logits)
    from metagenomic_deepfri_tpu.models.onnx_import import (OnnxExecutor,
                                                            graph_input_roles)
    from metagenomic_deepfri_tpu.models.onnx_reader import load_onnx
    from metagenomic_deepfri_tpu.models.registry import load_model_handle
    from metagenomic_deepfri_tpu.ops.one_hot import seq2onehot, seq2tokens

    if logit_tolerance is None:
        logit_tolerance = tolerance
    handle = load_model_handle(net, mode, model_path, params_json)
    raw_graph = load_onnx(str(model_path))
    executor = OnnxExecutor(raw_graph)
    # tf2onnx names runtime inputs after the Keras layers (input_1/...), not
    # the reference's A/S convention — resolve roles structurally.
    roles = graph_input_roles(raw_graph)
    softmax = next((n for n in raw_graph.nodes if n.op_type == "Softmax"),
                   None)

    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    worst = 0.0
    worst_logit = 0.0
    with jax.default_matmul_precision("highest"):
        for _ in range(n_proteins):
            seq, cmap = _random_protein(rng, min_len, max_len)
            S = seq2onehot(seq)[None]
            tokens = jnp.asarray(seq2tokens(seq)[None, :])
            lengths = jnp.asarray(np.array([len(seq)], np.int32))
            if net == "gcn":
                outs, traced = executor.run(
                    {roles["A"]: cmap[None], roles["S"]: S}, trace=True)
                jax_scores = np.asarray(
                    forward_pass_single(handle.params, handle.config, seq,
                                        cmap))
                jax_logits = np.asarray(gcn_forward_logits(
                    handle.params, handle.config, tokens,
                    jnp.asarray(cmap[None]), lengths))
            else:
                outs, traced = executor.run({roles["S"]: S}, trace=True)
                jax_scores = np.asarray(
                    forward_pass_single(handle.params, handle.config, seq))
                jax_logits = np.asarray(cnn_forward_logits(
                    handle.params, handle.config, tokens, lengths))
            (out,) = outs
            onnx_scores = out[:, :, 0].reshape(-1)
            worst = max(worst,
                        float(np.max(np.abs(onnx_scores - jax_scores))))
            if softmax is not None and softmax.inputs[0] in traced:
                onnx_logits = traced[softmax.inputs[0]].reshape(
                    jax_logits.shape)
                scaled = np.abs(onnx_logits - jax_logits) / \
                    (1.0 + np.abs(onnx_logits))
                worst_logit = max(worst_logit, float(np.max(scaled)))
    return ParityResult(net=net, mode=mode, n_proteins=n_proteins,
                        max_abs_diff=worst, tolerance=tolerance,
                        max_logit_diff=(worst_logit if softmax is not None
                                        else float("nan")),
                        logit_tolerance=logit_tolerance)


def localize_divergence(net: str, handle, model_path, seq: str, cmap=None,
                        tolerance: float = DEFAULT_TOLERANCE) -> List[tuple]:
    """Per-stage JAX-vs-ONNX comparison for one protein.

    Returns ordered [(stage, max_abs_diff)]; the first entry above
    ``tolerance`` is where the implementations part ways. Stage names are
    shared between :func:`..models.deepfri.gcn_forward_stages` and
    :func:`..models.onnx_import.gcn_stage_tensors` (CNN likewise).
    """
    import jax

    from metagenomic_deepfri_tpu.models.deepfri import forward_stages_single
    from metagenomic_deepfri_tpu.models.onnx_import import (
        OnnxExecutor, cnn_stage_tensors, gcn_stage_tensors,
        graph_input_roles, normalize_graph)
    from metagenomic_deepfri_tpu.models.onnx_reader import load_onnx
    from metagenomic_deepfri_tpu.ops.one_hot import seq2onehot

    raw = load_onnx(str(model_path))
    executor = OnnxExecutor(raw)
    roles = graph_input_roles(raw)
    norm = normalize_graph(load_onnx(str(model_path)))
    stage_names = (gcn_stage_tensors(norm) if net == "gcn"
                   else cnn_stage_tensors(norm))

    feeds = {roles["S"]: seq2onehot(seq)[None]}
    if net == "gcn":
        feeds[roles["A"]] = np.asarray(cmap, np.float32)[None]
    with jax.default_matmul_precision("highest"):
        _, traced = executor.run(feeds, trace=True)
        jax_stages = forward_stages_single(
            handle.params, handle.config, seq,
            cmap if net == "gcn" else None)
    report = []
    for stage, tensor in stage_names:
        if tensor not in traced or stage not in jax_stages:
            continue
        ours = np.asarray(jax_stages[stage])
        theirs = np.asarray(traced[tensor])
        if stage == "scores":
            # ONNX side is the full (B, n, 2) softmax; ours is class 0.
            theirs = theirs.reshape(ours.shape + (2,))[..., 0]
        else:
            theirs = theirs.reshape(ours.shape)
        report.append((stage, float(np.max(np.abs(ours - theirs)))))
    return report


def verify_weights(weights_dir, modes: Optional[List[str]] = None,
                   n_proteins: int = 10,
                   tolerance: float = DEFAULT_TOLERANCE,
                   logit_tolerance: Optional[float] = None,
                   seed: int = 0,
                   trace: bool = False,
                   max_len: int = 300) -> List[ParityResult]:
    """Parity-check every model in a weights folder. Returns all results.

    Random proteins are drawn with lengths in ``[40, max_len)``.

    With ``trace=True``, any failing model additionally gets a per-stage
    divergence report logged (first stage over tolerance = the culprit).
    """
    from pathlib import Path

    from metagenomic_deepfri_tpu.models.registry import load_model_handle
    from metagenomic_deepfri_tpu.utils import load_deepfri_config

    config = load_deepfri_config(weights_dir)
    results = []
    for net in ("gcn", "cnn"):
        for mode, model_path in config.get(net, {}).items():
            if not isinstance(model_path, (str, Path)):
                continue
            if modes and mode not in modes:
                continue
            params_json = str(Path(model_path).with_suffix("")) + \
                "_model_params.json"
            res = check_model_parity(net, mode, model_path, params_json,
                                     n_proteins=n_proteins,
                                     max_len=max_len,
                                     tolerance=tolerance,
                                     logit_tolerance=logit_tolerance,
                                     seed=seed)
            status = "OK" if res.ok else "FAIL"
            logger.info("parity %s/%s: scores max|Δ|=%.2e (tol %.0e), "
                        "logits max|Δ|=%.2e %s", net, mode,
                        res.max_abs_diff, tolerance, res.max_logit_diff,
                        status)
            if trace and not res.ok:
                handle = load_model_handle(net, mode, model_path,
                                           params_json)
                rng = np.random.default_rng(seed)
                seq, cmap = _random_protein(rng, 40, 300)
                report = localize_divergence(
                    net, handle, model_path, seq,
                    cmap if net == "gcn" else None, tolerance=tolerance)
                for stage, diff in report:
                    marker = " <-- diverges" if diff > tolerance else ""
                    logger.info("  stage %-8s max|Δ|=%.2e%s", stage, diff,
                                marker)
            results.append(res)
    return results
