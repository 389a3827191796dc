"""The batched engine against the plain numpy ONNX executor.

The engine pads proteins to length buckets, builds each aligned adjacency
on device from projected coordinates, and evaluates the imported models in
float32; :class:`OnnxExecutor` runs each exported graph one protein at a
time on the host-built aligned contact map — code the engine shares
nothing with. Scores must agree to ``parity.DEFAULT_TOLERANCE``.
"""

import json

import numpy as np
import pytest

import jax

from metagenomic_deepfri_tpu.batching.engine import BatchedPredictor
from metagenomic_deepfri_tpu.models.deepfri import (CNNConfig, GCNConfig,
                                                    init_cnn, init_gcn)
from metagenomic_deepfri_tpu.models.onnx_import import (OnnxExecutor,
                                                        export_cnn_to_onnx,
                                                        export_gcn_to_onnx,
                                                        graph_input_roles)
from metagenomic_deepfri_tpu.models.onnx_reader import load_onnx
from metagenomic_deepfri_tpu.models.registry import load_model_handle
from metagenomic_deepfri_tpu.ops.cmap_align import (align_contact_map,
                                                    project_alignment_coords)
from metagenomic_deepfri_tpu.ops.contact import calculate_contact_map
from metagenomic_deepfri_tpu.ops.one_hot import seq2onehot
from metagenomic_deepfri_tpu.parity import DEFAULT_TOLERANCE

N_LABELS = 5
GCN_CFG = GCNConfig(n_labels=N_LABELS, lm_hidden=8, lm_layers=1,
                    embed_dim=16, gc_dims=(8, 8), fc_dims=(16,))
CNN_CFG = CNNConfig(n_labels=N_LABELS, conv_filters=8, conv_kernels=(3, 5),
                    fc_dims=(16,))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("oracle")
    params_json = root / "params.json"
    terms = [f"GO:{i:07d}" for i in range(N_LABELS)]
    params_json.write_text(json.dumps({"goterms": terms, "gonames": terms}))
    out = {}
    for net, init, cfg, export in (
            ("gcn", init_gcn, GCN_CFG, export_gcn_to_onnx),
            ("cnn", init_cnn, CNN_CFG, export_cnn_to_onnx)):
        path = str(root / f"{net}.onnx")
        export(init(jax.random.PRNGKey(7), cfg), cfg, path)
        graph = load_onnx(path)
        out[net] = (load_model_handle(net, "mf", path, params_json),
                    OnnxExecutor(graph), graph_input_roles(graph))
    return out


def _proteins(bucket, n, seed):
    """Proteins whose lengths fill ``bucket``, aligned to a point-mutated
    copy of themselves with a few query insertions."""
    rng = np.random.default_rng(seed)
    aas = list("ACDEFGHIKLMNPQRSTVWY")
    out = []
    for i in range(n):
        L = int(rng.integers(bucket // 2 + 1, bucket + 1))
        seq = "".join(rng.choice(aas, size=L))
        gapped_t = list(seq)
        for pos in rng.choice(L, size=3, replace=False):
            gapped_t[pos] = "-"
        target = "".join(c for c in gapped_t if c != "-")
        steps = rng.normal(size=(len(target), 3)).astype(np.float32)
        steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
        coords = np.cumsum(3.8 * steps, axis=0).astype(np.float32)
        out.append((f"p{i}", seq, "".join(gapped_t), coords))
    return out


@pytest.mark.parametrize("bucket", [128, 256, 512])
def test_engine_scores_match_onnx_executor(models, bucket):
    proteins = _proteins(bucket, 3, seed=bucket)
    gcn_handle, gcn_exec, gcn_roles = models["gcn"]
    cnn_handle, cnn_exec, cnn_roles = models["cnn"]
    engine = BatchedPredictor(gcn_models={"mf": gcn_handle},
                              cnn_models={"mf": cnn_handle},
                              buckets=(bucket,))
    items = []
    for qid, seq, gapped_t, coords in proteins:
        proj, ins, _ = project_alignment_coords(seq, gapped_t, coords)
        items.append((qid, seq, proj, ins))
    gcn = engine.predict_gcn_from_coords(items)["mf"]
    cnn = engine.predict_cnn([(q, s) for q, s, _, _ in proteins])["mf"]
    for qid, seq, gapped_t, coords in proteins:
        sparse = calculate_contact_map(coords, threshold=6.0, mode="sparse")
        cmap = align_contact_map(seq, gapped_t, sparse, 2)
        S = seq2onehot(seq)[None]
        (ref,) = gcn_exec.run({gcn_roles["A"]: cmap[None].astype(np.float32),
                               gcn_roles["S"]: S})
        np.testing.assert_allclose(gcn[qid], ref[0, :, 0], rtol=0,
                                   atol=DEFAULT_TOLERANCE)
        (ref,) = cnn_exec.run({cnn_roles["S"]: S})
        np.testing.assert_allclose(cnn[qid], ref[0, :, 0], rtol=0,
                                   atol=DEFAULT_TOLERANCE)
