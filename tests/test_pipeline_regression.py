"""End-to-end pipeline regression test.

Runs the REAL ``predict_protein_function`` control flow (and the hierarchical
search with the built-in engine) over synthetic queries, a synthetic sequence
database, and real (randomly-initialised) models exported to ONNX and loaded
back through the registry. Only the structure-coordinate fetch is patched
(network/FoldComp), mirroring the reference's regression strategy
(reference ``tests/test_pipeline_regression.py`` patches the same seam).
"""

import json
from pathlib import Path

import numpy as np
import pytest

import jax

from metagenomic_deepfri_tpu.models.deepfri import CNNConfig, GCNConfig
from metagenomic_deepfri_tpu.models.onnx_import import (export_cnn_to_onnx,
                                                        export_gcn_to_onnx)
from metagenomic_deepfri_tpu.models.deepfri import init_cnn, init_gcn
from metagenomic_deepfri_tpu.data.fasta import write_fasta
from metagenomic_deepfri_tpu.pipeline import (ALIGNMENT_HEADER,
                                              FINAL_OUTPUT_HEADER,
                                              hierarchical_database_search,
                                              load_query_file,
                                              predict_protein_function)
from metagenomic_deepfri_tpu.utils import generate_config_json

MODES = ["bp", "cc", "mf", "ec"]
N_LABELS = 6
GOTERMS = [f"GO:000000{i}" for i in range(N_LABELS)]
GONAMES = [f"term {i}" for i in range(N_LABELS)]

GCN_CFG = GCNConfig(n_labels=N_LABELS, lm_hidden=8, lm_layers=2,
                    embed_dim=16, gc_dims=(8, 12), fc_dims=(16,),
                    adj_norm="none")
CNN_CFG = CNNConfig(n_labels=N_LABELS, conv_filters=8, conv_kernels=(3, 5),
                    fc_dims=(16,))


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("weights")
    key = jax.random.PRNGKey(0)
    for i, mode in enumerate(MODES):
        k1, k2, key = jax.random.split(key, 3)
        gcn_name = (f"DeepFRI-MERGED_GraphConv_gcd_8-12_fcd_16_ca_10.0_"
                    f"{mode}.onnx")
        cnn_name = f"DeepCNN-MERGED_{mode}.onnx"
        export_gcn_to_onnx(init_gcn(k1, GCN_CFG), GCN_CFG,
                           str(path / gcn_name))
        export_cnn_to_onnx(init_cnn(k2, CNN_CFG), CNN_CFG,
                           str(path / cnn_name))
        for name in (gcn_name, cnn_name):
            params_json = path / (name[:-5] + "_model_params.json")
            with open(params_json, "w") as f:
                json.dump({"goterms": GOTERMS, "gonames": GONAMES}, f)
    generate_config_json(path, "1.0")
    return path


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    rng = np.random.default_rng(42)
    aas = list("ACDEFGHIKLMNPQRSTVWY")
    path = tmp_path_factory.mktemp("data")

    def rand_seq(n):
        return "".join(rng.choice(aas, size=n))

    queries = {
        "query_hit_1": rand_seq(80),
        "query_hit_2": rand_seq(120),
        "query_nohit": rand_seq(60),
        "query_seleno": "MKVU" + rand_seq(40),  # dropped (selenocysteine)
    }

    def mutate(seq, n):
        out = list(seq)
        for pos in rng.choice(len(seq), size=n, replace=False):
            out[pos] = rng.choice(aas)
        return "".join(out)

    targets = {
        "target_1": mutate(queries["query_hit_1"], 3),
        "target_2": mutate(queries["query_hit_2"], 4),
    }
    targets.update({f"decoy{i}": rand_seq(100) for i in range(10)})

    write_fasta(path / "queries.faa", queries)
    write_fasta(path / "targets.fasta", targets)
    return path, queries, targets


def _fake_extract_calpha_coords(db, target_ids, query_ids, targets,
                                save_directory=None, threads=1):
    rng = np.random.default_rng(7)
    coords = []
    for tid in target_ids:
        L = len(targets[tid])
        steps = rng.normal(size=(L, 3)).astype(np.float32)
        steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
        coords.append(np.cumsum(3.8 * steps, axis=0).astype(np.float32))
    return coords


def test_full_pipeline(weights_dir, data_dir, tmp_path, monkeypatch):
    path, queries, targets = data_dir
    out = tmp_path / "results"

    qf = load_query_file(path / "queries.faa")
    assert "query_seleno" not in qf.sequences

    dbs = hierarchical_database_search(
        query_file=qf,
        output_path=out / "database_search",
        databases=[path / "targets.fasta"],
        skip_pdb=True,
        max_eval=1e-3,
        threads=2)
    assert len(dbs) == 1
    assert dbs[0].mmseqs_result.exists()

    import metagenomic_deepfri_tpu.pipeline as pipeline_mod

    monkeypatch.setattr(
        pipeline_mod, "extract_calpha_coords",
        lambda db, tids, qids, save_directory=None, threads=1:
        _fake_extract_calpha_coords(db, tids, qids, targets,
                                    save_directory, threads))

    qf2 = load_query_file(path / "queries.faa")
    predict_protein_function(
        query_file=qf2,
        databases=tuple(dbs),
        weights=weights_dir,
        output_path=out,
        deepfri_processing_modes=["mf", "bp"],
        threads=2,
        save_cmaps=True,
        scoring_matrix="BLOSUM62")

    # ---- alignment summary ----
    summary = (out / "alignment_summary.tsv").read_text().strip().split("\n")
    assert summary[0].split("\t") == ALIGNMENT_HEADER
    rows = {r.split("\t")[0]: r.split("\t") for r in summary[1:]}
    assert rows["query_hit_1"][1] == "True"
    assert rows["query_hit_1"][2] == "target_1"
    assert rows["query_nohit"][1] == "False"

    # ---- saved contact maps ----
    assert (out / "contact_maps" / "query_hit_1.npy").exists()
    cmap = np.load(out / "contact_maps" / "query_hit_1.npy")
    assert cmap.shape[0] == cmap.shape[1]

    # ---- prediction matrices ----
    for mode in ("mf", "bp"):
        matrix = (out / f"prediction_matrix_{mode}.tsv").read_text()
        lines = matrix.strip().split("\n")
        assert lines[0].split("\t") == ["protein", "network_type"] + GOTERMS
        nets = {ln.split("\t")[0]: ln.split("\t")[1] for ln in lines[1:]}
        assert nets["query_hit_1"] == "gcn"
        assert nets["query_nohit"] == "cnn"

    # ---- final results ----
    results = (out / "results.tsv").read_text().strip().split("\n")
    assert results[0].split("\t") == FINAL_OUTPUT_HEADER
    body = [r.split("\t") for r in results[1:]]
    assert body, "results.tsv must not be empty"
    # every score above threshold, 4-decimal formatted
    for row in body:
        assert float(row[4]) >= 0.1
        assert row[2] in ("GO Molecular Function", "GO Biological Process")
    # aligned info propagated into final rows for hit queries
    hit_rows = [r for r in body if r[0] == "query_hit_1"]
    if hit_rows:
        assert hit_rows[0][6] == "True"
        assert hit_rows[0][7] == "target_1"


def test_ec_dropped_for_v11(weights_dir, tmp_path):
    from metagenomic_deepfri_tpu.pipeline import _initialize_processing_modes

    modes = _initialize_processing_modes(["mf", "ec"], {"version": "1.1"})
    assert modes == ["mf"]
    with pytest.raises(ValueError):
        _initialize_processing_modes(["ec"], {"version": "1.1"})


def test_crash_resume_from_checkpoint(weights_dir, data_dir, tmp_path,
                                      monkeypatch, caplog):
    """A run killed after inference resumes from the streaming checkpoint:
    the rerun skips completed queries and produces a complete results.tsv."""
    import logging

    import metagenomic_deepfri_tpu.pipeline as pipeline_mod
    from metagenomic_deepfri_tpu.batching.engine import BatchedPredictor

    path, queries, targets = data_dir
    out = tmp_path / "results"

    qf = load_query_file(path / "queries.faa")
    dbs = hierarchical_database_search(
        query_file=qf, output_path=out / "database_search",
        databases=[path / "targets.fasta"], skip_pdb=True,
        max_eval=1e-3, threads=2)
    monkeypatch.setattr(
        pipeline_mod, "extract_calpha_coords",
        lambda db, tids, qids, save_directory=None, threads=1:
        _fake_extract_calpha_coords(db, tids, qids, targets,
                                    save_directory, threads))

    # crash AFTER CNN scores are computed and checkpointed, BEFORE results
    real_cnn = BatchedPredictor.predict_cnn

    def crashing_cnn(self, items, modes=None, progress_cb=None,
                     result_cb=None, **kw):
        real_cnn(self, items, modes=modes, progress_cb=progress_cb,
                 result_cb=result_cb, **kw)
        raise RuntimeError("simulated crash after inference")

    monkeypatch.setattr(BatchedPredictor, "predict_cnn", crashing_cnn)
    qf2 = load_query_file(path / "queries.faa")
    with pytest.raises(RuntimeError, match="simulated crash"):
        predict_protein_function(
            query_file=qf2, databases=tuple(dbs), weights=weights_dir,
            output_path=out, deepfri_processing_modes=["mf"], threads=2)
    assert (out / "checkpoints").exists()
    assert list((out / "checkpoints").glob("part-*.npz"))

    # rerun without the crash: must resume and complete
    monkeypatch.setattr(BatchedPredictor, "predict_cnn", real_cnn)
    caplog.set_level(logging.INFO)
    qf3 = load_query_file(path / "queries.faa")
    predict_protein_function(
        query_file=qf3, databases=tuple(dbs), weights=weights_dir,
        output_path=out, deepfri_processing_modes=["mf"], threads=2)
    assert "Checkpoint resume" in caplog.text
    assert (out / "results.tsv").exists()
    assert not (out / "checkpoints").exists()
    with open(out / "results.tsv") as f:
        rows = f.read().strip().splitlines()
    assert rows[0].split("\t") == FINAL_OUTPUT_HEADER
    assert len(rows) > 1


def test_structure_dir_database_end_to_end(weights_dir, tmp_path):
    """Full pipeline over a directory of real on-disk PDB files — NO mocks:
    search → NW alignment → coords from files → GCN batched inference."""
    from metagenomic_deepfri_tpu.data.structures import write_ca_pdb

    rng = np.random.default_rng(11)
    aas = list("ACDEFGHIKLMNPQRSTVWY")

    def rand_seq(n):
        return "".join(rng.choice(aas, size=n))

    def walk(n):
        steps = rng.normal(size=(n, 3)).astype(np.float32)
        steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
        return np.cumsum(3.8 * steps, axis=0).astype(np.float32)

    structures = tmp_path / "structures"
    structures.mkdir()
    seqs = {}
    for i in range(6):
        sid = f"af_{i}"
        seqs[sid] = rand_seq(70 + 10 * i)
        write_ca_pdb(structures / f"{sid}.pdb", seqs[sid], walk(len(seqs[sid])))

    # queries: two near-copies of structures (hits), one random (no hit)
    def mutate(seq, n):
        out = list(seq)
        for pos in rng.choice(len(seq), size=n, replace=False):
            out[pos] = rng.choice(aas)
        return "".join(out)

    queries = {"q_hit_a": mutate(seqs["af_0"], 3),
               "q_hit_b": mutate(seqs["af_3"], 4),
               "q_nohit": rand_seq(50)}
    write_fasta(tmp_path / "queries.faa", queries)

    out = tmp_path / "results"
    qf = load_query_file(tmp_path / "queries.faa")
    dbs = hierarchical_database_search(
        query_file=qf,
        output_path=out / "database_search",
        databases=[structures],
        skip_pdb=True,
        max_eval=1e-3,
        threads=2)
    assert len(dbs) == 1

    # mini GO DAG over the fixture vocabulary: term 1 is_a 5, 2 part_of 5
    obo = tmp_path / "go-mini.obo"
    obo.write_text("\n".join([
        "format-version: 1.2", "",
        "[Term]", "id: GO:0000001", "name: child one",
        "is_a: GO:0000005 ! parent", "",
        "[Term]", "id: GO:0000002", "name: child two",
        "relationship: part_of GO:0000005 ! parent", "",
        "[Term]", "id: GO:0000005", "name: parent", "",
    ]) + "\n")

    qf2 = load_query_file(tmp_path / "queries.faa")
    predict_protein_function(
        query_file=qf2,
        databases=tuple(dbs),
        weights=weights_dir,
        output_path=out,
        deepfri_processing_modes=["mf"],
        threads=2,
        propagate_go_terms=True,
        obo_path=obo)

    propagated = (out / "results_propagated.tsv").read_text().strip()
    plines = propagated.split("\n")
    assert plines[0].split("\t")[-1] == "propagated"
    assert len(plines) > 1

    summary = (out / "alignment_summary.tsv").read_text().strip().split("\n")
    rows = {r.split("\t")[0]: r.split("\t") for r in summary[1:]}
    assert rows["q_hit_a"][1] == "True"
    assert rows["q_hit_a"][2] == "af_0"
    assert rows["q_hit_b"][2] == "af_3"
    assert rows["q_nohit"][1] == "False"

    matrix = (out / "prediction_matrix_mf.tsv").read_text().strip().split("\n")
    nets = {ln.split("\t")[0]: ln.split("\t")[1] for ln in matrix[1:]}
    assert nets["q_hit_a"] == "gcn"
    assert nets["q_nohit"] == "cnn"


def test_sharded_pipeline_merge_equals_unsharded(weights_dir, tmp_path):
    """Multi-host input sharding end-to-end: running the pipeline as two
    `--shard I/2` halves and merging (`merge-results`) yields the same
    results.tsv rows as one unsharded run — the north-star 1M+ multi-host
    recipe, exercised on the real pipeline at toy scale."""
    from metagenomic_deepfri_tpu.data.structures import write_ca_pdb
    from metagenomic_deepfri_tpu.parallel.multihost import \
        merge_shard_results

    rng = np.random.default_rng(23)
    aas = list("ACDEFGHIKLMNPQRSTVWY")

    def rand_seq(n):
        return "".join(rng.choice(aas, size=n))

    def walk(n):
        steps = rng.normal(size=(n, 3)).astype(np.float32)
        steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
        return np.cumsum(3.8 * steps, axis=0).astype(np.float32)

    structures = tmp_path / "structures"
    structures.mkdir()
    seqs = {}
    for i in range(5):
        sid = f"af_{i}"
        seqs[sid] = rand_seq(60 + 8 * i)
        write_ca_pdb(structures / f"{sid}.pdb", seqs[sid],
                     walk(len(seqs[sid])))

    def mutate(seq, n):
        out = list(seq)
        for pos in rng.choice(len(seq), size=n, replace=False):
            out[pos] = rng.choice(aas)
        return "".join(out)

    queries = {f"q{i}": mutate(seqs[f"af_{i % 5}"], 3) for i in range(6)}
    queries["q_nohit"] = rand_seq(48)
    qpath = tmp_path / "queries.faa"
    write_fasta(qpath, queries)

    def run(outdir, shard=None):
        qf = load_query_file(qpath, shard=shard)
        dbs = hierarchical_database_search(
            query_file=qf, output_path=outdir / "database_search",
            databases=[structures], skip_pdb=True, max_eval=1e-3,
            threads=2)
        qf2 = load_query_file(qpath, shard=shard)
        predict_protein_function(
            query_file=qf2, databases=tuple(dbs), weights=weights_dir,
            output_path=outdir, deepfri_processing_modes=["mf"],
            skip_matrix=True, threads=2)
        return outdir

    full = run(tmp_path / "full")
    s0 = run(tmp_path / "shard0", shard="0/2")
    s1 = run(tmp_path / "shard1", shard="1/2")
    merged_dir = tmp_path / "merged"
    merge_shard_results([s0, s1], merged_dir)

    def rows(d):
        lines = (d / "results.tsv").read_text().strip().split("\n")
        return lines[0], sorted(lines[1:])

    hdr_full, rows_full = rows(full)
    hdr_merged, rows_merged = rows(merged_dir)
    assert hdr_full == hdr_merged
    assert rows_full == rows_merged
    assert rows_full  # non-trivial comparison
    # shards partitioned the queries without overlap or loss
    ids0 = {ln.split("\t")[0]
            for ln in (s0 / "results.tsv").read_text().strip().split("\n")[1:]}
    ids1 = {ln.split("\t")[0]
            for ln in (s1 / "results.tsv").read_text().strip().split("\n")[1:]}
    assert not (ids0 & ids1)


def test_blocklist_loader(tmp_path, monkeypatch):
    """Blocklist pickle (reference assets/highquality_clust30_error_ids.pkl,
    filtered at reference pipeline.py:432-444): env override, package asset
    lookup, and absent-file behaviour."""
    import pickle

    from metagenomic_deepfri_tpu import pipeline as pl

    ids = ["AF-Q8WZ42-F1-model_v4.pdb", "AF-P12345-F1-model_v4.pdb"]
    blk = tmp_path / "blk.pkl"
    blk.write_bytes(pickle.dumps(ids))

    monkeypatch.setenv("MDEEPFRI_BLOCKLIST", str(blk))
    assert pl._load_blocklist("any_db") == set(ids)

    monkeypatch.delenv("MDEEPFRI_BLOCKLIST")
    assert pl._load_blocklist("no_such_db") == set()

    # Package-relative asset path: <pkg>/assets/{db}_error_ids.pkl.
    asset_dir = Path(pl.__file__).parent / "assets"
    asset_dir.mkdir(exist_ok=True)
    asset = asset_dir / "unit_test_db_error_ids.pkl"
    try:
        asset.write_bytes(pickle.dumps({"bad_entry.fcz"}))
        assert pl._load_blocklist("unit_test_db") == {"bad_entry.fcz"}
    finally:
        asset.unlink()


def test_shipped_highquality_clust30_blocklist():
    """The highquality_clust30 blocklist ships IN the package (the reference
    bundles the same 27,675-ID set as a pickle; we ship a gzipped ID list):
    a real run gets foldcomp-segfault protection with zero configuration."""
    from metagenomic_deepfri_tpu import pipeline as pl

    blocklist = pl._load_blocklist("highquality_clust30")
    assert len(blocklist) == 27675
    assert "MGYP000008650329" in blocklist
    assert all(i.startswith("MGYP") for i in list(blocklist)[:100])


def test_skip_matrix_topk_results_identical(tmp_path):
    """--skip-matrix enables the engine's top-k score fetch; results.tsv
    must be byte-identical to the dense run. Uses a >2·K vocabulary with
    UNCALIBRATED random heads (~half of all terms ≥ 0.1) so every protein
    overflows the top-k window and the dense re-run path is exercised."""
    import dataclasses

    from metagenomic_deepfri_tpu.data.structures import write_ca_pdb
    from metagenomic_deepfri_tpu.models.deepfri import (CNNConfig, GCNConfig,
                                                        init_cnn, init_gcn)
    from metagenomic_deepfri_tpu.models.onnx_import import (
        export_cnn_to_onnx, export_gcn_to_onnx)
    from metagenomic_deepfri_tpu.utils import generate_config_json

    n_labels = 600  # > 2 * score_topk(256) → compaction engages
    gcn_cfg = GCNConfig(n_labels=n_labels, lm_hidden=8, lm_layers=1,
                        embed_dim=16, gc_dims=(8, 12), fc_dims=(16,))
    cnn_cfg = CNNConfig(n_labels=n_labels, conv_filters=8, conv_kernels=(3,),
                        fc_dims=(16,))
    weights = tmp_path / "weights"
    weights.mkdir()
    key = jax.random.PRNGKey(9)
    terms = [f"GO:{i:07d}" for i in range(n_labels)]
    names = [f"t{i}" for i in range(n_labels)]
    for mode in MODES:
        k1, k2, key = jax.random.split(key, 3)
        gcn_name = (f"DeepFRI-MERGED_GraphConv_gcd_8-12_fcd_16_ca_10.0_"
                    f"{mode}.onnx")
        cnn_name = f"DeepCNN-MERGED_{mode}.onnx"
        export_gcn_to_onnx(init_gcn(k1, gcn_cfg), gcn_cfg,
                           str(weights / gcn_name))
        export_cnn_to_onnx(init_cnn(k2, cnn_cfg), cnn_cfg,
                           str(weights / cnn_name))
        for name in (gcn_name, cnn_name):
            with open(weights / (name[:-5] + "_model_params.json"),
                      "w") as f:
                json.dump({"goterms": terms, "gonames": names}, f)
    generate_config_json(weights, "1.0")

    rng = np.random.default_rng(33)
    aas = list("ACDEFGHIKLMNPQRSTVWY")
    structures = tmp_path / "structures"
    structures.mkdir()
    seqs = {}
    for i in range(3):
        sid = f"af_{i}"
        seqs[sid] = "".join(rng.choice(aas, size=60 + 10 * i))
        steps = rng.normal(size=(len(seqs[sid]), 3)).astype(np.float32)
        steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
        write_ca_pdb(structures / f"{sid}.pdb", seqs[sid],
                     np.cumsum(3.8 * steps, axis=0).astype(np.float32))

    def mutate(seq, n):
        out = list(seq)
        for pos in rng.choice(len(seq), size=n, replace=False):
            out[pos] = rng.choice(aas)
        return "".join(out)

    queries = {"q_hit": mutate(seqs["af_0"], 3),
               "q_nohit": "".join(rng.choice(aas, size=45))}
    write_fasta(tmp_path / "queries.faa", queries)

    results = {}
    for label, skip in (("dense", False), ("topk", True)):
        out = tmp_path / f"run_{label}"
        qf = load_query_file(tmp_path / "queries.faa")
        dbs = hierarchical_database_search(
            query_file=qf, output_path=out / "database_search",
            databases=[structures], skip_pdb=True, max_eval=1e-3, threads=2)
        qf2 = load_query_file(tmp_path / "queries.faa")
        predict_protein_function(
            query_file=qf2, databases=tuple(dbs), weights=weights,
            output_path=out, deepfri_processing_modes=["mf"],
            skip_matrix=skip, threads=2)
        results[label] = (out / "results.tsv").read_text()
    assert results["topk"] == results["dense"]
    # sanity: the run actually produced annotations
    assert len(results["dense"].strip().split("\n")) > 3


def test_progress_log_lines(caplog, monkeypatch):
    """The inference progress report: periodic logger lines with the count,
    the total when known and a rate, plus a final line on close."""
    import logging
    from types import SimpleNamespace

    from metagenomic_deepfri_tpu import pipeline

    clock = iter([0.0, 1.0, 3.0, 11.0, 12.0])
    monkeypatch.setattr(pipeline, "time",
                        SimpleNamespace(monotonic=lambda: next(clock)))
    with caplog.at_level(logging.INFO, logger=pipeline.logger.name):
        bar = pipeline.ProgressLog("Predicting (CNN)", total=30,
                                   interval_s=10.0)   # t=0
        bar.update(10)                                # t=1: quiet
        bar.update(5)                                 # t=3: quiet
        bar.update(10)                                # t=11: logs
        bar.close()                                   # t=12: logs
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("Predicting (CNN)")]
    assert lines == ["Predicting (CNN): 25/30 [2.3/s]",
                     "Predicting (CNN): 25/30 [2.1/s]"]
