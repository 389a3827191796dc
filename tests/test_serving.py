"""Annotation-server tests: in-memory annotate() and the socket transport."""

import json
import threading
from pathlib import Path

import numpy as np
import pytest

import jax

from metagenomic_deepfri_tpu.data.fasta import write_fasta
from metagenomic_deepfri_tpu.data.structures import write_ca_pdb
from metagenomic_deepfri_tpu.models.deepfri import (CNNConfig, GCNConfig,
                                                    init_cnn, init_gcn)
from metagenomic_deepfri_tpu.models.onnx_import import (export_cnn_to_onnx,
                                                        export_gcn_to_onnx)
from metagenomic_deepfri_tpu.utils import generate_config_json

N_LABELS = 6
GOTERMS = [f"GO:000000{i}" for i in range(N_LABELS)]
GCN_CFG = GCNConfig(n_labels=N_LABELS, lm_hidden=8, lm_layers=1,
                    embed_dim=16, gc_dims=(8,), fc_dims=(16,),
                    adj_norm="none")
CNN_CFG = CNNConfig(n_labels=N_LABELS, conv_filters=8, conv_kernels=(3,),
                    fc_dims=(16,))

RNG = np.random.default_rng(3)
AAS = list("ACDEFGHIKLMNPQRSTVWY")


def _rand_seq(n):
    return "".join(RNG.choice(AAS, size=n))


def _walk(n):
    steps = RNG.normal(size=(n, 3)).astype(np.float32)
    steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
    return np.cumsum(3.8 * steps, axis=0).astype(np.float32)


def _mutate(seq, n):
    out = list(seq)
    for pos in RNG.choice(len(seq), size=n, replace=False):
        out[pos] = RNG.choice(AAS)
    return "".join(out)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from metagenomic_deepfri_tpu.serving import AnnotationServer

    root = tmp_path_factory.mktemp("serving")
    weights = root / "weights"
    weights.mkdir()
    key = jax.random.PRNGKey(0)
    for mode in ("mf", "bp", "cc", "ec"):
        k1, k2, key = jax.random.split(key, 3)
        gname = f"DeepFRI-MERGED_GraphConv_gcd_8_fcd_16_ca_10.0_{mode}.onnx"
        cname = f"DeepCNN-MERGED_{mode}.onnx"
        export_gcn_to_onnx(init_gcn(k1, GCN_CFG), GCN_CFG,
                           str(weights / gname))
        export_cnn_to_onnx(init_cnn(k2, CNN_CFG), CNN_CFG,
                           str(weights / cname))
        for name in (gname, cname):
            with open(weights / (name[:-5] + "_model_params.json"), "w") as f:
                json.dump({"goterms": GOTERMS,
                           "gonames": [f"t{i}" for i in range(N_LABELS)]}, f)
    generate_config_json(weights, "1.0")

    structures = root / "structures"
    structures.mkdir()
    seqs = {}
    for i in range(4):
        sid = f"af_{i}"
        seqs[sid] = _rand_seq(60 + 10 * i)
        write_ca_pdb(structures / f"{sid}.pdb", seqs[sid],
                     _walk(len(seqs[sid])))

    srv = AnnotationServer(weights, databases=[structures],
                           processing_modes=["mf", "bp"], threads=2)
    return srv, seqs


class TestAnnotate:
    def test_hit_and_fallback(self, server):
        srv, seqs = server
        out = srv.annotate({
            "q_hit": _mutate(seqs["af_1"], 3),
            "q_nohit": _rand_seq(45),
            "q_sec": "MKVU" + _rand_seq(30),
        })
        res = out["results"]
        assert out["skipped"] == {"q_sec": "selenocysteine"}
        assert res["q_hit"]["aligned"] is True
        assert res["q_hit"]["target"] == "af_1"
        assert res["q_hit"]["network"] == "gcn"
        assert res["q_hit"]["identity"] > 0.9
        assert res["q_nohit"]["aligned"] is False
        assert res["q_nohit"]["network"] == "cnn"
        for entry in res.values():
            for mode, rows in entry["scores"].items():
                assert mode in ("mf", "bp")
                for term, score, _name in rows:
                    assert term in GOTERMS
                    assert 0.1 <= score <= 1.0
                scores = [s for _, s, _ in rows]
                assert scores == sorted(scores, reverse=True)

    def test_go_propagation_in_response(self, server, tmp_path):
        """With a GO DAG loaded, responses carry propagated ancestors
        (true-path rule, same semantics as results_propagated.tsv)."""
        from metagenomic_deepfri_tpu.ontology.go import GoDag

        obo = tmp_path / "go.obo"
        # every vocabulary term is_a one shared parent outside the vocab
        stanzas = ["format-version: 1.2\n"]
        for t in GOTERMS:
            stanzas.append(f"[Term]\nid: {t}\nname: leaf {t}\n"
                           "is_a: GO:0000090 ! shared parent\n")
        stanzas.append("[Term]\nid: GO:0000090\nname: shared parent\n")
        obo.write_text("\n".join(stanzas))

        srv, seqs = server
        srv._godag = GoDag.from_obo(obo)
        srv._go_anc_cache = {}
        try:
            out = srv.annotate({"qp": _mutate(seqs["af_1"], 3)})
            entry = out["results"]["qp"]
            assert "propagated_scores" in entry
            for mode, rows in entry["scores"].items():
                prop = entry["propagated_scores"][mode]
                if not rows:
                    assert prop == []
                    continue
                # the shared parent inherits the best leaf score
                assert prop, f"no propagated terms for {mode}"
                terms = {t for t, _, _ in prop}
                assert "GO:0000090" in terms
                best = max(s for _, s, _ in rows)
                by_term = {t: s for t, s, _ in prop}
                assert by_term["GO:0000090"] == pytest.approx(best,
                                                             abs=1e-4)
                # propagated list never repeats an original term
                assert not terms & {t for t, _, _ in rows}
        finally:
            srv._godag = None

    def test_coord_cache_reuse(self, server):
        srv, seqs = server
        before = len(srv._coords._data)
        srv.annotate({"q": _mutate(seqs["af_2"], 2)})
        mid = len(srv._coords._data)
        srv.annotate({"q2": _mutate(seqs["af_2"], 3)})
        after = len(srv._coords._data)
        assert mid >= before
        assert after == mid  # second request reuses the cached coords

    def test_matches_batch_pipeline_scores(self, server):
        """Server scores equal the engine's batch-API scores for a hit."""
        srv, seqs = server
        q = _mutate(seqs["af_0"], 2)
        out = srv.annotate({"qx": q})["results"]["qx"]
        assert out["aligned"]
        # recompute through the standalone components
        from metagenomic_deepfri_tpu.align.pairwise import \
            pairwise_against_database
        from metagenomic_deepfri_tpu.bio_utils import build_align_projection

        targets = srv._targets[srv.databases[0].name]
        aln = pairwise_against_database("qx", q, {out["target"]:
                                                  targets[out["target"]]})
        aln.coords = srv._coords.get_many(srv.databases[0],
                                          [(out["target"], "qx")])[
                                              out["target"]]
        aln, proj = build_align_projection(aln)
        scores = srv.engine.predict_gcn_from_coords(
            [("qx", aln.query_sequence, proj[0], proj[1])], modes=["mf"])
        vec = scores["mf"]["qx"]
        served = dict((t, s) for t, s, _ in out["scores"]["mf"])
        for i, term in enumerate(GOTERMS):
            if float(vec[i]) >= 0.1:
                assert abs(served[term] - float(vec[i])) < 1e-3


class TestSocket:
    def test_unix_socket_roundtrip(self, server, tmp_path):
        from metagenomic_deepfri_tpu.serving import annotate_over_socket

        srv, seqs = server
        sock = tmp_path / "ann.sock"
        ready = threading.Event()
        t = threading.Thread(target=srv.serve_unix, args=(sock, ready),
                             daemon=True)
        t.start()
        assert ready.wait(10)
        try:
            out = annotate_over_socket(
                sock, {"q": _mutate(seqs["af_3"], 3)}, timeout=120)
            assert out["results"]["q"]["aligned"] is True
            assert out["results"]["q"]["target"] == "af_3"
        finally:
            srv.shutdown()
            t.join(timeout=10)


class TestSequenceOnlyServer:
    def test_no_database_cnn_only(self, tmp_path):
        """A server with no databases serves CNN-only annotations."""
        import json as _json

        from metagenomic_deepfri_tpu.serving import AnnotationServer

        import jax as _jax

        w = tmp_path / "w"
        w.mkdir()
        name = "DeepFRI-MERGED_GraphConv_gcd_8_fcd_16_ca_10.0_mf.onnx"
        cname = "DeepCNN-MERGED_mf.onnx"
        export_gcn_to_onnx(init_gcn(_jax.random.PRNGKey(5), GCN_CFG),
                           GCN_CFG, str(w / name))
        export_cnn_to_onnx(init_cnn(_jax.random.PRNGKey(6), CNN_CFG),
                           CNN_CFG, str(w / cname))
        for n in (name, cname):
            with open(w / (n[:-5] + "_model_params.json"), "w") as f:
                _json.dump({"goterms": GOTERMS,
                            "gonames": ["x"] * N_LABELS}, f)
        with open(w / "model_config.json", "w") as f:
            _json.dump({"gcn": {"mf": str(w / name)},
                        "cnn": {"mf": str(w / cname)},
                        "version": "1.0"}, f)
        srv2 = AnnotationServer(w, databases=[], processing_modes=["mf"])
        out = srv2.annotate({"q": _rand_seq(40)})
        assert out["results"]["q"]["aligned"] is False
        assert out["results"]["q"]["network"] == "cnn"
        assert "mf" in out["results"]["q"]["scores"]


class TestMicroBatching:
    def test_coalesced_requests_split_correctly(self, server):
        """Queued concurrent requests merge into one annotate() pass and
        split back per request, id collisions included."""
        import concurrent.futures as cf

        srv, seqs = server
        reqs = [
            {"q": _mutate(seqs["af_0"], 2), "extra": _rand_seq(40)},
            {"q": _rand_seq(42)},             # same id, different protein
            {"s": "MKVU" + _rand_seq(20)},    # selenocysteine skip
        ]
        futs = [cf.Future() for _ in reqs]
        for r, f in zip(reqs, futs):
            srv._req_q.put((r, f))
        n = srv._drain_once(first_timeout=1.0)
        assert n == 3
        r0, r1, r2 = (f.result(timeout=5) for f in futs)
        assert r0["results"]["q"]["aligned"] is True
        assert r0["results"]["q"]["target"] == "af_0"
        assert r0["results"]["extra"]["network"] == "cnn"
        assert r1["results"]["q"]["aligned"] is False
        assert set(r1["results"]) == {"q"}
        assert r2["skipped"] == {"s": "selenocysteine"}
        assert r2["results"] == {}

    def test_submit_single(self, server):
        srv, seqs = server
        out = srv.submit({"solo": _mutate(seqs["af_1"], 2)}, timeout=120)
        assert out["results"]["solo"]["target"] == "af_1"


class TestScoreTopKServer:
    def test_topk_server_response_identical(self, tmp_path):
        """A score_topk server returns the exact same annotations as a dense
        one — including via the dense overflow re-run (random heads put
        ~half of a 600-term vocabulary above the threshold)."""
        import dataclasses

        from metagenomic_deepfri_tpu.serving import AnnotationServer

        n_labels = 600  # > 2 * 256 → compaction engages
        gcn_cfg = dataclasses.replace(GCN_CFG, n_labels=n_labels)
        cnn_cfg = dataclasses.replace(CNN_CFG, n_labels=n_labels)
        weights = tmp_path / "weights"
        weights.mkdir()
        key = jax.random.PRNGKey(8)
        terms = [f"GO:{i:07d}" for i in range(n_labels)]
        for mode in ("mf", "bp", "cc", "ec"):
            k1, k2, key = jax.random.split(key, 3)
            gname = (f"DeepFRI-MERGED_GraphConv_gcd_8_fcd_16_ca_10.0_"
                     f"{mode}.onnx")
            cname = f"DeepCNN-MERGED_{mode}.onnx"
            export_gcn_to_onnx(init_gcn(k1, gcn_cfg), gcn_cfg,
                               str(weights / gname))
            export_cnn_to_onnx(init_cnn(k2, cnn_cfg), cnn_cfg,
                               str(weights / cname))
            for name in (gname, cname):
                with open(weights / (name[:-5] + "_model_params.json"),
                          "w") as f:
                    json.dump({"goterms": terms,
                               "gonames": [f"t{i}"
                                           for i in range(n_labels)]}, f)
        generate_config_json(weights, "1.0")

        structures = tmp_path / "structures"
        structures.mkdir()
        base = _rand_seq(70)
        write_ca_pdb(structures / "af_x.pdb", base, _walk(len(base)))

        queries = {"q_hit": _mutate(base, 2), "q_nohit": _rand_seq(45)}
        dense_srv = AnnotationServer(weights, databases=[structures],
                                     processing_modes=["mf"], threads=2)
        topk_srv = AnnotationServer(weights, databases=[structures],
                                    processing_modes=["mf"], threads=2,
                                    score_topk=256)
        ref = dense_srv.annotate(dict(queries))
        got = topk_srv.annotate(dict(queries))
        assert got == ref
        # sanity: annotations actually present and the overflow regime hit
        assert len(ref["results"]["q_hit"]["scores"]["mf"]) > 256
