"""Batched engine tests: bucketed batch results must equal per-protein runs."""

import numpy as np

import jax

from metagenomic_deepfri_tpu.batching.buckets import (assign_bucket,
                                                      bucket_plan,
                                                      gcn_batch_size)
from metagenomic_deepfri_tpu.batching.engine import (BatchedPredictor,
                                                     ModelHandle)
from metagenomic_deepfri_tpu.models.deepfri import (CNNConfig, GCNConfig,
                                                    forward_pass_single,
                                                    init_cnn, init_gcn)
from metagenomic_deepfri_tpu.ops.contact import calculate_contact_map

GCN_CFG = GCNConfig(n_labels=4, lm_hidden=8, lm_layers=1, embed_dim=16,
                    gc_dims=(8, 8), fc_dims=(16,), adj_norm="none")
CNN_CFG = CNNConfig(n_labels=3, conv_filters=8, conv_kernels=(3,),
                    fc_dims=(16,))


def _mk_items(n, rng, min_len=5, max_len=200):
    items = []
    aas = "ACDEFGHIKLMNPQRSTVWY"
    for i in range(n):
        L = int(rng.integers(min_len, max_len))
        seq = "".join(rng.choice(list(aas), size=L))
        coords = (rng.normal(size=(L, 3)) * 6).astype(np.float32)
        cmap = calculate_contact_map(coords, threshold=6.0)
        items.append((f"q{i}", seq, cmap))
    return items


class TestBuckets:
    def test_assign(self):
        assert assign_bucket(5) == 128
        assert assign_bucket(128) == 128
        assert assign_bucket(129) == 256
        assert assign_bucket(2048) == 2048

    def test_plan(self):
        plan = bucket_plan([10, 300, 120, 600])
        assert plan == {128: [0, 2], 512: [1], 1024: [3]}

    def test_batch_size_constant_footprint(self):
        # the batch rule: B·L² ≤ 512M elements (2 GB per f32 adjacency
        # buffer), batch capped at 2048 (see buckets.py)
        for bucket in (128, 256, 512, 1024, 2048, 4096):
            b = gcn_batch_size(bucket)
            assert b * bucket ** 2 <= 512 * 1024 * 1024
            assert b <= 2048
        assert gcn_batch_size(1024) >= 512
        assert gcn_batch_size(2048) >= 120


class TestBatchedPredictor:
    def test_gcn_matches_single(self):
        rng = np.random.default_rng(11)
        params = init_gcn(jax.random.PRNGKey(0), GCN_CFG)
        handle = ModelHandle("gcn", "mf", GCN_CFG, params)
        engine = BatchedPredictor(gcn_models={"mf": handle}, batch_cap=4)
        items = _mk_items(7, rng)
        out = engine.predict_gcn(items)
        assert set(out["mf"]) == {f"q{i}" for i in range(7)}
        for qid, seq, cmap in items[:3]:
            single = np.asarray(forward_pass_single(
                params, GCN_CFG, seq, cmap.astype(np.float32)))
            np.testing.assert_allclose(out["mf"][qid], single,
                                       rtol=1e-4, atol=1e-5)

    def test_cnn_matches_single(self):
        rng = np.random.default_rng(12)
        params = init_cnn(jax.random.PRNGKey(1), CNN_CFG)
        handle = ModelHandle("cnn", "bp", CNN_CFG, params)
        engine = BatchedPredictor(cnn_models={"bp": handle}, batch_cap=4)
        items = [(qid, seq) for qid, seq, _ in _mk_items(5, rng)]
        out = engine.predict_cnn(items)
        for qid, seq in items[:2]:
            single = np.asarray(forward_pass_single(params, CNN_CFG, seq))
            np.testing.assert_allclose(out["bp"][qid], single,
                                       rtol=1e-4, atol=1e-5)

    def test_multi_mode_single_pass(self):
        rng = np.random.default_rng(13)
        handles = {}
        for mode, seed in (("mf", 2), ("bp", 3)):
            handles[mode] = ModelHandle(
                "gcn", mode, GCN_CFG, init_gcn(jax.random.PRNGKey(seed),
                                               GCN_CFG))
        engine = BatchedPredictor(gcn_models=handles, batch_cap=4)
        items = _mk_items(3, rng)
        out = engine.predict_gcn(items)
        assert set(out) == {"mf", "bp"}
        # different weights → different scores
        q = items[0][0]
        assert not np.allclose(out["mf"][q], out["bp"][q])

    def test_empty_items(self):
        engine = BatchedPredictor(gcn_models={}, cnn_models={})
        assert engine.predict_gcn([]) == {}
        assert engine.predict_cnn([]) == {}

    def test_gcn_from_coords_matches_dense(self):
        """Fused on-device adjacency path == dense-cmap path, bitwise inputs."""
        from metagenomic_deepfri_tpu.ops.cmap_align import (
            align_contact_map, project_alignment_coords)
        from metagenomic_deepfri_tpu.ops.contact import calculate_contact_map

        rng = np.random.default_rng(21)
        params = init_gcn(jax.random.PRNGKey(5), GCN_CFG)
        handle = ModelHandle("gcn", "mf", GCN_CFG, params)
        engine = BatchedPredictor(gcn_models={"mf": handle}, batch_cap=4)

        aas = "ACDEFGHIKLMNPQRSTVWY"
        dense_items, coords_items = [], []
        for i in range(6):
            L = int(rng.integers(20, 150))
            seq = "".join(rng.choice(list(aas), size=L))
            steps = rng.normal(size=(L, 3)).astype(np.float32)
            steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
            coords = np.cumsum(3.8 * steps, axis=0).astype(np.float32)
            aln = seq  # identity alignment (self-structure)
            sparse = calculate_contact_map(coords, threshold=6.0,
                                           mode="sparse")
            cmap = align_contact_map(aln, aln, sparse)
            proj, ins, qlen = project_alignment_coords(aln, aln, coords)
            assert qlen == L
            dense_items.append((f"q{i}", seq, cmap))
            coords_items.append((f"q{i}", seq, proj, ins))

        dense_out = engine.predict_gcn(dense_items)
        coords_out = engine.predict_gcn_from_coords(coords_items)
        for i in range(6):
            np.testing.assert_allclose(coords_out["mf"][f"q{i}"],
                                       dense_out["mf"][f"q{i}"],
                                       rtol=1e-5, atol=1e-6)

    def test_mesh_data_parallel_engine(self):
        """Engine with a mesh shards batches over 'data'; results match the
        single-device engine bitwise (same params, same packing)."""
        from metagenomic_deepfri_tpu.ops.cmap_align import \
            project_alignment_coords
        from metagenomic_deepfri_tpu.parallel import make_mesh

        rng = np.random.default_rng(31)
        params = init_gcn(jax.random.PRNGKey(8), GCN_CFG)
        handle = ModelHandle("gcn", "mf", GCN_CFG, params)
        mesh = make_mesh(n_devices=8, model_parallel=1)

        aas = "ACDEFGHIKLMNPQRSTVWY"
        items = []
        for i in range(19):
            L = int(rng.integers(20, 120))
            seq = "".join(rng.choice(list(aas), size=L))
            steps = rng.normal(size=(L, 3)).astype(np.float32)
            steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
            coords = np.cumsum(3.8 * steps, axis=0).astype(np.float32)
            proj, ins, _ = project_alignment_coords(seq, seq, coords)
            items.append((f"q{i}", seq, proj, ins))

        single = BatchedPredictor(gcn_models={"mf": handle})
        sharded = BatchedPredictor(gcn_models={"mf": handle}, mesh=mesh)
        ref = single.predict_gcn_from_coords(items)
        out = sharded.predict_gcn_from_coords(items)
        assert set(out["mf"]) == set(ref["mf"])
        for q in ref["mf"]:
            np.testing.assert_allclose(out["mf"][q], ref["mf"][q],
                                       rtol=1e-5, atol=1e-6)


class TestSharedTrunkMultiMode:
    """Multi-mode batches with a bitwise-shared LSTM-LM run the trunk once.

    The published DeepFRI models share one frozen pretrained LM across
    bp/cc/mf; the engine detects identical subtrees at load time and must
    produce results identical to per-mode dispatch.
    """

    LABELS = {"bp": 6, "cc": 3, "mf": 4}

    def _shared_handles(self, share_embeds=True, compute="float32"):
        import dataclasses
        handles = {}
        base = None
        for i, (mode, n_labels) in enumerate(self.LABELS.items()):
            cfg = dataclasses.replace(GCN_CFG, n_labels=n_labels,
                                      compute_dtype=compute)
            params = init_gcn(jax.random.PRNGKey(100 + i), cfg)
            if base is None:
                base = params
            else:
                params["lm"] = base["lm"]
                if share_embeds:
                    params["lm_embed"] = base["lm_embed"]
                    params["aa_embed"] = base["aa_embed"]
            handles[mode] = ModelHandle("gcn", mode, cfg, params)
        return handles

    def _coords_items(self, n, seed=60):
        from metagenomic_deepfri_tpu.ops.cmap_align import \
            project_alignment_coords

        rng = np.random.default_rng(seed)
        aas = "ACDEFGHIKLMNPQRSTVWY"
        items = []
        for i in range(n):
            L = int(rng.integers(20, 150))
            seq = "".join(rng.choice(list(aas), size=L))
            steps = rng.normal(size=(L, 3)).astype(np.float32)
            steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
            coords = np.cumsum(3.8 * steps, axis=0).astype(np.float32)
            proj, ins, _ = project_alignment_coords(seq, seq, coords)
            items.append((f"q{i}", seq, proj, ins))
        return items

    def test_sharing_detected(self):
        engine = BatchedPredictor(gcn_models=self._shared_handles())
        assert engine._gcn_shared is not None
        shared, per_mode, _ = engine._gcn_shared
        assert sorted(shared) == ["aa_embed", "lm", "lm_embed"]
        assert set(per_mode) == set(self.LABELS)
        assert all("lm" not in p for p in per_mode.values())

    def test_partial_sharing_lm_only(self):
        engine = BatchedPredictor(
            gcn_models=self._shared_handles(share_embeds=False))
        assert engine._gcn_shared is not None
        assert sorted(engine._gcn_shared[0]) == ["lm"]

    def test_no_sharing_different_lm(self):
        import dataclasses
        handles = {}
        for i, (mode, n_labels) in enumerate(self.LABELS.items()):
            cfg = dataclasses.replace(GCN_CFG, n_labels=n_labels)
            handles[mode] = ModelHandle(
                "gcn", mode, cfg, init_gcn(jax.random.PRNGKey(200 + i), cfg))
        assert BatchedPredictor(gcn_models=handles)._gcn_shared is None

    def test_no_sharing_on_config_mismatch(self):
        import dataclasses
        handles = self._shared_handles()
        bad_cfg = dataclasses.replace(handles["mf"].config, adj_norm="row")
        handles["mf"] = ModelHandle("gcn", "mf", bad_cfg,
                                    handles["mf"].params)
        assert BatchedPredictor(gcn_models=handles)._gcn_shared is None

    def _control(self, handles, **kw):
        """An engine identical in every way but with sharing disabled."""
        control = BatchedPredictor(gcn_models=handles, **kw)
        control._gcn_shared = None
        return control

    def test_coords_path_matches_per_mode(self):
        handles = self._shared_handles()
        engine = BatchedPredictor(gcn_models=handles, batch_cap=4)
        control = self._control(handles, batch_cap=4)
        items = self._coords_items(7)
        got = engine.predict_gcn_from_coords(items)
        ref = control.predict_gcn_from_coords(items)
        assert set(got) == set(self.LABELS)
        for mode in got:
            for q in ref[mode]:
                np.testing.assert_allclose(got[mode][q], ref[mode][q],
                                           rtol=1e-6, atol=1e-7)

    def test_partial_share_matches_per_mode(self):
        handles = self._shared_handles(share_embeds=False)
        engine = BatchedPredictor(gcn_models=handles, batch_cap=4)
        control = self._control(handles, batch_cap=4)
        items = self._coords_items(5, seed=61)
        got = engine.predict_gcn_from_coords(items)
        ref = control.predict_gcn_from_coords(items)
        for mode in got:
            for q in ref[mode]:
                np.testing.assert_allclose(got[mode][q], ref[mode][q],
                                           rtol=1e-6, atol=1e-7)

    def test_dense_path_matches_per_mode(self):
        rng = np.random.default_rng(62)
        handles = self._shared_handles()
        engine = BatchedPredictor(gcn_models=handles, batch_cap=4)
        control = self._control(handles, batch_cap=4)
        items = _mk_items(5, rng)
        got = engine.predict_gcn(items)
        ref = control.predict_gcn(items)
        for mode in got:
            for q in ref[mode]:
                np.testing.assert_allclose(got[mode][q], ref[mode][q],
                                           rtol=1e-6, atol=1e-7)

    def test_stream_matches_per_mode(self):
        handles = self._shared_handles()
        engine = BatchedPredictor(gcn_models=handles, batch_cap=4)
        control = self._control(handles, batch_cap=4)
        items = self._coords_items(9, seed=63)
        ref = control.predict_gcn_from_coords(items)
        got = {m: {} for m in self.LABELS}
        n = engine.predict_stream(
            iter(items), net="gcn_coords",
            result_cb=lambda part: [got[m].update(part[m]) for m in part])
        assert n == len(items)
        for mode in ref:
            for q in ref[mode]:
                np.testing.assert_allclose(got[mode][q], ref[mode][q],
                                           rtol=1e-6, atol=1e-7)

    def test_single_requested_mode_uses_per_mode_path(self):
        handles = self._shared_handles()
        engine = BatchedPredictor(gcn_models=handles, batch_cap=4)
        items = self._coords_items(3, seed=64)
        out = engine.predict_gcn_from_coords(items, modes=["mf"])
        assert set(out) == {"mf"}
        # no multi-mode program was compiled for a single mode
        assert not engine._gcn_multi_jit

    def test_mesh_multimode_matches_single_device(self):
        from metagenomic_deepfri_tpu.parallel import make_mesh

        handles = self._shared_handles()
        mesh = make_mesh(n_devices=8, model_parallel=1)
        single = BatchedPredictor(gcn_models=handles)
        sharded = BatchedPredictor(gcn_models=handles, mesh=mesh)
        assert sharded._gcn_shared is not None
        items = self._coords_items(19, seed=65)
        ref = single.predict_gcn_from_coords(items)
        out = sharded.predict_gcn_from_coords(items)
        for mode in ref:
            for q in ref[mode]:
                # different shardings tile the matmuls differently; a few
                # 1e-5-relative ulps across the 512-step LSTM scan is the
                # expected cross-layout numerical envelope
                np.testing.assert_allclose(out[mode][q], ref[mode][q],
                                           rtol=5e-5, atol=1e-6)

    def test_warmup_compiles_multimode(self):
        handles = self._shared_handles()
        engine = BatchedPredictor(gcn_models=handles, buckets=(64,),
                                  batch_cap=4)
        fut = engine.warmup(nets=("gcn_coords",), background=True)
        fut.result()
        assert any(k[0] == "args" for k in engine._gcn_multi_jit)


class TestOversizeBuckets:
    def test_assign_beyond_ceiling(self):
        assert assign_bucket(2049) == 2304
        assert assign_bucket(5000) == 5120

    def test_engine_handles_oversize_protein(self):
        from metagenomic_deepfri_tpu.ops.cmap_align import \
            project_alignment_coords

        rng = np.random.default_rng(40)
        params = init_gcn(jax.random.PRNGKey(12), GCN_CFG)
        handle = ModelHandle("gcn", "mf", GCN_CFG, params)
        # tiny bucket list forces the ad-hoc path with a short "oversize" seq
        engine = BatchedPredictor(gcn_models={"mf": handle}, buckets=(32,))
        aas = "ACDEFGHIKLMNPQRSTVWY"
        L = 70  # > 32 ceiling → ad-hoc 256 bucket
        seq = "".join(rng.choice(list(aas), size=L))
        steps = rng.normal(size=(L, 3)).astype(np.float32)
        steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
        coords = np.cumsum(3.8 * steps, axis=0).astype(np.float32)
        proj, ins, _ = project_alignment_coords(seq, seq, coords)
        out = engine.predict_gcn_from_coords([("big", seq, proj, ins)])
        assert "big" in out["mf"]
        assert np.isfinite(out["mf"]["big"]).all()


class TestStreaming:
    def test_stream_matches_batch_api(self):
        from metagenomic_deepfri_tpu.ops.cmap_align import \
            project_alignment_coords

        rng = np.random.default_rng(50)
        params = init_gcn(jax.random.PRNGKey(14), GCN_CFG)
        handle = ModelHandle("gcn", "mf", GCN_CFG, params)
        engine = BatchedPredictor(gcn_models={"mf": handle}, batch_cap=4)

        aas = "ACDEFGHIKLMNPQRSTVWY"
        items = []
        for i in range(11):
            L = int(rng.integers(20, 200))
            seq = "".join(rng.choice(list(aas), size=L))
            steps = rng.normal(size=(L, 3)).astype(np.float32)
            steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
            coords = np.cumsum(3.8 * steps, axis=0).astype(np.float32)
            proj, ins, _ = project_alignment_coords(seq, seq, coords)
            items.append((f"q{i}", seq, proj, ins))

        ref = engine.predict_gcn_from_coords(items)
        streamed = {}
        progress = []
        n = engine.predict_stream(
            iter(items), net="gcn_coords",
            result_cb=lambda part: streamed.update(part["mf"]),
            progress_cb=progress.append,
            max_inflight=2)
        assert n == 11
        assert sum(progress) == 11
        assert set(streamed) == set(ref["mf"])
        for q in ref["mf"]:
            np.testing.assert_allclose(streamed[q], ref["mf"][q],
                                       rtol=1e-5, atol=1e-6)

    def test_stream_cnn(self):
        rng = np.random.default_rng(51)
        params = init_cnn(jax.random.PRNGKey(15), CNN_CFG)
        handle = ModelHandle("cnn", "bp", CNN_CFG, params)
        engine = BatchedPredictor(cnn_models={"bp": handle}, batch_cap=3)
        items = [(qid, seq) for qid, seq, _ in _mk_items(7, rng)]
        ref = engine.predict_cnn(items)
        got = {}
        n = engine.predict_stream(iter(items), net="cnn",
                                  result_cb=lambda p: got.update(p["bp"]))
        assert n == 7
        for q in ref["bp"]:
            np.testing.assert_allclose(got[q], ref["bp"][q],
                                       rtol=1e-5, atol=1e-6)

    def test_stream_flush_stragglers_exceed_batch(self):
        """Merged end-of-stream stragglers can outnumber the steady batch.

        Regression (round-4 advisor, high): with no warmup and a small
        batch_cap, _flush_residual's merge-into-top-bucket fallback handed
        dispatch more items than any pickable batch shape (steady < count)
        and the flat packer indexed out of bounds. Dispatch must chunk.
        """
        from metagenomic_deepfri_tpu.ops.cmap_align import \
            project_alignment_coords

        rng = np.random.default_rng(52)
        params = init_gcn(jax.random.PRNGKey(16), GCN_CFG)
        handle = ModelHandle("gcn", "mf", GCN_CFG, params)
        engine = BatchedPredictor(gcn_models={"mf": handle},
                                  buckets=(16, 32), batch_cap=4)

        aas = "ACDEFGHIKLMNPQRSTVWY"
        items = []
        # 3 stragglers in each of two buckets (never fills steady=4), so
        # the flush merges 6 leftovers while every dispatchable batch ≤ 4
        for i, L in enumerate((10, 12, 14, 20, 24, 30)):
            seq = "".join(rng.choice(list(aas), size=L))
            steps = rng.normal(size=(L, 3)).astype(np.float32)
            steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
            coords = np.cumsum(3.8 * steps, axis=0).astype(np.float32)
            proj, ins, _ = project_alignment_coords(seq, seq, coords)
            items.append((f"q{i}", seq, proj, ins))

        ref = engine.predict_gcn_from_coords(items)
        got = {}
        n = engine.predict_stream(iter(items), net="gcn_coords",
                                  result_cb=lambda p: got.update(p["mf"]))
        assert n == 6
        assert set(got) == set(ref["mf"])
        for q in ref["mf"]:
            np.testing.assert_allclose(got[q], ref["mf"][q],
                                       rtol=1e-5, atol=1e-6)


class TestFlatWire:
    """Unit tests for the padding-free flat wire format (pack → unpack)."""

    def _roundtrip(self, lengths, batch, bucket):
        from metagenomic_deepfri_tpu.batching.engine import (
            _flat_capacity, _pack_coords_flat, _unpack_coords_flat)

        rng = np.random.default_rng(42)
        aas = "ACDEFGHIKLMNPQRSTVWY"
        items = []
        for i, L in enumerate(lengths):
            seq = "".join(rng.choice(list(aas), size=L))
            coords = (rng.normal(size=(L, 3)) * 200).astype(np.float32)
            ins = rng.random(L) < 0.2
            items.append((f"q{i}", seq, coords, ins))
        total = sum(lengths)
        cap = _flat_capacity(total, bucket, batch)
        assert cap >= total
        flat = _pack_coords_flat(items, batch, cap)
        coords, tokens, ins_mask, out_len = jax.jit(
            _unpack_coords_flat, static_argnames=("batch", "bucket"))(
                flat, batch=batch, bucket=bucket)
        coords, tokens, ins_mask, out_len = map(
            np.asarray, (coords, tokens, ins_mask, out_len))
        from metagenomic_deepfri_tpu.ops.one_hot import seq2tokens

        for i, (qid, seq, c, ins) in enumerate(items):
            L = len(seq)
            assert out_len[i] == L
            # coords bit-exact through the uint8 bitcast wire
            assert np.array_equal(coords[i, :L], c)
            assert np.array_equal(tokens[i, :L], seq2tokens(seq))
            assert np.array_equal(ins_mask[i, :L], ins)
            # padding rows fully zeroed
            assert not coords[i, L:].any()
            assert not tokens[i, L:].any()
            assert not ins_mask[i, L:].any()
        for i in range(len(items), batch):
            assert out_len[i] == 0

    def test_roundtrip_mixed_lengths(self):
        self._roundtrip([5, 64, 63, 17, 1], batch=8, bucket=64)

    def test_roundtrip_full_bucket(self):
        # every protein exactly bucket-length: cap == bucket * batch
        self._roundtrip([32, 32, 32, 32], batch=4, bucket=32)

    def test_roundtrip_single_item(self):
        self._roundtrip([7], batch=4, bucket=128)

    def test_grow_only_cap(self):
        handle = ModelHandle("gcn", "mf", GCN_CFG,
                             init_gcn(jax.random.PRNGKey(0), GCN_CFG))
        engine = BatchedPredictor(gcn_models={"mf": handle}, buckets=(64,))
        small = engine._flat_cap_for(10, 64, 8)
        big = engine._flat_cap_for(512, 64, 8)
        again_small = engine._flat_cap_for(10, 64, 8)
        assert big >= small
        assert again_small == big  # high-water mark never shrinks


class TestPrecisionDefaults:
    def test_f32_models_force_highest(self):
        handle = ModelHandle("gcn", "mf", GCN_CFG,
                             init_gcn(jax.random.PRNGKey(0), GCN_CFG))
        engine = BatchedPredictor(gcn_models={"mf": handle})
        assert engine.matmul_precision == "highest"

    def test_bf16_models_keep_default(self):
        import dataclasses
        cfg = dataclasses.replace(GCN_CFG, compute_dtype="bfloat16")
        handle = ModelHandle("gcn", "mf", cfg,
                             init_gcn(jax.random.PRNGKey(0), cfg))
        engine = BatchedPredictor(gcn_models={"mf": handle})
        assert engine.matmul_precision is None

    def test_explicit_override_wins(self):
        handle = ModelHandle("gcn", "mf", GCN_CFG,
                             init_gcn(jax.random.PRNGKey(0), GCN_CFG))
        engine = BatchedPredictor(gcn_models={"mf": handle},
                                  matmul_precision="default")
        assert engine.matmul_precision == "default"


class TestSharedTrunkOnnxRoundtrip:
    def test_detection_survives_export_import(self, tmp_path):
        """Shared LM subtrees stay bitwise-identical through the production
        ONNX export -> import path, so pipeline-loaded models trigger the
        multi-mode shared-trunk dispatch exactly like in-memory ones."""
        import dataclasses

        from metagenomic_deepfri_tpu.models.onnx_import import (
            export_gcn_to_onnx, import_gcn_params)
        from metagenomic_deepfri_tpu.models.onnx_reader import load_onnx
        from metagenomic_deepfri_tpu.models.registry import infer_gcn_config

        handles = {}
        shared = None
        for i, (mode, n_labels) in enumerate((("bp", 6), ("mf", 4))):
            cfg = dataclasses.replace(GCN_CFG, n_labels=n_labels)
            params = init_gcn(jax.random.PRNGKey(300 + i), cfg)
            if shared is None:
                shared = {k: params[k]
                          for k in ("lm", "lm_embed", "aa_embed")}
            else:
                params.update(shared)
            path = tmp_path / f"gcn_{mode}.onnx"
            export_gcn_to_onnx(params, cfg, str(path))
            graph = load_onnx(str(path))
            loaded_cfg = infer_gcn_config(graph, n_labels)
            loaded = import_gcn_params(graph, loaded_cfg)
            handles[mode] = ModelHandle("gcn", mode, loaded_cfg, loaded)
        engine = BatchedPredictor(gcn_models=handles)
        assert engine._gcn_shared is not None
        assert "lm" in engine._gcn_shared[0]


class TestScoreTopK:
    """Device-side top-k score compaction: exact values, overflow detection."""

    N_LABELS = 40
    K = 8

    def test_invalid_topk_rejected_at_construction(self):
        import pytest

        for bad in (-1, 0, 0.5, -100):
            with pytest.raises(ValueError, match="score_topk"):
                BatchedPredictor(score_topk=bad)
        assert BatchedPredictor(score_topk=None).score_topk is None
        assert BatchedPredictor(score_topk=8).score_topk == 8

    def _handle(self, sparse_scores=True, seed=0):
        """GCN handle whose head yields a realistic sparse score profile:
        class-1 bias +6 pushes most per-term scores far below 0.1, first
        three terms biased high (calibrated-model shape). With
        ``sparse_scores=False`` the random head leaves ~half the scores
        near 0.5 — the overflow regime."""
        import dataclasses

        cfg = dataclasses.replace(GCN_CFG, n_labels=self.N_LABELS)
        params = init_gcn(jax.random.PRNGKey(seed), cfg)
        if sparse_scores:
            # scale the head kernel down so the bias dominates the logits
            # (sum-pooled features otherwise swamp any fixed bias)
            params["head"]["kernel"] = params["head"]["kernel"] * 1e-3
            bias = np.zeros(2 * self.N_LABELS, np.float32)
            bias[1::2] = 6.0           # class-1 wins → score ≈ 0
            for i in range(3):         # three confident terms
                bias[2 * i] = 6.0
                bias[2 * i + 1] = 0.0
            params["head"]["bias"] = bias
        return ModelHandle("gcn", "mf", cfg, params)

    def _items(self, n, seed=70):
        from metagenomic_deepfri_tpu.ops.cmap_align import \
            project_alignment_coords

        rng = np.random.default_rng(seed)
        aas = "ACDEFGHIKLMNPQRSTVWY"
        items = []
        for i in range(n):
            L = int(rng.integers(20, 120))
            seq = "".join(rng.choice(list(aas), size=L))
            steps = rng.normal(size=(L, 3)).astype(np.float32)
            steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
            coords = np.cumsum(3.8 * steps, axis=0).astype(np.float32)
            proj, ins, _ = project_alignment_coords(seq, seq, coords)
            items.append((f"q{i}", seq, proj, ins))
        return items

    def test_expand_topk_host(self):
        from metagenomic_deepfri_tpu.batching.engine import _expand_topk_host

        vals = np.array([[0.9, 0.5, 0.05], [0.09, 0.08, 0.07]], np.float32)
        idx = np.array([[7, 2, 0], [1, 3, 5]], np.int32)
        dense, overflow = _expand_topk_host((vals, idx), 10, 0.1)
        assert dense.shape == (2, 10)
        assert dense[0, 7] == np.float32(0.9)
        assert dense[0, 2] == np.float32(0.5)
        assert dense[0, 0] == np.float32(0.05)
        assert dense[0, 1] == 0.0
        assert not overflow[0]   # 3rd largest (0.05) below threshold: done
        assert not overflow[1]
        vals2 = np.array([[0.9, 0.5, 0.11]], np.float32)
        _, overflow2 = _expand_topk_host((vals2, idx[:1]), 10, 0.1)
        assert overflow2[0]      # K-th still ≥ 0.1 → maybe more beyond K
        passthrough, ov = _expand_topk_host(np.zeros((2, 5)), 5, 0.1)
        assert ov is None and passthrough.shape == (2, 5)

    def test_topk_matches_dense_no_overflow(self):
        handle = self._handle(sparse_scores=True)
        dense_eng = BatchedPredictor(gcn_models={"mf": handle}, batch_cap=4)
        topk_eng = BatchedPredictor(gcn_models={"mf": handle}, batch_cap=4,
                                    score_topk=self.K)
        items = self._items(7)
        flagged = []
        ref = dense_eng.predict_gcn_from_coords(items)
        got = topk_eng.predict_gcn_from_coords(
            items, overflow_cb=lambda m, q: flagged.extend(q))
        assert not flagged
        for q, row in ref["mf"].items():
            kept = got["mf"][q]
            nz = kept != 0
            # exact values at kept positions
            np.testing.assert_array_equal(kept[nz], row[nz])
            # every above-threshold term present
            above = row >= 0.1
            assert nz[above].all()

    def test_topk_overflow_detected(self):
        handle = self._handle(sparse_scores=False)  # ~half scores ≥ 0.1
        topk_eng = BatchedPredictor(gcn_models={"mf": handle}, batch_cap=4,
                                    score_topk=self.K)
        items = self._items(5, seed=71)
        flagged = []
        topk_eng.predict_gcn_from_coords(
            items, overflow_cb=lambda m, q: flagged.extend(q))
        assert set(flagged) == {it[0] for it in items}

    def test_topk_noop_for_small_heads(self):
        # n_labels=4 ≤ 2·K → compaction must not engage (pair costs more)
        handle = ModelHandle("gcn", "mf", GCN_CFG,
                             init_gcn(jax.random.PRNGKey(3), GCN_CFG))
        dense_eng = BatchedPredictor(gcn_models={"mf": handle}, batch_cap=4)
        topk_eng = BatchedPredictor(gcn_models={"mf": handle}, batch_cap=4,
                                    score_topk=self.K)
        items = self._items(3, seed=72)
        ref = dense_eng.predict_gcn_from_coords(items)
        got = topk_eng.predict_gcn_from_coords(items)
        for q in ref["mf"]:
            np.testing.assert_array_equal(got["mf"][q], ref["mf"][q])

    def test_topk_stream(self):
        handle = self._handle(sparse_scores=True, seed=4)
        topk_eng = BatchedPredictor(gcn_models={"mf": handle}, batch_cap=4,
                                    score_topk=self.K)
        dense_eng = BatchedPredictor(gcn_models={"mf": handle}, batch_cap=4)
        items = self._items(9, seed=73)
        ref = dense_eng.predict_gcn_from_coords(items)
        got = {}
        topk_eng.predict_stream(iter(items), net="gcn_coords",
                                result_cb=lambda p: got.update(p["mf"]))
        for q, row in ref["mf"].items():
            nz = got[q] != 0
            np.testing.assert_array_equal(got[q][nz], row[nz])

    def test_topk_cnn(self):
        import dataclasses

        cfg = dataclasses.replace(CNN_CFG, n_labels=self.N_LABELS)
        params = init_cnn(jax.random.PRNGKey(5), cfg)
        params["head"]["kernel"] = params["head"]["kernel"] * 1e-3
        bias = np.zeros(2 * self.N_LABELS, np.float32)
        bias[1::2] = 6.0
        params["head"]["bias"] = bias
        handle = ModelHandle("cnn", "bp", cfg, params)
        dense_eng = BatchedPredictor(cnn_models={"bp": handle}, batch_cap=4)
        topk_eng = BatchedPredictor(cnn_models={"bp": handle}, batch_cap=4,
                                    score_topk=self.K)
        rng = np.random.default_rng(74)
        items = [(qid, seq) for qid, seq, _ in _mk_items(6, rng)]
        ref = dense_eng.predict_cnn(items)
        got = topk_eng.predict_cnn(items)
        for q, row in ref["bp"].items():
            nz = got["bp"][q] != 0
            np.testing.assert_array_equal(got["bp"][q][nz], row[nz])

    def test_topk_multimode(self):
        """Compaction composes with the shared-trunk multi-mode dispatch."""
        import dataclasses

        handles = {}
        base = None
        for i, mode in enumerate(("bp", "cc")):
            cfg = dataclasses.replace(GCN_CFG, n_labels=self.N_LABELS + i)
            params = init_gcn(jax.random.PRNGKey(10 + i), cfg)
            params["head"]["kernel"] = params["head"]["kernel"] * 1e-3
            bias = np.zeros(2 * cfg.n_labels, np.float32)
            bias[1::2] = 6.0
            params["head"]["bias"] = bias
            if base is None:
                base = params
            else:
                for k in ("lm", "lm_embed", "aa_embed"):
                    params[k] = base[k]
            handles[mode] = ModelHandle("gcn", mode, cfg, params)
        topk_eng = BatchedPredictor(gcn_models=handles, batch_cap=4,
                                    score_topk=self.K)
        assert topk_eng._gcn_shared is not None
        dense_eng = BatchedPredictor(gcn_models=handles, batch_cap=4)
        items = self._items(5, seed=75)
        ref = dense_eng.predict_gcn_from_coords(items)
        got = topk_eng.predict_gcn_from_coords(items)
        for mode in ref:
            for q, row in ref[mode].items():
                nz = got[mode][q] != 0
                np.testing.assert_array_equal(got[mode][q][nz], row[nz])


class TestShapeReuse:
    """Compiled-shape registry: dispatch must prefer an existing program
    over compiling a fresh one, and warmup must seed exactly the shapes
    production dispatch picks (compile count, not FLOPs, dominates small
    and medium runs)."""

    def _gcn_engine(self, **kw):
        handle = ModelHandle("gcn", "mf", GCN_CFG,
                             init_gcn(jax.random.PRNGKey(0), GCN_CFG))
        return BatchedPredictor(gcn_models={"mf": handle}, **kw)

    def test_pick_batch_prefers_ready_shape(self):
        engine = self._gcn_engine()
        engine._register_shape("gcn", 128, 16)
        # 5 items would normally get the 128-wide menu shape; the ready
        # 16-wide shape wins instead
        assert engine._pick_batch("gcn", 128, 5, True) == 16
        # nothing ready that fits 17 → the small menu shape
        assert engine._pick_batch("gcn", 128, 17, True) == 128
        # above the small menu entry → the steady batch
        assert engine._pick_batch("gcn", 128, 500, True) == \
            engine._steady_batch(128, True)

    def test_ready_batch_never_exceeds_steady(self):
        engine = self._gcn_engine(batch_cap=8)
        engine._register_shape("gcn", 128, 64)  # forced oversize shape
        assert engine._ready_batch("gcn", 128, 4, 8) is None

    def test_warm_shapes_histogram_plan(self):
        engine = self._gcn_engine(batch_cap=64,
                                  buckets=(128, 256, 512))
        # bucket 128 fills a steady batch; 256/512 are stragglers that
        # merge into ONE catch-all at the largest needed bucket
        shapes = engine._warm_shapes({128: 100, 256: 10, 512: 5},
                                     None, is_gcn=True)
        assert (128, 64) in shapes
        assert (512, 64) in shapes  # straggler catch-all (menu-sized)
        assert len(shapes) == 2
        # CNN: one collapsed program for all standard buckets
        cnn_shapes = engine._warm_shapes({128: 100, 256: 10, 512: 5},
                                         None, is_gcn=False)
        assert cnn_shapes == [(512, 64)]

    def test_cnn_collapses_buckets_at_every_scale(self):
        rng = np.random.default_rng(80)
        params = init_cnn(jax.random.PRNGKey(2), CNN_CFG)
        handle = ModelHandle("cnn", "bp", CNN_CFG, params)
        engine = BatchedPredictor(cnn_models={"bp": handle},
                                  buckets=(32, 64), batch_cap=128)
        items = [(qid, seq) for qid, seq, _ in
                 _mk_items(70, rng, min_len=5, max_len=60)]
        assert len({assign_bucket(len(s), (32, 64)) for _, s in items}) == 2
        out = engine.predict_cnn(items)
        # only the top standard bucket compiled — even above the old ≤64
        # small-run limit
        assert set(engine._ready_shapes) == {("cnn", 64)}
        for qid, seq in items[:2]:
            single = np.asarray(forward_pass_single(params, CNN_CFG, seq))
            np.testing.assert_allclose(out["bp"][qid], single,
                                       rtol=1e-4, atol=1e-5)

    def test_cnn_collapse_prefers_warmed_bucket(self):
        """CNN dispatch routes up to an already-warmed larger bucket.

        Warmup's histogram covers ALL query lengths but the CNN fallback
        sees only the unaligned subset — when every long query aligns, the
        fallback's natural top bucket is smaller than the warmed one and
        must reuse the warmed program, not compile fresh (round-4 advisor).
        """
        rng = np.random.default_rng(82)
        params = init_cnn(jax.random.PRNGKey(3), CNN_CFG)
        handle = ModelHandle("cnn", "bp", CNN_CFG, params)
        engine = BatchedPredictor(cnn_models={"bp": handle},
                                  buckets=(32, 64, 128), batch_cap=16)
        engine.warmup(modes=["bp"], nets=("cnn",), background=False,
                      expected={128: 8})
        warmed = {k: set(v) for k, v in engine._ready_shapes.items()}
        assert ("cnn", 128) in warmed
        items = [(qid, seq) for qid, seq, _ in
                 _mk_items(5, rng, min_len=5, max_len=40)]
        out = engine.predict_cnn(items)
        # no new program — the short items rode the warmed 128 bucket
        assert {k: set(v) for k, v in engine._ready_shapes.items()} == warmed
        for qid, seq in items[:2]:
            single = np.asarray(forward_pass_single(params, CNN_CFG, seq))
            np.testing.assert_allclose(out["bp"][qid], single,
                                       rtol=1e-4, atol=1e-5)

    def test_gcn_small_run_prefers_warmed_bucket(self):
        """A short-protein request reuses the server's warmed 512 shapes.

        The serving warmup compiles only (bucket 512, batch 128); a request
        whose proteins all fall in smaller buckets must route up to it
        instead of compiling at its exact bucket (round-4 advisor).
        """
        from metagenomic_deepfri_tpu.ops.cmap_align import \
            project_alignment_coords

        rng = np.random.default_rng(83)
        engine = self._gcn_engine(buckets=(64, 128, 256))
        engine.warmup(modes=["mf"], nets=("gcn_coords",), background=False,
                      expected={256: 128})
        warmed = {k: set(v) for k, v in engine._ready_shapes.items()}
        assert ("gcn", 256) in warmed
        aas = "ACDEFGHIKLMNPQRSTVWY"
        items = []
        for i in range(5):
            L = int(rng.integers(20, 60))
            seq = "".join(rng.choice(list(aas), size=L))
            coords = np.cumsum(
                3.8 * rng.normal(size=(L, 3)).astype(np.float32), axis=0)
            proj, ins, _ = project_alignment_coords(seq, seq, coords)
            items.append((f"q{i}", seq, proj, ins))
        out = engine.predict_gcn_from_coords(items)
        assert {k: set(v) for k, v in engine._ready_shapes.items()} == warmed
        ref = self._gcn_engine(buckets=(64, 128, 256)) \
            .predict_gcn_from_coords(items)
        for q in ref["mf"]:
            np.testing.assert_allclose(out["mf"][q], ref["mf"][q],
                                       rtol=1e-4, atol=1e-5)

    def test_stream_flush_reuses_warmed_shapes(self):
        from metagenomic_deepfri_tpu.ops.cmap_align import \
            project_alignment_coords

        rng = np.random.default_rng(81)
        engine = self._gcn_engine(buckets=(64, 128), batch_cap=16)
        aas = "ACDEFGHIKLMNPQRSTVWY"
        items = []
        for i in range(9):
            L = int(rng.integers(20, 120))
            seq = "".join(rng.choice(list(aas), size=L))
            coords = np.cumsum(
                3.8 * rng.normal(size=(L, 3)).astype(np.float32), axis=0)
            proj, ins, _ = project_alignment_coords(seq, seq, coords)
            items.append((f"q{i}", seq, proj, ins))
        expected = {}
        for _, seq, _, _ in items:
            b = assign_bucket(len(seq), engine.buckets)
            expected[b] = expected.get(b, 0) + 1
        engine.warmup(expected=expected, background=False)
        warmed = {k: set(v) for k, v in engine._ready_shapes.items()}
        got = {}
        n = engine.predict_stream(iter(items), net="gcn_coords",
                                  result_cb=lambda p: got.update(p["mf"]))
        assert n == len(items)
        # the stream dispatched exclusively through warmed programs
        assert {k: set(v) for k, v in engine._ready_shapes.items()} == warmed
        # and the scores match the batch API
        ref = self._gcn_engine(buckets=(64, 128), batch_cap=16) \
            .predict_gcn_from_coords(items)
        for q in ref["mf"]:
            np.testing.assert_allclose(got[q], ref["mf"][q],
                                       rtol=1e-5, atol=1e-6)


class TestCnnMultiMode:
    """All requested CNN modes evaluate in ONE program (no shared weights
    needed — the win is executable count); results must equal per-mode
    dispatch exactly."""

    def _handles(self):
        import dataclasses
        handles = {}
        for i, (mode, n) in enumerate((("bp", 6), ("cc", 3), ("mf", 4))):
            cfg = dataclasses.replace(CNN_CFG, n_labels=n)
            handles[mode] = ModelHandle(
                "cnn", mode, cfg, init_cnn(jax.random.PRNGKey(40 + i), cfg))
        return handles

    def test_multi_matches_per_mode(self):
        rng = np.random.default_rng(90)
        handles = self._handles()
        engine = BatchedPredictor(cnn_models=handles, batch_cap=4)
        items = [(qid, seq) for qid, seq, _ in _mk_items(6, rng)]
        got = engine.predict_cnn(items)          # multi-mode program
        assert engine._cnn_multi_jit             # it was actually used
        ref = {}
        for mode in handles:
            control = BatchedPredictor(cnn_models=handles, batch_cap=4)
            ref[mode] = control.predict_cnn(items, modes=[mode])[mode]
            assert not control._cnn_multi_jit    # single mode → per-mode
        for mode in handles:
            for q, row in ref[mode].items():
                np.testing.assert_array_equal(got[mode][q], row)


class TestFlushChunking:
    def test_leftovers_chunk_through_ready_shape(self):
        """End-of-stream leftovers larger than the biggest compiled batch
        dispatch in chunks of it — never a fresh straggler compile."""
        from metagenomic_deepfri_tpu.ops.cmap_align import \
            project_alignment_coords

        rng = np.random.default_rng(91)
        handle = ModelHandle("gcn", "mf", GCN_CFG,
                             init_gcn(jax.random.PRNGKey(7), GCN_CFG))
        engine = BatchedPredictor(gcn_models={"mf": handle},
                                  buckets=(16, 32, 64), batch_cap=4)
        # warm ONLY a (64, 4) shape; stream straggler counts (< batch 4)
        # into buckets 16 and 32 so the end-of-stream flush holds 6
        # leftovers with NO compiled shape of their own
        engine.warmup(expected={64: 2}, background=False)
        warmed = {k: set(v) for k, v in engine._ready_shapes.items()}
        assert warmed == {("gcn", 64): {4}}
        items = []
        for i, L in enumerate([10, 10, 10, 25, 25, 25, 50]):
            seq = "A" * L
            coords = np.cumsum(
                3.8 * rng.normal(size=(L, 3)).astype(np.float32), axis=0)
            proj, ins, _ = project_alignment_coords(seq, seq, coords)
            items.append((f"q{i}", seq, proj, ins))
        got = {}
        n = engine.predict_stream(iter(items), net="gcn_coords",
                                  result_cb=lambda p: got.update(p["mf"]))
        assert n == 7
        assert len(got) == 7
        # the 6 leftovers from buckets 16/32 merged + chunked (4 then 2)
        # through the warmed (64, 4) program; NO new shape was compiled
        assert {k: set(v) for k, v in engine._ready_shapes.items()} == warmed


class TestParamPlacement:
    """Engine construction fingerprints on host and device-places each
    param tree once; shared trunk subtrees are aliased, not duplicated."""

    def test_shared_subtrees_aliased_on_device(self):
        import dataclasses
        handles = {}
        base = None
        for i, (mode, n) in enumerate((("bp", 6), ("mf", 4))):
            cfg = dataclasses.replace(GCN_CFG, n_labels=n)
            params = jax.tree_util.tree_map(
                np.asarray, init_gcn(jax.random.PRNGKey(400 + i), cfg))
            if base is None:
                base = params
            else:
                for k in ("lm", "lm_embed", "aa_embed"):
                    params[k] = base[k]
            handles[mode] = ModelHandle("gcn", mode, cfg, params)
        engine = BatchedPredictor(gcn_models=handles)
        assert engine._gcn_shared is not None
        # the LM kernel is THE SAME device buffer in both modes
        k_bp = handles["bp"].params["lm"][0]["kernel"]
        k_mf = handles["mf"].params["lm"][0]["kernel"]
        assert k_bp is k_mf
        # and params are device arrays now (placed once)
        import jax as _jax
        assert isinstance(k_bp, _jax.Array)

    def test_fingerprints_gated(self):
        # single-mode engines never hash (nothing to detect)
        handle = ModelHandle("gcn", "mf", GCN_CFG,
                             init_gcn(jax.random.PRNGKey(0), GCN_CFG))
        BatchedPredictor(gcn_models={"mf": handle})
        assert handle.fingerprints is None
