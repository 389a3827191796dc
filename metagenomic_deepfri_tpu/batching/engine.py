"""Device-resident batched inference engine for the DeepFRI model family.

The reference's hot loop is one synchronous ``session.run`` per protein per
mode per network, with models loaded and destroyed per mode (reference
``pipeline.py:292-319`` and ``:584-648``). This engine:

- keeps every mode's parameters resident on device simultaneously,
- packs proteins into length-bucketed mega-batches (one compiled XLA program
  per (bucket, batch-size) shape),
- evaluates ALL requested modes for a batch while its inputs are on device
  (amortising the O(B·L²) adjacency transfer across modes),
- ships adjacency as uint8 and expands to compute dtype on device (4× less
  PCIe/DMA traffic than the reference's float32 dense A per call),
- relies on JAX async dispatch for host/device overlap: batch k+1 is being
  packed on host while batch k executes.

Optionally shards batches over a device mesh (data-parallel) via
``jax.sharding``; see :mod:`metagenomic_deepfri_tpu.parallel`.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from functools import partial
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from metagenomic_deepfri_tpu.batching.buckets import (DEFAULT_BUCKETS,
                                                      assign_bucket,
                                                      bucket_plan,
                                                      cnn_batch_size,
                                                      gcn_batch_size)
from metagenomic_deepfri_tpu.models.deepfri import (CNNConfig, GCNConfig,
                                                    cnn_forward, gcn_forward,
                                                    gcn_forward_multimode)
from metagenomic_deepfri_tpu.ops.cmap_align import aligned_contacts_from_coords
from metagenomic_deepfri_tpu.ops.one_hot import seq2tokens

logger = logging.getLogger(__name__)

@dataclass
class ModelHandle:
    """One loaded network: config + params + vocabulary.

    ``params`` arrive as HOST numpy trees from the importers and are
    device-placed once by the engine (one batched transfer per handle);
    ``fingerprints`` ({top_key: digest}) are computed on host for
    shared-trunk detection — zero device round trips at construction.
    """
    net_type: str          # "gcn" | "cnn"
    mode: str              # "bp" | "cc" | "mf" | "ec"
    config: object         # GCNConfig | CNNConfig
    params: dict
    goterms: Optional[list] = None
    gonames: Optional[list] = None
    fingerprints: Optional[dict] = None


def _subtree_digest(tree) -> str:
    """Host-side content hash of a parameter subtree (structure + shapes +
    dtypes + exact bytes). Bitwise identity is precisely the shared-trunk
    criterion, and hashing ~tens of MB on host costs milliseconds, where
    per-leaf on-device comparisons would each pay a fresh tiny program."""
    import hashlib

    leaves, treedef = jax.tree_util.tree_flatten(tree)
    h = hashlib.sha1(repr(treedef).encode())
    for leaf in leaves:
        a = np.asarray(leaf)
        h.update(repr((a.shape, str(a.dtype))).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# Byte layout of the packed uint8 wire buffer (ONE H2D transfer per batch
# instead of four small latency-bound transfers over the link), (B, L, 16):
# [0:12]=CA coords (3 × f32 little-endian bytes, bitcast back on device —
# exact), [12]=token id, [13]=insertion mask, [14:16]=length (uint16 LE,
# broadcast along L). 16 bytes/residue vs the naive 6-channel float32
# layout's 24 — the link is the bottleneck, not the unpack.
_PACK_BYTES = 16

# Cap on a single packed host→device transfer. Large enough to amortise link
# latency, small enough to bound host pinned-memory and device staging.
_MAX_MEGA_BYTES = 256 * 1024 * 1024


def _pack_coords_mega(items: List[tuple], bucket: int, n_rows: int):
    """Pack (id, seq, proj_coords, ins_mask) items into ONE (N, L, 16) uint8.

    Ships O(B·L) bytes per protein instead of the O(B·L²) dense adjacency —
    the adjacency is reconstructed on device inside the fused GCN step.
    Coordinates travel as their raw float32 bytes (bitwise exact after the
    on-device bitcast). Trailing rows beyond ``len(items)`` stay zero
    (length 0 → fully masked).
    """
    mega = np.zeros((n_rows, bucket, _PACK_BYTES), dtype=np.uint8)
    for i, (_, seq, proj, ins_mask) in enumerate(items):
        t = seq2tokens(seq)
        L = t.shape[0]
        proj = np.ascontiguousarray(proj, dtype=np.float32)
        mega[i, : proj.shape[0], :12] = proj.view(np.uint8).reshape(-1, 12)
        mega[i, :L, 12] = t
        mega[i, : ins_mask.shape[0], 13] = ins_mask
        mega[i, :, 14] = L & 0xFF
        mega[i, :, 15] = (L >> 8) & 0xFF
    return mega


def _unpack_coords_mega(packed: jnp.ndarray):
    """Device-side inverse of :func:`_pack_coords_mega`.

    (B, L, 16) uint8 → (coords (B,L,3) f32, tokens (B,L) uint8,
    ins_mask (B,L) bool, lengths (B,) int32). The f32 bitcast is exact.
    """
    B, L, _ = packed.shape
    coords = jax.lax.bitcast_convert_type(
        packed[..., :12].reshape(B, L, 3, 4), jnp.float32)
    tokens = packed[..., 12]
    ins_mask = packed[..., 13] != 0
    lengths = (packed[:, 0, 14].astype(jnp.int32)
               | (packed[:, 0, 15].astype(jnp.int32) << 8))
    return coords, tokens, ins_mask, lengths


def _detect_shared_gcn(gcn_models: Dict[str, "ModelHandle"]):
    """Detect bitwise-shared trunk subtrees across the loaded GCN modes.

    The published DeepFRI models share one frozen pretrained LSTM-LM across
    bp/cc/mf; the MERGED ONNX export duplicates it per file, so after import
    every mode carries an identical ``lm`` subtree (and usually identical
    ``lm_embed``/``aa_embed``). Returns (shared, per_mode, configs) when at
    least the LM is shared and the configs agree on everything but
    ``n_labels`` — the precondition for
    :func:`..models.deepfri.gcn_forward_multimode` — else None. Equality is
    decided from the handles' host-side content fingerprints (the engine
    computes them at construction): zero device work.
    """
    import dataclasses

    modes = list(gcn_models)
    if len(modes) < 2:
        return None
    handles = [gcn_models[m] for m in modes]
    cfg0 = handles[0].config
    if not isinstance(cfg0, GCNConfig):
        return None
    for h in handles[1:]:
        if not isinstance(h.config, GCNConfig):
            return None
        if dataclasses.replace(h.config, n_labels=cfg0.n_labels) != cfg0:
            return None
    shared_keys = []
    for k in ("lm", "lm_embed", "aa_embed"):
        if handles[0].params.get(k) is None:
            continue
        fp0 = (handles[0].fingerprints or {}).get(k)
        if fp0 and all((h.fingerprints or {}).get(k) == fp0
                       for h in handles[1:]):
            shared_keys.append(k)
    if "lm" not in shared_keys:
        return None
    shared = {k: handles[0].params[k] for k in shared_keys}
    per_mode = {m: {k: v for k, v in gcn_models[m].params.items()
                    if k not in shared_keys} for m in modes}
    configs = {m: gcn_models[m].config for m in modes}
    return shared, per_mode, configs


def _pow2_at_least(n: int, floor: int = 8) -> int:
    """Smallest power of two ≥ max(n, floor)."""
    p = floor
    while p < n:
        p *= 2
    return p


def _flat_header_rows(batch: int) -> int:
    """Rows reserved at the head of a flat wire buffer for (batch,) int32
    lengths (4 bytes each, packed into 16-byte rows)."""
    return -(-batch * 4 // _PACK_BYTES)


def _flat_capacity(total_rows: int, bucket: int, batch: int) -> int:
    """Quantised flat-buffer data-row capacity.

    Rounding the per-batch residue count up to quarters of the full
    (bucket · batch) footprint bounds the distinct compiled shapes per
    (bucket, batch) at 4; workloads with a stable length distribution hit
    one. The cap-dependent part of the program is a tiny standalone unpack
    jit (see :meth:`BatchedPredictor._flat_unpack`), so a fresh cap costs a
    sub-second compile, not a recompile of the GCN forward.
    """
    quantum = max(2048, (bucket * batch) // 4)
    cap = -(-max(total_rows, 1) // quantum) * quantum
    return min(cap, bucket * batch)


def _pack_coords_flat(items: List[tuple], batch: int, cap: int):
    """Pack items contiguously (no per-protein padding) into flat wire rows.

    Returns a ((header + cap), 16) uint8 buffer: a header carrying the
    (batch,) int32 lengths, then one 16-byte record per *residue* —
    [0:12]=CA coord f32 bytes, [12]=token, [13]=insertion flag. Proteins
    occupy ``sum(L_i)`` rows instead of ``batch · bucket``: on
    half-occupied buckets this halves the host→device bytes again on top of
    the 16-vs-24 B/residue layout. The padded (B, L) layout is recovered on
    device by :func:`_unpack_coords_flat` with a cheap gather.
    """
    header = _flat_header_rows(batch)
    mega = np.zeros((header + cap, _PACK_BYTES), dtype=np.uint8)
    lengths = np.zeros((batch,), dtype=np.int32)
    row = 0
    for i, (_, seq, proj, ins_mask) in enumerate(items):
        t = seq2tokens(seq)
        L = t.shape[0]
        lengths[i] = L
        proj = np.ascontiguousarray(proj, dtype=np.float32)
        block = mega[header + row: header + row + L]
        block[: proj.shape[0], :12] = proj.view(np.uint8).reshape(-1, 12)
        block[:L, 12] = t
        block[: ins_mask.shape[0], 13] = ins_mask
        row += L
    mega[:header].reshape(-1)[: batch * 4] = lengths.view(np.uint8)
    return mega


def _unpack_coords_flat(flat: jnp.ndarray, batch: int, bucket: int):
    """Device-side inverse of :func:`_pack_coords_flat`.

    Scatters the contiguous per-residue records back into the padded (B, L)
    layout (one gather — trivial next to the transfer it saves), then
    reuses the fixed-record unpack.
    """
    header = _flat_header_rows(batch)
    lengths = jax.lax.bitcast_convert_type(
        flat[:header].reshape(-1, 4), jnp.int32).reshape(-1)[:batch]
    data = flat[header:]
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(lengths)[:-1]])
    pos = jnp.arange(bucket, dtype=jnp.int32)
    valid = pos[None, :] < lengths[:, None]
    idx = offsets[:, None] + jnp.where(valid, pos[None, :], 0)
    rows = data[idx] * valid[:, :, None].astype(jnp.uint8)
    coords = jax.lax.bitcast_convert_type(
        rows[..., :12].reshape(batch, bucket, 3, 4), jnp.float32)
    tokens = rows[..., 12]
    ins_mask = rows[..., 13] != 0
    return coords, tokens, ins_mask, lengths


def _expand_topk_host(host_out, n_labels: int, threshold: float):
    """Host-side inverse of the device top-k score compaction.

    ``host_out`` is either a dense (B, n_labels) array (compaction off for
    this head) or a ``(values (B, K), indices (B, K))`` pair from
    ``lax.top_k``. Returns ``(dense, overflow)``: the dense rows carry the
    exact float32 values at the kept positions and 0.0 elsewhere, and
    ``overflow`` (or None when dense) flags rows whose K-th largest score
    still clears ``threshold`` — for those, terms beyond K might also clear
    it, so the caller must re-run them through a dense fetch to guarantee
    threshold-complete results.
    """
    if not isinstance(host_out, (tuple, list)):
        return host_out, None
    vals, idx = host_out
    vals = np.asarray(vals, dtype=np.float32)
    idx = np.asarray(idx)
    dense = np.zeros((vals.shape[0], n_labels), np.float32)
    np.put_along_axis(dense, idx.astype(np.int64), vals, axis=1)
    return dense, vals[:, -1] >= threshold


def _pad_batch_coords(items: List[tuple], bucket: int, batch: int):
    """Pack (id, seq, proj_coords, ins_mask) tuples into padded arrays."""
    tokens = np.zeros((batch, bucket), dtype=np.uint8)
    lengths = np.zeros((batch,), dtype=np.int32)
    coords = np.zeros((batch, bucket, 3), dtype=np.float32)
    ins = np.zeros((batch, bucket), dtype=bool)
    for i, (_, seq, proj, ins_mask) in enumerate(items):
        t = seq2tokens(seq)
        tokens[i, : t.shape[0]] = t
        lengths[i] = t.shape[0]
        coords[i, : proj.shape[0]] = proj
        ins[i, : ins_mask.shape[0]] = ins_mask
    return tokens, lengths, coords, ins


def _pad_batch(items: List[tuple], bucket: int, batch: int, with_adj: bool):
    """Pack (id, seq, cmap?) tuples into padded arrays."""
    tokens = np.zeros((batch, bucket), dtype=np.uint8)
    lengths = np.zeros((batch,), dtype=np.int32)
    adj = np.zeros((batch, bucket, bucket), dtype=np.uint8) if with_adj else None
    for i, item in enumerate(items):
        seq = item[1]
        t = seq2tokens(seq)
        tokens[i, : t.shape[0]] = t
        lengths[i] = t.shape[0]
        if with_adj:
            cmap = np.asarray(item[2])
            L = cmap.shape[0]
            adj[i, :L, :L] = cmap.astype(np.uint8)
    return tokens, lengths, adj


class BatchedPredictor:
    """Executes GCN/CNN forwards for many proteins across all modes at once.

    Args:
        gcn_models: {mode: ModelHandle} for the structure (GCN) networks.
        cnn_models: {mode: ModelHandle} for the sequence-only (CNN) networks.
        buckets: length-bucket boundaries.
        score_topk: if set, heads with more than 2·K labels return only the
            top-K (value, index) pairs from the device — an ~8× smaller
            device→host fetch for the BP head (3992 terms), whose dense
            float32 score matrix otherwise dominates link traffic. Rows are
            re-expanded to dense float32 on host with exact values at the
            kept positions and 0.0 elsewhere, which is output-identical for
            any consumer that only keeps scores ≥ ``score_threshold``
            (reference ``pipeline.py:701,735``) — UNLESS a protein has more
            than K such terms, which is detected (K-th value ≥ threshold)
            and reported through the ``overflow_cb`` of the predict calls so
            the caller can re-run those proteins densely. Do NOT enable when
            full prediction matrices must be exact (the pipeline only turns
            this on under ``--skip-matrix``).
        score_threshold: the downstream keep-threshold used for overflow
            detection (the engine never drops values itself).
    """

    def __init__(self,
                 gcn_models: Optional[Dict[str, ModelHandle]] = None,
                 cnn_models: Optional[Dict[str, ModelHandle]] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 matmul_precision: Optional[str] = None,
                 batch_cap: Optional[int] = None,
                 contact_threshold: float = 6.0,
                 generated_contacts: int = 2,
                 score_topk: Optional[int] = None,
                 score_threshold: float = 0.1,
                 mesh=None):
        from metagenomic_deepfri_tpu.utils import \
            enable_persistent_compile_cache
        enable_persistent_compile_cache()  # before any compile; idempotent
        self.gcn_models = gcn_models or {}
        self.cnn_models = cnn_models or {}
        self.buckets = tuple(buckets)
        if matmul_precision is None:
            # On the GPU a float32 matmul may run in TF32 (about three
            # decimal digits) unless a precision is given, which perturbs
            # float32-config scores by ~1e-3 vs the CPU/ONNX oracle.
            # "float32" should mean float32: force exact matmuls unless the
            # model explicitly opts into bfloat16 compute (the fast path,
            # which keeps XLA's default).
            all_handles = list(self.gcn_models.values()) + \
                list(self.cnn_models.values())
            if all_handles and all(
                    getattr(h.config, "compute_dtype", "float32")
                    == "float32" for h in all_handles):
                matmul_precision = "highest"
        self.matmul_precision = matmul_precision
        self.batch_cap = batch_cap
        self.contact_threshold = float(contact_threshold)
        self.generated_contacts = int(generated_contacts)
        if score_topk is not None and int(score_topk) < 1:
            raise ValueError(
                f"score_topk must be >= 1 (or None to disable), got "
                f"{score_topk!r}")
        self.score_topk = int(score_topk) if score_topk else None
        self.score_threshold = float(score_threshold)
        # Optional jax.sharding.Mesh: packed batches shard over its 'data'
        # axis (params replicated), so one engine drives a whole host's
        # devices. Batch sizes scale by the data-axis size so each device
        # keeps its single-device occupancy.
        self.mesh = mesh
        self._data_parallel = 1
        if mesh is not None:
            from metagenomic_deepfri_tpu.parallel.mesh import DATA_AXIS
            self._data_parallel = mesh.shape[DATA_AXIS]
        self._gcn_jit = {}
        self._gcn_coords_jit = {}
        self._gcn_flat_jit = {}
        self._flat_unpack_jit = {}
        self._flat_cap = {}
        self._flat_cap_lock = threading.Lock()
        self._cnn_jit = {}
        self._cnn_multi_jit = {}
        # One lock guards every jit-wrapper cache get-or-create: parallel
        # warmup threads warm different shapes of the SAME mode, and two
        # racing misses would each create a jax.jit wrapper — the loser's
        # compiled executables are dropped, so a shape registered as warm
        # silently recompiles on its first production dispatch.
        self._jit_lock = threading.Lock()
        # (family, bucket) → set of batch sizes whose programs are compiled
        # (or compiling). Dispatch prefers ANY ready shape that fits over
        # compiling a fresh power-of-two one: a slightly over-sized batch
        # costs milliseconds of padded compute, a fresh executable costs
        # seconds-to-minutes of compile. Families: "gcn" | "cnn".
        self._ready_shapes: Dict[tuple, set] = {}
        self._ready_lock = threading.Lock()
        # Host-side content fingerprints for shared-trunk detection —
        # computed only when detection can actually run (≥2 GCN modes):
        # the importers keep params as numpy so this is pure hashing there,
        # but handles built from live device arrays (bench/tests) would pay
        # a full D2H pull per model for nothing.
        if len(self.gcn_models) >= 2:
            for h in self.gcn_models.values():
                if h.fingerprints is None:
                    h.fingerprints = {k: _subtree_digest(v)
                                      for k, v in h.params.items()}
        # Shared-trunk multi-mode evaluation: when every loaded GCN mode
        # carries a bitwise-identical LSTM-LM (the published models share
        # one frozen pretrained LM), a multi-mode batch computes the shared
        # trunk once instead of once per mode (~1.9× less device work on a
        # 3-mode pass).
        self._gcn_shared = _detect_shared_gcn(self.gcn_models)
        if self._gcn_shared is not None:
            logger.info(
                "GCN modes %s share %s — multi-mode batches compute the "
                "shared trunk once.", list(self.gcn_models),
                sorted(self._gcn_shared[0]))
        self._place_params()
        self._gcn_multi_jit = {}

    def _place_params(self):
        """Device-place every handle's parameter tree ONCE.

        One batched ``device_put`` per tree (transfers, not programs — no
        per-leaf compile cost), replicated over the mesh when sharded.
        Shared trunk subtrees are placed once and aliased into every
        mode's handle, so the LM occupies HBM once instead of per mode.
        """
        sharding = None
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            sharding = NamedSharding(self.mesh, P())

        def put(tree):
            return (jax.device_put(tree, sharding) if sharding
                    else jax.device_put(tree))

        if self._gcn_shared is not None:
            shared, per_mode, configs = self._gcn_shared
            shared = put(shared)
            per_mode = {m: put(v) for m, v in per_mode.items()}
            self._gcn_shared = (shared, per_mode, configs)
            for m, h in self.gcn_models.items():
                if m in per_mode:
                    h.params = {**per_mode[m], **shared}
                else:
                    h.params = put(h.params)
        else:
            for h in self.gcn_models.values():
                h.params = put(h.params)
        for h in self.cnn_models.values():
            h.params = put(h.params)

    # -- compiled forwards ---------------------------------------------------

    def _cached_jit(self, cache: dict, key, build):
        """Get-or-create a jit wrapper under ``_jit_lock``.

        ``build()`` only constructs a closure + jax.jit wrapper (tracing
        happens on first call), so holding the lock across it is cheap and
        guarantees all shapes of a (mode, key) compile into ONE wrapper.
        """
        with self._jit_lock:
            fn = cache.get(key)
            if fn is None:
                fn = cache[key] = build()
            return fn

    def _jit(self, fn, batch_ranks, n_params: int = 1):
        """jit ``fn(*param_args, *batch_args)``, sharding batch args over 'data'.

        ``batch_ranks``: rank of each batch argument; its leading (batch)
        dimension is sharded over the mesh's data axis, the ``n_params``
        leading parameter arguments replicated. Without a mesh this is a
        plain jit. The output sharding (a single data-sharded spec) applies
        as a pytree prefix, so dict outputs (multi-mode steps) shard each
        per-mode score array the same way.
        """
        if self.mesh is None:
            return jax.jit(fn)
        from jax.sharding import NamedSharding, PartitionSpec as P

        from metagenomic_deepfri_tpu.parallel.mesh import DATA_AXIS

        def sh(spec):
            return NamedSharding(self.mesh, spec)

        batch_sh = tuple(
            sh(P(DATA_AXIS, *([None] * (r - 1)))) for r in batch_ranks)
        return jax.jit(fn, in_shardings=(None,) * n_params + batch_sh,
                       out_shardings=sh(P(DATA_AXIS, None)))

    def _compact_scores(self, scores, n_labels: int):
        """In-trace device-side top-k score compaction (see ``score_topk``).

        A no-op unless compaction is enabled AND pays for this head
        (n_labels > 2·K: the (value, index) pair costs 8 bytes/entry vs 4
        for a dense float32 row).
        """
        k = self.score_topk
        if not k or n_labels <= 2 * k:
            return scores
        vals, idx = jax.lax.top_k(scores, k)
        return vals, idx.astype(jnp.int32)

    def _gcn_step(self, mode: str):
        def build():
            handle = self.gcn_models[mode]

            def step(params, tokens, adj_u8, lengths):
                adj = adj_u8.astype(jnp.float32)
                scores = gcn_forward(params, handle.config, tokens, adj,
                                     lengths)
                return self._compact_scores(scores, handle.config.n_labels)

            return self._jit(step, (2, 3, 1))

        return self._cached_jit(self._gcn_jit, mode, build)

    def _gcn_coords_step(self, mode: str):
        """Fused adjacency-construction + GCN forward — the hot path.

        The dense (B, L, L) adjacency is built on device from projected CA
        coordinates (ops.cmap_align.aligned_contacts_from_coords) inside the
        same XLA program as the GCN forward, so only O(B·L) bytes cross the
        host↔device link per batch (vs the reference's O(L²) float32 per
        protein per call, predict.pyx:85-90).
        """
        def build():
            fwd = self._gcn_coords_forward(mode)
            n_labels = self.gcn_models[mode].config.n_labels

            def step(params, packed):
                scores = fwd(params, *_unpack_coords_mega(packed))
                return self._compact_scores(scores, n_labels)

            return self._jit(step, (3,))

        return self._cached_jit(self._gcn_coords_jit, mode, build)

    def _gcn_coords_forward(self, mode: str):
        """Unjitted (coords, tokens, ins_mask, lengths) → scores forward."""
        handle = self.gcn_models[mode]
        thr = self.contact_threshold
        gen = self.generated_contacts

        def fwd(params, coords, tokens, ins_mask, lengths):
            adj = aligned_contacts_from_coords(
                coords, ins_mask, lengths, threshold=thr,
                generated_contacts=gen)
            return gcn_forward(params, handle.config, tokens, adj, lengths)

        return fwd

    def _flat_cap_for(self, total_rows: int, bucket: int, batch: int) -> int:
        """Grow-only flat capacity per (bucket, batch).

        Quantised caps near a workload's typical residue count flap between
        two quanta batch-to-batch (each flap retraces the unpack jit);
        remembering the high-water mark converges every stable workload to
        ONE compiled unpack shape after the first few batches.
        """
        key = (bucket, batch)
        # Called concurrently from the pack-ahead thread, the warmup thread
        # and stream dispatch; the lock keeps the high-water update atomic
        # (a lost update would lower the cap and retrace the unpack jit).
        with self._flat_cap_lock:
            cap = max(self._flat_cap.get(key, 0),
                      _flat_capacity(total_rows, bucket, batch))
            self._flat_cap[key] = cap
        return cap

    def _flat_unpack(self, batch: int, bucket: int):
        """Tiny jitted flat-wire unpack; the only cap-shaped program.

        Kept separate from the GCN forward so a new flat capacity compiles
        in well under a second instead of re-tracing the full model (whose
        512-step LSTM scan costs seconds to compile). The unpacked arrays
        stay on device and feed the cap-independent forward jit.
        """
        key = (batch, bucket)
        return self._cached_jit(
            self._flat_unpack_jit, key,
            lambda: jax.jit(partial(_unpack_coords_flat, batch=batch,
                                    bucket=bucket)))

    def _gcn_coords_args_step(self, mode: str):
        """Jitted forward over already-unpacked (coords, tokens, ins, len)."""
        def build():
            fwd = self._gcn_coords_forward(mode)
            n_labels = self.gcn_models[mode].config.n_labels

            def step(params, *args):
                return self._compact_scores(fwd(params, *args), n_labels)

            return jax.jit(step)

        return self._cached_jit(self._gcn_flat_jit, mode, build)

    # -- shared-trunk multi-mode steps ----------------------------------------

    def _multi_key(self, modes) -> Optional[tuple]:
        """The jit-cache key when a multi-mode shared-trunk pass applies.

        Requires ≥2 requested modes, detected sharing, and every requested
        mode among the shared set; returns None otherwise (per-mode
        dispatch).
        """
        if self._gcn_shared is None or len(modes) < 2:
            return None
        _, per_mode, _ = self._gcn_shared
        if not all(m in per_mode for m in modes):
            return None
        return tuple(modes)

    def _multi_params(self, modes):
        """(shared_subtrees, {mode: remainder}) for a multi-mode call."""
        shared, per_mode, _ = self._gcn_shared
        return shared, {m: per_mode[m] for m in modes}

    def _gcn_multi_args_step(self, modes: tuple):
        """Jitted multi-mode forward over unpacked (coords, tokens, ins, len).

        One program evaluates every requested mode: adjacency is built and
        normalised once, the shared LM trunk runs once, and only the
        GraphConv/FC/head stacks repeat per mode.
        """
        key = ("args",) + tuple(modes)

        def build():
            _, _, configs = self._gcn_shared
            cfgs = {m: configs[m] for m in modes}
            thr, gen = self.contact_threshold, self.generated_contacts

            def step(shared_p, per_mode_p, coords, tokens, ins_mask,
                     lengths):
                adj = aligned_contacts_from_coords(
                    coords, ins_mask, lengths, threshold=thr,
                    generated_contacts=gen)
                out = gcn_forward_multimode(shared_p, per_mode_p, cfgs,
                                            tokens, adj, lengths)
                return {m: self._compact_scores(v, cfgs[m].n_labels)
                        for m, v in out.items()}

            return jax.jit(step)

        return self._cached_jit(self._gcn_multi_jit, key, build)

    def _gcn_multi_packed_step(self, modes: tuple):
        """Multi-mode forward over the packed (B, L, 16) wire buffer
        (mesh path — batch arg shards over the data axis)."""
        key = ("packed",) + tuple(modes)

        def build():
            _, _, configs = self._gcn_shared
            cfgs = {m: configs[m] for m in modes}
            thr, gen = self.contact_threshold, self.generated_contacts

            def step(shared_p, per_mode_p, packed):
                coords, tokens, ins_mask, lengths = \
                    _unpack_coords_mega(packed)
                adj = aligned_contacts_from_coords(
                    coords, ins_mask, lengths, threshold=thr,
                    generated_contacts=gen)
                out = gcn_forward_multimode(shared_p, per_mode_p, cfgs,
                                            tokens, adj, lengths)
                return {m: self._compact_scores(v, cfgs[m].n_labels)
                        for m, v in out.items()}

            return self._jit(step, (3,), n_params=2)

        return self._cached_jit(self._gcn_multi_jit, key, build)

    def _gcn_multi_dense_step(self, modes: tuple):
        """Multi-mode forward over a dense uint8 adjacency batch."""
        key = ("dense",) + tuple(modes)

        def build():
            _, _, configs = self._gcn_shared
            cfgs = {m: configs[m] for m in modes}

            def step(shared_p, per_mode_p, tokens, adj_u8, lengths):
                adj = adj_u8.astype(jnp.float32)
                out = gcn_forward_multimode(shared_p, per_mode_p, cfgs,
                                            tokens, adj, lengths)
                return {m: self._compact_scores(v, cfgs[m].n_labels)
                        for m, v in out.items()}

            return self._jit(step, (2, 3, 1), n_params=2)

        return self._cached_jit(self._gcn_multi_jit, key, build)

    def _cnn_step(self, mode: str):
        def build():
            handle = self.cnn_models[mode]

            def step(params, tokens, lengths):
                scores = cnn_forward(params, handle.config, tokens, lengths)
                return self._compact_scores(scores, handle.config.n_labels)

            return self._jit(step, (2, 1))

        return self._cached_jit(self._cnn_jit, mode, build)

    def _cnn_multi_step(self, modes: tuple):
        """ONE jitted program evaluating every requested CNN mode.

        Unlike the GCN multi-mode step this shares no parameters — the win
        is program count: one executable + one dispatch per batch instead
        of one per mode. Executable compile/first-load dominates small and
        medium runs, and XLA is free to interleave the three independent
        trunks within the one program.
        """
        key = tuple(modes)

        def build():
            cfgs = {m: self.cnn_models[m].config for m in key}

            def step(params_by_mode, tokens, lengths):
                return {m: self._compact_scores(
                    cnn_forward(params_by_mode[m], cfgs[m], tokens, lengths),
                    cfgs[m].n_labels) for m in key}

            return self._jit(step, (2, 1))

        return self._cached_jit(self._cnn_multi_jit, key, build)

    def _cnn_dispatch(self, modes, tokens_d, lengths_d) -> dict:
        """{mode: step output} for one CNN batch (multi-mode program when
        more than one mode is requested)."""
        if len(modes) > 1:
            params = {m: self.cnn_models[m].params for m in modes}
            return dict(self._cnn_multi_step(tuple(modes))(
                params, tokens_d, lengths_d))
        return {m: self._cnn_step(m)(self.cnn_models[m].params, tokens_d,
                                     lengths_d) for m in modes}

    # -- batch-shape selection -------------------------------------------------

    def _steady_batch(self, bucket: int, is_gcn: bool) -> int:
        """The full production batch size for a bucket (mesh-scaled, capped)."""
        batch = (gcn_batch_size(bucket) if is_gcn
                 else cnn_batch_size(bucket)) * self._data_parallel
        if self.batch_cap:
            batch = min(batch, self.batch_cap)
        return batch

    def _register_shape(self, family: str, bucket: int, batch: int) -> None:
        with self._ready_lock:
            self._ready_shapes.setdefault((family, bucket), set()).add(batch)

    def _ready_batch(self, family: str, bucket: int, n: int,
                     steady: int) -> Optional[int]:
        """Smallest already-compiled batch that fits ``n`` items, or None.

        Shapes larger than ``steady`` are never proposed (they only exist if
        a caller forced them) so reuse cannot exceed the per-bucket memory
        envelope the batch rule guarantees.
        """
        with self._ready_lock:
            ready = sorted(self._ready_shapes.get((family, bucket), ()))
        for b in ready:
            if n <= b <= max(steady, n):
                return b
        return None

    def _ready_bucket_at_least(self, family: str, bucket: int):
        """Smallest standard bucket ≥ ``bucket`` with a compiled shape, or
        None. Used to route work up to an already-warmed program instead of
        compiling a fresh one at the exact bucket."""
        top_std = max(self.buckets)
        with self._ready_lock:
            cands = [b for (fam, b), batches in self._ready_shapes.items()
                     if fam == family and bucket <= b <= top_std and batches]
        return min(cands) if cands else None

    def _menu_batch(self, n: int, steady: int) -> int:
        """The two-shape batch menu: ``min(128, steady)`` for small work,
        ``steady`` otherwise.

        A coarse menu (instead of power-of-two sizing) means AT MOST two
        compiled programs per (family, bucket) ever exist, and — crucially —
        different workload sizes in one process produce byte-identical
        programs, so a 10-protein run that follows a 10k-protein run (or a
        warmed server) compiles nothing. Padding a 128-row batch for 3
        proteins wastes milliseconds of device time; a third program shape
        costs a full compile + first-execution.
        """
        small = min(128, steady)
        return small if n <= small else steady

    def _pick_batch(self, family: str, bucket: int, n: int,
                    is_gcn: bool) -> int:
        """Choose (and register) the dispatch batch size for ``n`` items.

        Preference order: an already-compiled shape that fits (no compile,
        bounded padding) → the two-entry batch menu (bounded program set,
        shared across workload sizes).
        """
        steady = self._steady_batch(bucket, is_gcn)
        batch = self._ready_batch(family, bucket, n, steady)
        if batch is None:
            batch = self._menu_batch(n, steady)
        if batch % self._data_parallel:
            batch += self._data_parallel - batch % self._data_parallel
        self._register_shape(family, bucket, batch)
        return batch

    # -- public API ------------------------------------------------------------

    def _expand_mode_outputs(self, mode: str, outputs, chunk_items,
                             net: str, overflow_cb=None) -> list:
        """Fetch one mode's per-batch step outputs and expand compaction.

        ``outputs`` is a list of step results (dense arrays or top-k pairs).
        Returns the list of dense (B, n_labels) arrays; overflowed query ids
        (see ``score_topk``) are reported through ``overflow_cb(mode, qids)``.
        """
        models = self.cnn_models if net == "cnn" else self.gcn_models
        n_labels = models[mode].config.n_labels
        hosts = jax.device_get(outputs)
        dense_list, oflow = [], []
        base = 0
        for h in hosts:
            dense, ov = _expand_topk_host(h, n_labels, self.score_threshold)
            dense_list.append(dense)
            if ov is not None and ov.any():
                for j in np.nonzero(ov)[0]:
                    gi = base + int(j)
                    if gi < len(chunk_items):
                        oflow.append(chunk_items[gi][0])
            base += dense.shape[0]
        if oflow:
            logger.warning(
                "%d protein(s) have ≥ %d scores above %.3g for mode %s — "
                "top-k fetch may be threshold-incomplete for them.",
                len(oflow), self.score_topk, self.score_threshold, mode)
            if overflow_cb:
                overflow_cb(mode, oflow)
        return dense_list

    def predict_gcn(self, items: List[Tuple[str, str, np.ndarray]],
                    modes: Optional[Iterable[str]] = None,
                    progress_cb=None,
                    result_cb=None,
                    overflow_cb=None) -> Dict[str, Dict[str, np.ndarray]]:
        """Run GCN forwards for (query_id, sequence, dense_cmap) items.

        Returns {mode: {query_id: scores (n_labels,)}}. All requested modes
        are evaluated per device-resident batch. ``result_cb``, if given,
        receives each drained group's partial ``{mode: {qid: scores}}`` as
        soon as it is fetched (checkpoint streaming). ``overflow_cb(mode,
        qids)`` reports proteins whose top-k fetch may be
        threshold-incomplete (only possible when ``score_topk`` is set).
        """
        modes = list(modes) if modes is not None else list(self.gcn_models)
        return self._run(items, modes, net="gcn", progress_cb=progress_cb,
                         result_cb=result_cb, overflow_cb=overflow_cb)

    def predict_gcn_from_coords(self, items: List[tuple],
                                modes: Optional[Iterable[str]] = None,
                                progress_cb=None,
                                result_cb=None,
                                overflow_cb=None):
        """GCN forwards from (query_id, sequence, proj_coords, ins_mask).

        ``proj_coords``/``ins_mask`` come from
        :func:`metagenomic_deepfri_tpu.ops.cmap_align.project_alignment_coords`;
        adjacency construction happens on device (fused step). This is the
        production pipeline path.
        """
        modes = list(modes) if modes is not None else list(self.gcn_models)
        return self._run(items, modes, net="gcn_coords",
                         progress_cb=progress_cb, result_cb=result_cb,
                         overflow_cb=overflow_cb)

    def predict_cnn(self, items: List[Tuple[str, str]],
                    modes: Optional[Iterable[str]] = None,
                    progress_cb=None,
                    result_cb=None,
                    overflow_cb=None) -> Dict[str, Dict[str, np.ndarray]]:
        """Run CNN forwards for (query_id, sequence) items."""
        modes = list(modes) if modes is not None else list(self.cnn_models)
        return self._run(items, modes, net="cnn", progress_cb=progress_cb,
                         result_cb=result_cb, overflow_cb=overflow_cb)

    def _run(self, items, modes, net: str, progress_cb=None,
             result_cb=None, overflow_cb=None):
        out: Dict[str, Dict[str, np.ndarray]] = {m: {} for m in modes}
        if not items:
            return out
        is_gcn = net in ("gcn", "gcn_coords")
        plan = bucket_plan([len(it[1]) for it in items], self.buckets)
        # Small one-shot workloads: collapse every bucket into the largest
        # one needed. One compiled program per (net, mode) instead of one
        # per (bucket, mode) — program count, not FLOPs, dominates latency
        # for a handful of proteins (each fresh executable pays a
        # compile/load cost; padding waste is irrelevant at this scale).
        #
        # The CNN collapses at EVERY scale (standard buckets only): its conv
        # trunk costs ~0.3 MFLOP/residue, so padding the whole workload to
        # the largest needed bucket wastes milliseconds of device time while
        # saving one executable compile per (bucket, mode) — compiles are
        # seconds each. Ad-hoc
        # oversize buckets (> the configured ceiling) stay separate so one
        # 8k-residue outlier cannot drag every sequence to its length.
        max_std = max(self.buckets)
        std_buckets = [b for b in plan if b <= max_std]
        target = None
        if not is_gcn and std_buckets:
            # Collapse target prefers an ALREADY-COMPILED bucket ≥ the
            # needed top: warmup's histogram covers all query lengths, but
            # the CNN-fallback items are only the unaligned subset, so the
            # warmed top bucket can exceed max(std_buckets) here. Padding
            # a batch up costs milliseconds of conv time; a fresh
            # executable costs seconds.
            top = max(std_buckets)
            target = self._ready_bucket_at_least("cnn", top) or top
        elif std_buckets:
            # GCN: small workloads likewise prefer a warmed program ≥ the
            # needed top (a server warms only the (512, 128) shapes; a
            # request whose proteins are all short must ride them, not
            # compile at its exact bucket). The padded adjacency at
            # batch ≤ 128 costs milliseconds; a fresh executable costs
            # seconds of compile. Without a warmed
            # shape the old ≤64-item collapse-to-top applies.
            top = max(std_buckets)
            n_std = sum(len(plan[b]) for b in std_buckets)
            warm = (self._ready_bucket_at_least("gcn", top)
                    if n_std <= 128 else None)
            if warm is not None:
                target = warm
            elif len(std_buckets) > 1 and len(items) <= 64:
                target = top
        if target is not None and std_buckets != [target]:
            merged = [i for b in sorted(std_buckets) for i in plan[b]]
            plan = {b: idxs for b, idxs in plan.items() if b > max_std}
            plan[target] = merged

        family = "gcn" if is_gcn else "cnn"
        ctx = (jax.default_matmul_precision(self.matmul_precision)
               if self.matmul_precision else _nullcontext())
        with ctx:
            for bucket in sorted(plan):
                idxs = plan[bucket]
                batch = self._pick_batch(family, bucket, len(idxs), is_gcn)
                if net == "gcn_coords":
                    self._run_coords_bucket(items, idxs, bucket, batch, modes,
                                            out, progress_cb,
                                            result_cb=result_cb,
                                            overflow_cb=overflow_cb)
                    continue
                if net == "cnn":
                    self._run_cnn_bucket(items, idxs, bucket, batch, modes,
                                         out, progress_cb,
                                         result_cb=result_cb,
                                         overflow_cb=overflow_cb)
                    continue
                self._run_dense_bucket(items, idxs, bucket, batch, modes,
                                       out, progress_cb,
                                       result_cb=result_cb,
                                       overflow_cb=overflow_cb)
        return out

    def _run_dense_bucket(self, items, idxs, bucket: int, batch: int,
                          modes, out, progress_cb=None, result_cb=None,
                          overflow_cb=None):
        """Dense uint8-adjacency bucket drain (precomputed-cmap API).

        Same group/drain latency engineering as the coords path: async
        ``device_put`` of the adjacency batch, every (batch, mode) step
        dispatched before any fetch, one bulk device→host fetch per
        (group, mode) on a drain thread. The adjacency transfer itself
        stays O(B·L²) — that is this API's contract (the caller HAS dense
        cmaps); the coords path is the production alternative.
        """
        from concurrent.futures import ThreadPoolExecutor

        # adjacency dominates the group footprint: B·L² bytes per batch
        group_batches = max(1, _MAX_MEGA_BYTES // max(bucket * bucket * batch,
                                                      1))
        group_rows = group_batches * batch
        drainer = ThreadPoolExecutor(max_workers=1)
        drain_futs = []

        def drain(chunk_items, per_mode):
            group_out = {m: {} for m in modes}
            for mode in modes:
                hosts = self._expand_mode_outputs(mode, per_mode[mode],
                                                  chunk_items, "gcn",
                                                  overflow_cb)
                for i, item in enumerate(chunk_items):
                    row = hosts[i // batch][i % batch]
                    out[mode][item[0]] = row
                    group_out[mode][item[0]] = row
            if result_cb:
                result_cb(group_out)
            if progress_cb:
                progress_cb(len(chunk_items))

        try:
            for gstart in range(0, len(idxs), group_rows):
                gidx = idxs[gstart:gstart + group_rows]
                chunk_items = [items[i] for i in gidx]
                per_mode = {m: [] for m in modes}
                for start in range(0, len(gidx), batch):
                    chunk = chunk_items[start:start + batch]
                    tokens, lengths, adj = _pad_batch(chunk, bucket, batch,
                                                      True)
                    args = (jax.device_put(tokens), jax.device_put(adj),
                            jax.device_put(lengths))
                    mk = self._multi_key(modes)
                    if mk:
                        shared_p, pm = self._multi_params(mk)
                        by_mode = self._gcn_multi_dense_step(mk)(
                            shared_p, pm, *args)
                    else:
                        by_mode = {
                            m: self._gcn_step(m)(self.gcn_models[m].params,
                                                 *args) for m in modes}
                    for mode in modes:
                        per_mode[mode].append(by_mode[mode])
                drain_futs.append(
                    drainer.submit(drain, chunk_items, per_mode))
            for f in drain_futs:
                f.result()
        finally:
            drainer.shutdown(wait=True)

    def _run_cnn_bucket(self, items, idxs, bucket: int, batch: int,
                        modes, out, progress_cb=None, result_cb=None,
                        overflow_cb=None):
        """CNN bucket drain with async transfers and one fetch per mode.

        Same latency engineering as :meth:`_run_coords_bucket`: per-batch
        async ``device_put`` of the two small input arrays, no host sync
        until the whole group's scores are stacked on device.
        """
        from concurrent.futures import ThreadPoolExecutor

        group_batches = max(1, _MAX_MEGA_BYTES // max(bucket * batch, 1))
        group_rows = group_batches * batch
        drainer = ThreadPoolExecutor(max_workers=1)
        drain_futs = []

        def drain(chunk_items, per_mode):
            group_out = {m: {} for m in modes}
            for mode in modes:
                # one bulk fetch per mode; device_get drains the chunk list
                # without a device-side concat (which would recompile per
                # distinct chunk count)
                hosts = self._expand_mode_outputs(mode, per_mode[mode],
                                                  chunk_items, "cnn",
                                                  overflow_cb)
                for i, item in enumerate(chunk_items):
                    row = hosts[i // batch][i % batch]
                    out[mode][item[0]] = row
                    group_out[mode][item[0]] = row
            if result_cb:
                result_cb(group_out)
            if progress_cb:
                progress_cb(len(chunk_items))

        try:
            for gstart in range(0, len(idxs), group_rows):
                gidx = idxs[gstart:gstart + group_rows]
                chunk_items = [items[i] for i in gidx]
                per_mode = {m: [] for m in modes}
                for start in range(0, len(gidx), batch):
                    chunk = chunk_items[start:start + batch]
                    tokens, lengths, _ = _pad_batch(chunk, bucket, batch,
                                                    False)
                    tokens_d = jax.device_put(tokens)
                    lengths_d = jax.device_put(lengths)
                    by_mode = self._cnn_dispatch(modes, tokens_d, lengths_d)
                    for mode in modes:
                        per_mode[mode].append(by_mode[mode])
                drain_futs.append(
                    drainer.submit(drain, chunk_items, per_mode))
            for f in drain_futs:
                f.result()
        finally:
            drainer.shutdown(wait=True)

    def _run_coords_bucket(self, items, idxs, bucket: int, batch: int,
                           modes, out, progress_cb=None, result_cb=None,
                           overflow_cb=None):
        """Latency-optimised bucket drain for the fused coords path.

        Each batch is packed into ONE (B, L, 16) uint8 buffer and shipped with an
        async ``jax.device_put`` — transfers pipeline behind compute, so the
        link's per-transfer latency is paid once, not per batch. All (batch,
        mode) steps are dispatched without any host sync; scores are stacked
        on device and fetched with ONE device→host transfer per (group,
        mode), which turns ~5 blocking round-trips per batch into ~1 per
        group.

        Groups bound in-flight host staging memory to ~_MAX_MEGA_BYTES.
        """
        from concurrent.futures import ThreadPoolExecutor

        row_bytes = bucket * _PACK_BYTES
        group_rows = max(batch, (_MAX_MEGA_BYTES // row_bytes) // batch * batch)
        # Flat (padding-free) wire format on the single-device path; the mesh
        # path keeps the fixed (B, L, 16) layout so batches shard cleanly
        # over the data axis.
        use_flat = self.mesh is None

        def pack_one(chunk):
            if not use_flat:
                return _pack_coords_mega(chunk, bucket, batch), None
            total = sum(len(it[1]) for it in chunk)
            cap = self._flat_cap_for(total, bucket, batch)
            return _pack_coords_flat(chunk, batch, cap), cap

        # pack-ahead worker: batch k+1 is packed on a thread while batch k's
        # transfer/dispatch is in flight (numpy packing releases the GIL in
        # the copy loops enough to overlap with the async runtime).
        # drain worker: group k's device→host fetch + emit runs on its own
        # thread so packing/dispatch of group k+1 never blocks behind it
        # (one worker → groups emit in order, result_cb stays sequential).
        packer = ThreadPoolExecutor(max_workers=1)
        drainer = ThreadPoolExecutor(max_workers=1)
        drain_futs = []

        def drain(chunk_items, per_mode):
            group_out = {m: {} for m in modes}
            for mode in modes:
                # one bulk fetch per mode; device_get drains the chunk
                # list without a device-side concat (which would
                # recompile per distinct chunk count)
                hosts = self._expand_mode_outputs(mode, per_mode[mode],
                                                  chunk_items, "gcn",
                                                  overflow_cb)
                for i, item in enumerate(chunk_items):
                    row = hosts[i // batch][i % batch]
                    out[mode][item[0]] = row
                    group_out[mode][item[0]] = row
            if result_cb:
                result_cb(group_out)
            if progress_cb:
                progress_cb(len(chunk_items))

        try:
            for gstart in range(0, len(idxs), group_rows):
                gidx = idxs[gstart:gstart + group_rows]
                chunk_items = [items[i] for i in gidx]
                per_mode = {m: [] for m in modes}
                starts = list(range(0, len(gidx), batch))
                fut = packer.submit(pack_one,
                                    chunk_items[starts[0]:starts[0] + batch])
                for si, start in enumerate(starts):
                    packed, cap = fut.result()
                    if si + 1 < len(starts):
                        nxt = starts[si + 1]
                        fut = packer.submit(pack_one,
                                            chunk_items[nxt:nxt + batch])
                    x = jax.device_put(packed)  # async H2D
                    if use_flat:
                        args = self._flat_unpack(batch, bucket)(x)
                    mk = self._multi_key(modes)
                    if mk:
                        shared_p, pm = self._multi_params(mk)
                        if use_flat:
                            by_mode = self._gcn_multi_args_step(mk)(
                                shared_p, pm, *args)
                        else:
                            by_mode = self._gcn_multi_packed_step(mk)(
                                shared_p, pm, x)
                        for mode in modes:
                            per_mode[mode].append(by_mode[mode])
                        continue
                    for mode in modes:
                        params = self.gcn_models[mode].params
                        if use_flat:
                            scores = self._gcn_coords_args_step(mode)(
                                params, *args)
                        else:
                            scores = self._gcn_coords_step(mode)(params, x)
                        per_mode[mode].append(scores)
                drain_futs.append(
                    drainer.submit(drain, chunk_items, per_mode))
            for f in drain_futs:
                f.result()  # propagate fetch/callback errors
        finally:
            packer.shutdown(wait=True)
            drainer.shutdown(wait=True)

    # -- warmup --------------------------------------------------------------

    def _warm_shapes(self, expected: Optional[Dict[int, int]],
                     buckets: Optional[Sequence[int]],
                     is_gcn: bool) -> List[Tuple[int, int]]:
        """The (bucket, batch) warmup plan mirroring dispatch's choices.

        Without ``expected`` (a {bucket: item_count} histogram of the
        upcoming workload) every requested bucket warms at its steady-state
        batch — correct for long steady runs, wasteful for small ones. With
        a histogram, the plan compiles exactly what dispatch will pick:

        - CNN: one program at the largest standard bucket needed (the CNN
          collapses standard buckets at every scale — see ``_run``).
        - GCN: the steady shape for each bucket that will fill at least one
          full batch, plus ONE straggler catch-all at the largest needed
          bucket sized to the expected leftover count (the residual flush
          routes every straggler through compiled shapes).
        """
        if expected is None:
            return [(b, self._steady_batch(b, is_gcn))
                    for b in (buckets or self.buckets)]
        max_std = max(self.buckets)
        shapes: List[Tuple[int, int]] = []
        if not is_gcn:
            std = {b: c for b, c in expected.items() if b <= max_std and c}
            if std:
                top = max(std)
                shapes.append((top, self._menu_batch(
                    sum(std.values()), self._steady_batch(top, False))))
            for b, c in expected.items():
                if b > max_std and c:
                    shapes.append((b, self._menu_batch(
                        c, self._steady_batch(b, False))))
            return shapes
        residual = 0
        top_needed = 0
        for b in sorted(expected):
            c = expected[b]
            if not c:
                continue
            steady = self._steady_batch(b, True)
            if b > max_std:
                shapes.append((b, self._menu_batch(c, steady)))
                continue
            top_needed = max(top_needed, b)
            if c >= steady:
                # remainders reuse this bucket's steady shape at flush time
                shapes.append((b, steady))
            else:
                residual += c
        if residual and top_needed:
            shapes.append((top_needed, self._menu_batch(
                residual, self._steady_batch(top_needed, True))))
        return shapes

    def warmup(self, modes: Optional[Iterable[str]] = None,
               nets: Sequence[str] = ("gcn_coords", "cnn"),
               buckets: Optional[Sequence[int]] = None,
               background: bool = True,
               expected: Optional[Dict[int, int]] = None):
        """Compile + first-execute the programs dispatch will actually use.

        ``expected`` is an optional {bucket: item_count} histogram of the
        upcoming workload (e.g. from the query file's length distribution);
        with it, warmup compiles exactly the shapes production dispatch
        will pick — steady batches for buckets that fill, one straggler
        catch-all, one collapsed CNN program — instead of every bucket's
        full-size program. First execution of a fresh executable can cost
        seconds (backend compile/load); a pipeline that warms the engine
        while the CPU-side search/alignment phase runs starts inference
        hot. Dummy batches use half-bucket lengths (the typical occupancy,
        so the flat-wire capacity high-water mark lands on the production
        shape).

        Returns a ``concurrent.futures.Future`` when ``background`` (wait
        on it to observe errors), else runs synchronously.
        """
        from concurrent.futures import ThreadPoolExecutor

        def _warm_one(net: str, warm_modes, bucket: int, batch: int):
            # Same matmul-precision context as _run/stream — per THREAD,
            # because the precision config is thread-local and is part of
            # the jit trace key: warming outside it would compile every
            # executable under the wrong precision and the first real
            # batch would retrace everything (warmup would be a no-op).
            ctx = (jax.default_matmul_precision(self.matmul_precision)
                   if self.matmul_precision else _nullcontext())
            with ctx:
                is_gcn = net == "gcn_coords"
                L = max(bucket // 2, 1)
                seq = "A" * L
                if is_gcn:
                    items = [(f"_warm{i}", seq,
                              np.zeros((L, 3), np.float32),
                              np.zeros(L, bool))
                             for i in range(batch)]
                    # warm the program production dispatch will use:
                    # the multi-mode step when sharing applies, else
                    # the per-mode steps
                    mk = self._multi_key(warm_modes)
                    if self.mesh is None:
                        cap = self._flat_cap_for(batch * L, bucket, batch)
                        x = jax.device_put(
                            _pack_coords_flat(items, batch, cap))
                        args = self._flat_unpack(batch, bucket)(x)
                        if mk:
                            shared_p, pm = self._multi_params(mk)
                            outs = [self._gcn_multi_args_step(mk)(
                                shared_p, pm, *args)]
                        else:
                            outs = [self._gcn_coords_args_step(m)(
                                self.gcn_models[m].params, *args)
                                for m in warm_modes]
                    else:
                        x = jax.device_put(
                            _pack_coords_mega(items, bucket, batch))
                        if mk:
                            shared_p, pm = self._multi_params(mk)
                            outs = [self._gcn_multi_packed_step(mk)(
                                shared_p, pm, x)]
                        else:
                            outs = [self._gcn_coords_step(m)(
                                self.gcn_models[m].params, x)
                                for m in warm_modes]
                else:
                    tokens, lengths, _ = _pad_batch(
                        [(f"_warm{i}", seq) for i in range(batch)],
                        bucket, batch, False)
                    t_d = jax.device_put(tokens)
                    l_d = jax.device_put(lengths)
                    outs = list(self._cnn_dispatch(
                        warm_modes, t_d, l_d).values())
                jax.block_until_ready(outs)

        def _run_warmup():
            # One thread per program shape: distinct executables compile
            # concurrently, so total warm latency approaches the slowest
            # single program, not the sum.
            tasks = []
            for net in nets:
                handles = (self.gcn_models if net == "gcn_coords"
                           else self.cnn_models)
                warm_modes = [m for m in (modes or handles) if m in handles]
                if not warm_modes:
                    continue
                family = "gcn" if net == "gcn_coords" else "cnn"
                for bucket, batch in self._warm_shapes(
                        expected, buckets, net == "gcn_coords"):
                    if batch % self._data_parallel:
                        batch += (self._data_parallel
                                  - batch % self._data_parallel)
                    # registered before compiling so concurrent dispatch
                    # reuses (and blocks on) this shape instead of
                    # compiling a second one
                    self._register_shape(family, bucket, batch)
                    tasks.append((net, warm_modes, bucket, batch))
            if not tasks:
                return
            with ThreadPoolExecutor(
                    max_workers=min(8, len(tasks)),
                    thread_name_prefix="engine-warm") as pool:
                futs = [pool.submit(_warm_one, *t) for t in tasks]
                for f in futs:
                    f.result()
            logger.info("Engine warm: %d program shape(s) compiled for %s.",
                        len(tasks), list(nets))

        if not background:
            _run_warmup()
            return None
        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="engine-warmup")
        fut = pool.submit(_run_warmup)
        pool.shutdown(wait=False)
        return fut

    # -- streaming API -------------------------------------------------------

    def predict_stream(self, items_iter, net: str = "gcn_coords",
                       modes: Optional[Iterable[str]] = None,
                       result_cb=None, progress_cb=None,
                       overflow_cb=None,
                       max_inflight: int = 8) -> int:
        """Bounded-memory streaming inference over an item *iterator*.

        For catalogue-scale runs (BASELINE config 4/5: 100k–1M proteins) the
        full work list never materialises: items are consumed from the
        iterator, buffered per length bucket, dispatched as soon as a bucket
        fills a batch, and results stream out through ``result_cb`` (e.g.
        the prediction checkpoint). At most ``max_inflight`` undrained
        batches exist at any time, so host memory is O(batch · buckets).

        ``net``: 'gcn_coords' (items = (id, seq, proj_coords, ins_mask)) or
        'cnn' (items = (id, seq)). Returns the number of proteins processed.
        """
        from concurrent.futures import ThreadPoolExecutor

        if net not in ("gcn_coords", "cnn"):
            raise ValueError(f"streaming supports gcn_coords/cnn, got {net}")
        is_gcn = net == "gcn_coords"
        models = self.gcn_models if is_gcn else self.cnn_models
        modes = list(modes) if modes is not None else list(models)

        buffers: Dict[int, list] = {}
        processed = 0
        # Device→host fetches run on ONE drain worker (ordered — checkpoint
        # parts stay sequential) so a slow link never serialises with
        # packing/dispatch of the next batches; the semaphore bounds
        # undrained batches exactly like the old inline-drain deque did.
        drainer = ThreadPoolExecutor(max_workers=1,
                                     thread_name_prefix="stream-drain")
        slots = threading.Semaphore(max_inflight)
        drain_futs: list = []

        def drain(chunk, scores):
            try:
                emit = {m: {} for m in modes}
                for m in modes:
                    host = self._expand_mode_outputs(
                        m, [scores[m]], chunk,
                        "cnn" if not is_gcn else "gcn", overflow_cb)[0]
                    for i, item in enumerate(chunk):
                        emit[m][item[0]] = host[i]
                if result_cb:
                    result_cb(emit)
                if progress_cb:
                    progress_cb(len(chunk))
            finally:
                slots.release()

        family = "gcn" if is_gcn else "cnn"

        def dispatch(bucket, chunk):
            # Full buckets hit the steady-state shape; partial flushes
            # reuse ANY already-compiled shape that fits (warmup seeds
            # these from the workload's length histogram) before falling
            # back to a fresh power-of-two program. _pick_batch never
            # proposes a shape above steady, so a chunk larger than the
            # picked batch (merged stragglers under a small batch_cap, an
            # ad-hoc oversize bucket) is split here — the packers index
            # chunk[0:batch] and would read out of bounds otherwise.
            batch = self._pick_batch(family, bucket, len(chunk), is_gcn)
            for start in range(0, len(chunk), batch):
                dispatch_one(bucket, chunk[start:start + batch], batch)

        def dispatch_one(bucket, chunk, batch):
            nonlocal processed
            slots.acquire()  # bound undrained batches (host + HBM refs)
            # Fail fast on drain/callback errors: a failed checkpoint write
            # must stop a catalogue run within max_inflight batches, not
            # after hours of further compute (completed futures only —
            # never block the pipeline here; done-ok futures are pruned so
            # the list stays O(max_inflight) on million-protein streams).
            for f in list(drain_futs):
                if f.done():
                    if f.exception() is not None:
                        raise f.exception()
                    drain_futs.remove(f)
            scores = {}
            if is_gcn:
                mk = self._multi_key(modes)
                if self.mesh is None:
                    total = sum(len(it[1]) for it in chunk)
                    cap = self._flat_cap_for(total, bucket, batch)
                    x = jax.device_put(_pack_coords_flat(chunk, batch, cap))
                    args = self._flat_unpack(batch, bucket)(x)
                    if mk:
                        shared_p, pm = self._multi_params(mk)
                        scores = dict(self._gcn_multi_args_step(mk)(
                            shared_p, pm, *args))
                    else:
                        for m in modes:
                            scores[m] = self._gcn_coords_args_step(m)(
                                models[m].params, *args)
                else:
                    x = jax.device_put(_pack_coords_mega(chunk, bucket,
                                                         batch))
                    if mk:
                        shared_p, pm = self._multi_params(mk)
                        scores = dict(self._gcn_multi_packed_step(mk)(
                            shared_p, pm, x))
                    else:
                        for m in modes:
                            scores[m] = self._gcn_coords_step(m)(
                                models[m].params, x)
            else:
                tokens, lengths, _ = _pad_batch(chunk, bucket, batch, False)
                t_d = jax.device_put(tokens)
                l_d = jax.device_put(lengths)
                scores = self._cnn_dispatch(modes, t_d, l_d)
            drain_futs.append(drainer.submit(drain, chunk, scores))
            processed += len(chunk)

        ctx = (jax.default_matmul_precision(self.matmul_precision)
               if self.matmul_precision else _nullcontext())
        try:
            with ctx:
                for item in items_iter:
                    bucket = assign_bucket(len(item[1]), self.buckets)
                    buf = buffers.setdefault(bucket, [])
                    buf.append(item)
                    if len(buf) >= self._steady_batch(bucket, is_gcn):
                        dispatch(bucket, buf)
                        buffers[bucket] = []
                self._flush_residual(buffers, family, is_gcn, dispatch)
            for f in drain_futs:
                f.result()  # propagate fetch/callback errors, in order
        finally:
            drainer.shutdown(wait=True)
        return processed

    def _flush_residual(self, buffers, family: str, is_gcn: bool,
                        dispatch) -> None:
        """End-of-stream straggler flush, engineered to avoid fresh compiles.

        Per bucket, stragglers whose count fits an already-compiled shape
        dispatch there directly. Everything else merges into the smallest
        compiled (bucket, batch) that fits the longest leftover (chunked if
        needed): padding a handful of batches up costs milliseconds, while
        each avoided straggler program costs a multi-second compile. Only
        when no compiled shape exists at all does the old small-run
        behaviour apply (merge ≤ 64 into the top bucket, else per-bucket
        power-of-two programs).
        """
        residual = {b: buf for b, buf in buffers.items() if buf}
        if not residual:
            return
        leftovers: list = []
        max_needed = 0
        for bucket in sorted(residual):
            buf = residual[bucket]
            steady = self._steady_batch(bucket, is_gcn)
            if self._ready_batch(family, bucket, len(buf), steady) is not None:
                dispatch(bucket, buf)
            else:
                leftovers.extend(buf)
                max_needed = max(max_needed, bucket)
        if not leftovers:
            return
        # smallest compiled bucket that can hold the longest leftover
        with self._ready_lock:
            cands = sorted(
                (b, max(batches))
                for (fam, b), batches in self._ready_shapes.items()
                if fam == family and b >= max_needed and batches)
        if cands:
            bucket, batch = cands[0]
            for start in range(0, len(leftovers), batch):
                dispatch(bucket, leftovers[start:start + batch])
            return
        if len(residual) > 1 and len(leftovers) <= 64:
            dispatch(max_needed, leftovers)
            return
        regroup = bucket_plan([len(it[1]) for it in leftovers], self.buckets)
        for bucket in sorted(regroup):
            dispatch(bucket, [leftovers[i] for i in regroup[bucket]])


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
