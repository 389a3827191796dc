"""Edge-partitioned GraphConv aggregation across a device mesh.

The BASELINE north star's graph analogue of sequence parallelism: partition
the packed protein-graph batch's NODE dimension across devices, and compute
each device's rows of ``Â·X`` while the node features ride a ring of
``ppermute`` exchanges between devices — local tile contraction can overlap
with the next shard's transfer (XLA may schedule the collective-permute
asynchronously against the matmul).

Key design choice: the adjacency is NEVER communicated. Each device
recomputes its (rows_own × cols_visiting) adjacency block from the
*replicated* O(L) projected CA coordinates — coordinates are ~3
floats/residue, so replication costs nothing, while the O(L²) adjacency
would dominate the traffic between devices. Per ring step a device
sends/receives only its (B, L/n, D) feature shard: total bytes moved equal a
standard all-gather of X, the minimum any edge partition needs.

The reference has no multi-device execution at all (SURVEY.md §2.3).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from metagenomic_deepfri_tpu.ops.cmap_align import _SENTINEL_BASE
from metagenomic_deepfri_tpu.parallel.mesh import MODEL_AXIS


def _contact_block(coords, ins_mask, lengths, r0, c0, Ls: int,
                   threshold: float, generated_contacts: int):
    """(B, Ls, Ls) aligned-adjacency block A[:, r0:r0+Ls, c0:c0+Ls].

    Same semantics as ``aligned_contacts_from_coords`` restricted to a block;
    ``r0``/``c0`` may be traced (shard/ring indices).
    """
    B = coords.shape[0]
    rows = jax.lax.dynamic_slice_in_dim(coords, r0, Ls, axis=1)
    cols = jax.lax.dynamic_slice_in_dim(coords, c0, Ls, axis=1)
    ins_r = jax.lax.dynamic_slice_in_dim(ins_mask, r0, Ls, axis=1)
    ins_c = jax.lax.dynamic_slice_in_dim(ins_mask, c0, Ls, axis=1)

    # Exact f32 per-axis difference form — the Gram/matmul identity may run
    # in TF32 on the GPU and flip near-threshold contacts (see
    # ops.contact._pairwise_sqeuclidean_device).
    dist = jnp.zeros((B, Ls, Ls), jnp.float32)
    for axis_k in range(3):
        d = rows[:, :, axis_k][:, :, None] - cols[:, :, axis_k][:, None, :]
        dist = dist + d * d
    contact = dist < threshold ** 2

    real_r = rows[:, :, 0] < _SENTINEL_BASE * 0.5
    real_c = cols[:, :, 0] < _SENTINEL_BASE * 0.5
    contact = contact & real_r[:, :, None] & real_c[:, None, :]

    pos = jnp.arange(Ls, dtype=jnp.int32)
    row_ids = (r0 + pos)[None, :, None]
    col_ids = (c0 + pos)[None, None, :]
    eye = row_ids == col_ids
    offset = jnp.abs(row_ids - col_ids)
    band = (offset > 0) & (offset <= generated_contacts)
    ins_pairs = band & (ins_r[:, :, None].astype(bool)
                        | ins_c[:, None, :].astype(bool))

    valid = (row_ids < lengths[:, None, None]) & (
        col_ids < lengths[:, None, None])
    return ((contact | eye | ins_pairs) & valid).astype(jnp.float32)


def make_edge_partitioned_aggregate(mesh: Mesh, L: int, D: int,
                                    threshold: float = 6.0,
                                    generated_contacts: int = 2,
                                    axis: str = MODEL_AXIS):
    """Build a jitted node-sharded aggregation: out = Â(coords)·x.

    Args:
        mesh: device mesh with a named ``axis`` of size n; L % n == 0.
        L, D: full node dimension and feature dimension (static).

    Returns:
        fn(coords (B, L, 3) replicated, ins_mask (B, L) f32 replicated,
           lengths (B,) replicated, x (B, L, D) sharded over ``axis``)
        -> (B, L, D) sharded over ``axis``.
    """
    n = mesh.shape[axis]
    if L % n:
        raise ValueError(f"L={L} not divisible by axis size {n}")
    Ls = L // n

    def local_fn(coords, ins_mask, lengths, x_shard):
        k = jax.lax.axis_index(axis)
        r0 = k * Ls

        def ring_step(step, carry):
            acc, cur = carry
            # whose shard are we holding? ring rotates shards downward:
            # after s steps we hold shard (k + s) mod n.
            src = (k + step) % n
            block = _contact_block(coords, ins_mask, lengths, r0, src * Ls,
                                   Ls, threshold, generated_contacts)
            acc = acc + jnp.einsum("bij,bjd->bid", block, cur,
                                   preferred_element_type=jnp.float32)
            nxt = jax.lax.ppermute(
                cur, axis, perm=[(i, (i - 1) % n) for i in range(n)])
            return acc, nxt

        B = x_shard.shape[0]
        acc = jnp.zeros((B, Ls, D), jnp.float32)
        # mark the carry as device-varying over the ring axis so the scan
        # carry type matches the ppermute-produced output
        acc = jax.lax.pcast(acc, (axis,), to="varying")
        acc, _ = jax.lax.fori_loop(0, n, ring_step, (acc, x_shard))
        return acc

    mapped = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(None, axis, None)),
        out_specs=P(None, axis, None))
    return jax.jit(
        mapped,
        in_shardings=(NamedSharding(mesh, P()), NamedSharding(mesh, P()),
                      NamedSharding(mesh, P()),
                      NamedSharding(mesh, P(None, axis, None))),
        out_shardings=NamedSharding(mesh, P(None, axis, None)))


def _row_degrees_local(coords, ins_mask, lengths, r0, Ls: int, n: int,
                       threshold: float, generated_contacts: int,
                       axis: str = MODEL_AXIS):
    """(B, Ls) degrees of this chip's adjacency rows, no communication.

    Coordinates are replicated, so each chip sums its row-block against all
    n column blocks locally — O(L·Ls) work, same as one ring pass.
    """
    L = coords.shape[1]
    B = coords.shape[0]

    def block_sum(j, acc):
        block = _contact_block(coords, ins_mask, lengths, r0, j * Ls, Ls,
                               threshold, generated_contacts)
        return acc + jnp.sum(block, axis=2)

    acc0 = jnp.zeros((B, Ls), jnp.float32)
    # r0 is device-varying (axis_index), so the carry must be too
    acc0 = jax.lax.pcast(acc0, (axis,), to="varying")
    return jax.lax.fori_loop(0, n, block_sum, acc0)


def make_graph_sharded_gcn_forward(mesh: Mesh, config, L: int,
                                   threshold: float = 6.0,
                                   generated_contacts: int = 2,
                                   axis: str = MODEL_AXIS):
    """Full GCN forward with the node dimension sharded across ``axis``.

    The long-protein path (graph analogue of sequence parallelism): each
    chip holds L/n rows of the GraphConv state, aggregation runs the
    ppermute ring (adjacency recomputed per block from replicated O(L)
    coordinates — never materialised, never communicated), degrees are
    computed locally per row-shard and all-gathered ((B, L) floats — tiny),
    and the pooled representation is a ``psum`` over shards. The LSTM-LM
    branch is replicated: an RNN scan has no intra-sequence parallelism, so
    replication costs the same wall-clock as one chip and avoids any
    communication. FC stack and head run replicated on the pooled vector.

    Per-chip adjacency working set is O(L·L/n) instead of O(L²) — the
    enabler for proteins whose dense map exceeds one chip's memory.

    Returns a jitted fn(params, tokens (B, L) u8, coords (B, L, 3),
    ins_mask (B, L) bool, lengths (B,)) -> (B, n_labels) f32 replicated;
    identical math to ``gcn_forward`` on
    ``aligned_contacts_from_coords`` inputs (tested on the CPU mesh).
    """
    from metagenomic_deepfri_tpu.models.deepfri import _dense
    from metagenomic_deepfri_tpu.models.lstm import lstm_stack_forward
    from metagenomic_deepfri_tpu.ops.one_hot import tokens2onehot

    n = mesh.shape[axis]
    if L % n:
        raise ValueError(f"L={L} not divisible by axis size {n}")
    Ls = L // n

    def local_fn(params, tokens, coords, ins_mask, lengths):
        k = jax.lax.axis_index(axis)
        r0 = k * Ls
        B = tokens.shape[0]

        onehot = tokens2onehot(tokens, dtype=jnp.float32)
        pos = jnp.arange(L, dtype=jnp.int32)
        valid = (pos[None, :] < lengths[:, None]).astype(jnp.float32)
        onehot = onehot * valid[:, :, None]

        lm_out = lstm_stack_forward(params["lm"], onehot, lengths)
        x_full = jax.nn.relu(_dense(params["lm_embed"], lm_out)
                             + _dense(params["aa_embed"], onehot))
        x_shard = jax.lax.dynamic_slice_in_dim(x_full, r0, Ls, axis=1)

        ins_f = ins_mask.astype(jnp.float32)
        deg_local = _row_degrees_local(coords, ins_f, lengths, r0, Ls, n,
                                       threshold, generated_contacts,
                                       axis=axis)
        # full degree vector: adjacency is symmetric, so column degrees ==
        # all-gathered row degrees
        deg_full = jax.lax.all_gather(deg_local, axis,
                                      axis=1, tiled=True)      # (B, L)
        if config.adj_norm == "sym":
            inv = jnp.where(deg_full > 0,
                            jax.lax.rsqrt(jnp.maximum(deg_full, 1e-12)), 0.0)
            col_scale = row_scale = inv
        elif config.adj_norm == "row":
            inv = jnp.where(deg_full > 0,
                            1.0 / jnp.maximum(deg_full, 1e-12), 0.0)
            col_scale = jnp.ones_like(deg_full)
            row_scale = inv
        else:
            col_scale = row_scale = jnp.ones_like(deg_full)
        row_scale_own = jax.lax.dynamic_slice_in_dim(row_scale, r0, Ls,
                                                     axis=1)
        col_scale_own = jax.lax.dynamic_slice_in_dim(col_scale, r0, Ls,
                                                     axis=1)

        def aggregate(x_sh):
            def ring_step(step, carry):
                acc, cur = carry
                src = (k + step) % n
                block = _contact_block(coords, ins_f, lengths, r0, src * Ls,
                                       Ls, threshold, generated_contacts)
                acc = acc + jnp.einsum("bij,bjd->bid", block, cur,
                                       preferred_element_type=jnp.float32)
                nxt = jax.lax.ppermute(
                    cur, axis, perm=[(i, (i - 1) % n) for i in range(n)])
                return acc, nxt

            acc = jnp.zeros((B, Ls, x_sh.shape[-1]), jnp.float32)
            acc = jax.lax.pcast(acc, (axis,), to="varying")
            acc, _ = jax.lax.fori_loop(0, n, ring_step, (acc, x_sh))
            return acc

        from metagenomic_deepfri_tpu.models.deepfri import graphconv_apply

        x = x_shard
        gc_outputs = []
        for layer in params["gc"]:
            agg = aggregate(x * col_scale_own[:, :, None])
            agg = agg * row_scale_own[:, :, None]
            x = graphconv_apply(layer, agg, agg.dtype)
            gc_outputs.append(x)
        concat = jnp.concatenate(gc_outputs, axis=-1)

        valid_own = jax.lax.dynamic_slice_in_dim(valid, r0, Ls, axis=1)
        pooled = jnp.sum(concat * valid_own[:, :, None], axis=1)
        pooled = jax.lax.psum(pooled, axis)
        if getattr(config, "pool", "sum") == "mean":
            pooled = pooled / jnp.maximum(lengths, 1).astype(
                pooled.dtype)[:, None]

        for layer in params["fc"]:
            pooled = jax.nn.relu(_dense(layer, pooled))
        from metagenomic_deepfri_tpu.models.deepfri import _head_scores
        return _head_scores(params["head"], pooled, config.n_labels)

    mapped = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P())
    rep = NamedSharding(mesh, P())
    return jax.jit(mapped,
                   in_shardings=(rep, rep, rep, rep, rep),
                   out_shardings=rep)
