"""Contact-map-to-query alignment.

Replaces the reference's Cython/OpenMP scatter kernel ``align_contact_map``
(reference ``mDeepFRI/contact_map_utils.pyx:44-117``): mapping a target
protein's contacts through a gapped query↔target alignment onto query residue
indices, synthesising local contacts for query insertions, and emitting a
dense binary query contact map with an identity diagonal.

On the device, instead of a serial scatter, the remapping is expressed as a
projection ``A_q = P · A_t · Pᵀ`` where ``P`` is the (Q, T) 0/1 selection
matrix derived from the alignment — two batched matmuls — OR-ed with the
identity diagonal and a banded insertion-neighbourhood mask. This is the
batched "alignment feeds adjacency construction" kernel of BASELINE config 3.

The host (numpy) implementation keeps exact semantics parity with the
reference (golden tests ported from ``tests/test_contact_map_utils.py``).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

GAP = "-"


def alignment_index_map(query_alignment: str,
                        target_alignment: str,
                        generated_contacts: int = 2):
    """Decode a gapped alignment into index maps.

    Mirrors the column walk at reference ``contact_map_utils.pyx:60-80``.

    Returns:
        target_to_query: (T_align,) int32 — query index for each consumed
            target residue, -1 where the query has a gap (deletion).
        insertion_positions: (K,) int32 — query indices aligned to target
            gaps (insertions); these receive ``generated_contacts`` synthetic
            neighbour contacts.
        query_len: int — number of query residues consumed (output map size).
    """
    if len(query_alignment) != len(target_alignment):
        raise ValueError("Gapped query and target must have equal length")
    target_to_query = []
    insertions = []
    q = 0
    for qc, tc in zip(query_alignment, target_alignment):
        if qc == GAP:
            target_to_query.append(-1)
        else:
            if tc == GAP:
                insertions.append(q)
            else:
                target_to_query.append(q)
            q += 1
    return (np.asarray(target_to_query, dtype=np.int32),
            np.asarray(insertions, dtype=np.int32), q)


def align_contact_map(query_alignment: str,
                      target_alignment: str,
                      sparse_target_contact_map: np.ndarray,
                      generated_contacts: int = 2,
                      threads: int = 1) -> np.ndarray:
    """Dense (Q, Q) int32 aligned contact map — reference-parity host path.

    Drop-in for reference ``contact_map_utils.pyx:44-117`` (the ``threads``
    arg is accepted for API parity; the numpy path is already vectorised).
    """
    del threads
    t2q, insertions, qlen = alignment_index_map(query_alignment,
                                                target_alignment)
    out = np.zeros((qlen, qlen), dtype=np.int32)
    np.fill_diagonal(out, 1)

    # Synthetic neighbour contacts around insertions
    # (reference contact_map_utils.pyx:69-76, bounds check :95).
    for q in insertions:
        for j in range(1, generated_contacts + 1):
            for p1, p2 in ((q + j, q), (q - j, q)):
                if 0 <= p1 < qlen and 0 <= p2 < qlen:
                    out[p1, p2] = 1
                    out[p2, p1] = 1

    contacts = np.asarray(sparse_target_contact_map, dtype=np.int64)
    if contacts.size:
        ti, tj = contacts[:, 0], contacts[:, 1]
        in_range = (ti < t2q.shape[0]) & (tj < t2q.shape[0])
        ti, tj = ti[in_range], tj[in_range]
        qi, qj = t2q[ti], t2q[tj]
        mapped = (qi >= 0) & (qj >= 0)
        # Adjacency is symmetric; the reference relies on its sparse input
        # containing both (i, j) and (j, i) (argwhere of a symmetric matrix,
        # bio_utils.py:223) — we symmetrise explicitly, matching the expected
        # matrices in the reference's own golden tests.
        out[qi[mapped], qj[mapped]] = 1
        out[qj[mapped], qi[mapped]] = 1
    return out


# ---------------------------------------------------------------------------
# Device path: batched projection A_q = P A_t Pᵀ  ∨  I  ∨  insertion band.
# ---------------------------------------------------------------------------

def build_projection_arrays(query_alignment: str,
                            target_alignment: str,
                            pad_q: int,
                            pad_t: int):
    """Host-side prep of per-protein projection inputs for the device kernel.

    Returns (q_to_t (pad_q,) int32 with -1 for unmapped/insertion/padding,
    insertion_mask (pad_q,) bool, query_len int). ``q_to_t`` is the inverse of
    the reference's target→query map restricted to matched columns.
    """
    t2q, insertions, qlen = alignment_index_map(query_alignment,
                                                target_alignment)
    if qlen > pad_q:
        raise ValueError(f"query length {qlen} exceeds pad_q={pad_q}")
    q_to_t = np.full(pad_q, -1, dtype=np.int32)
    t_res = np.nonzero(t2q >= 0)[0]
    q_to_t[t2q[t_res]] = t_res
    ins_mask = np.zeros(pad_q, dtype=bool)
    ins_mask[insertions] = True
    if np.any(q_to_t >= pad_t):
        raise ValueError("target alignment longer than pad_t")
    return q_to_t, ins_mask, qlen


# Sentinel coordinates for unmapped query positions: far from every real CA
# coordinate and from each other, so they produce no spurious contacts while
# keeping the gather shape static.
_SENTINEL_BASE = 1.0e6
_SENTINEL_SPACING = 1.0e3


def project_alignment_coords(query_alignment: str,
                             target_alignment: str,
                             target_coords: np.ndarray):
    """Host prep: gather target CA coords into query indexing.

    The reference materialises the target's full sparse contact map and
    scatters it through the alignment (``contact_map_utils.pyx:44-117``).
    Observation: for matched pairs, ``aligned[qi, qj] =
    contact(t_coords[q_to_t[qi]], t_coords[q_to_t[qj]])`` — so gathering the
    (Q, 3) coordinates through the alignment and thresholding ON DEVICE is
    mathematically identical, and ships O(Q) floats instead of an O(Q²)
    matrix. Unmapped positions get far-apart sentinel coordinates.

    Returns:
        proj_coords: (Q, 3) float32 gathered coords (sentinels where
            unmapped), insertion_mask: (Q,) bool, query_len: int.
    Raises:
        IndexError/ValueError on malformed alignments (same failure surface
        as the reference's scatter, caught by ``build_align_contact_map``).
    """
    t2q, insertions, qlen = alignment_index_map(query_alignment,
                                                target_alignment)
    target_coords = np.asarray(target_coords, dtype=np.float32)
    q_to_t = np.full(qlen, -1, dtype=np.int32)
    t_res = np.nonzero(t2q >= 0)[0]
    q_to_t[t2q[t_res]] = t_res
    mapped = q_to_t >= 0
    if np.any(q_to_t >= target_coords.shape[0]):
        raise IndexError("alignment addresses residues beyond target coords")
    proj = np.empty((qlen, 3), dtype=np.float32)
    proj[mapped] = target_coords[q_to_t[mapped]]
    unmapped_pos = np.nonzero(~mapped)[0]
    proj[~mapped, 0] = _SENTINEL_BASE + _SENTINEL_SPACING * unmapped_pos
    proj[~mapped, 1:] = 0.0
    ins_mask = np.zeros(qlen, dtype=bool)
    ins_mask[insertions] = True
    return proj, ins_mask, qlen


def aligned_contacts_from_coords(proj_coords: jnp.ndarray,
                                 insertion_mask: jnp.ndarray,
                                 lengths: jnp.ndarray,
                                 threshold: float = 6.0,
                                 generated_contacts: int = 2) -> jnp.ndarray:
    """Device: aligned adjacency from projected coords (no O(L²) transfer).

    Jit-inline-able core of the fused GCN step: threshold the pairwise
    squared distances of the gathered coordinates (exact f32 difference form
    elementwise), OR in the identity diagonal and the insertion band, zero
    the padding.

    Args:
        proj_coords: (B, Q, 3) from :func:`project_alignment_coords`, padded
            arbitrarily beyond length.
        insertion_mask: (B, Q) bool.
        lengths: (B,) int32 query lengths.

    Returns:
        (B, Q, Q) float32 adjacency — identical to the host
        :func:`align_contact_map` on the valid block.
    """
    from metagenomic_deepfri_tpu.ops.contact import \
        _pairwise_sqeuclidean_device

    dist = _pairwise_sqeuclidean_device(proj_coords)
    contacts = dist < threshold ** 2

    B, Q = insertion_mask.shape
    pos = jnp.arange(Q, dtype=jnp.int32)
    # Sentinel self-distance is exactly 0 → diagonal handled by `eye`;
    # sentinel off-diagonal pairs are masked out via `real` below.
    eye = pos[:, None] == pos[None, :]
    offset = jnp.abs(pos[:, None] - pos[None, :])
    band = (offset > 0) & (offset <= generated_contacts)
    ins = insertion_mask
    ins_pairs = band[None] & (ins[:, :, None] | ins[:, None, :])

    unmapped = proj_coords[:, :, 0] >= _SENTINEL_BASE * 0.5
    real = ~unmapped
    contacts = contacts & real[:, :, None] & real[:, None, :]

    out = contacts | eye[None] | ins_pairs
    valid = pos[None, :] < lengths[:, None]
    mask2d = valid[:, :, None] & valid[:, None, :]
    return (out & mask2d).astype(jnp.float32)


@partial(jax.jit, static_argnames=("generated_contacts",))
def batched_align_contact_maps(target_cmaps: jnp.ndarray,
                               q_to_t: jnp.ndarray,
                               insertion_mask: jnp.ndarray,
                               query_lengths: jnp.ndarray,
                               generated_contacts: int = 2) -> jnp.ndarray:
    """Remap a batch of target contact maps onto query indexing on device.

    Args:
        target_cmaps: (B, T, T) float 0/1 target adjacency (with diagonal).
        q_to_t: (B, Q) int32 — target index for each query position, -1 if the
            query position has no matched target residue (insertion/padding).
        insertion_mask: (B, Q) bool — query positions aligned to target gaps.
        query_lengths: (B,) int32.
        generated_contacts: half-width of the synthetic contact band around
            insertions (reference ``generated_contacts=2``).

    Returns:
        (B, Q, Q) float32 aligned adjacency, identity diagonal on valid rows,
        padded region zeroed. Matches :func:`align_contact_map` exactly on the
        valid (Q, Q) block.
    """
    B, Q = q_to_t.shape
    T = target_cmaps.shape[-1]
    mapped = q_to_t >= 0
    safe_idx = jnp.where(mapped, q_to_t, 0)
    # P as one-hot selection: (B, Q, T); XLA lowers P·A·Pᵀ to two matmuls.
    P = jax.nn.one_hot(safe_idx, T, dtype=target_cmaps.dtype)
    P = P * mapped[..., None].astype(target_cmaps.dtype)
    projected = jnp.einsum("bqt,btu,bru->bqr", P, target_cmaps, P,
                           preferred_element_type=jnp.float32)

    pos = jnp.arange(Q, dtype=jnp.int32)
    valid = pos[None, :] < query_lengths[:, None]
    eye = jnp.eye(Q, dtype=jnp.float32)[None]

    # Insertion band: pairs (i, j), 0 < |i-j| <= g, with i or j an insertion
    # (symmetrised form of reference contact_map_utils.pyx:69-76).
    offset = jnp.abs(pos[:, None] - pos[None, :])
    band = (offset > 0) & (offset <= generated_contacts)
    ins = insertion_mask
    ins_pairs = band[None] & (ins[:, :, None] | ins[:, None, :])

    out = jnp.maximum(projected, eye)
    out = jnp.maximum(out, ins_pairs.astype(jnp.float32))
    mask2d = (valid[:, :, None] & valid[:, None, :]).astype(jnp.float32)
    return out * mask2d
