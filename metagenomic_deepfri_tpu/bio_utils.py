"""Structure-processing glue (reference ``mDeepFRI/bio_utils.py`` parity).

Re-exports the structure parsers (:mod:`.data.structures`) and contact-map
kernels (:mod:`.ops.contact`, :mod:`.ops.cmap_align`), and provides
``build_align_contact_map`` — the per-protein orchestration the pipeline maps
over hits (reference ``bio_utils.py:348-385``), including its error contract:
failures return ``(alignment, None)`` with a warning rather than raising.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

from metagenomic_deepfri_tpu.align.pairwise import AlignmentResult
from metagenomic_deepfri_tpu.data.structures import (  # noqa: F401
    SUBSTITUTIONS as substitutions, extract_residues_coordinates,
    get_residues_coordinates, load_structure)
from metagenomic_deepfri_tpu.ops.cmap_align import align_contact_map
from metagenomic_deepfri_tpu.ops.contact import (  # noqa: F401
    calculate_contact_map, pairwise_sqeuclidean)

logger = logging.getLogger(__name__)


def build_align_contact_map(
        alignment: AlignmentResult,
        threshold: float = 6,
        generated_contacts: int = 2
) -> Tuple[AlignmentResult, Optional[np.ndarray]]:
    """Target coords → sparse cmap → remap onto query indexing.

    Reference semantics (``bio_utils.py:348-385``): missing coordinates or an
    indexing failure (malformed PDB entries, ~10% of PDB100 hits per
    reference README.md:88-89) log a warning and return ``(alignment, None)``
    so the pipeline can rescue the query via a predicted-structure DB.
    """
    idx = alignment.target_name.rsplit(".", 1)[0]
    coordinates = alignment.coords
    if coordinates is None:
        logger.warning("No coordinates found for %s.", alignment.target_name)
        return (alignment, None)
    cmap = calculate_contact_map(coordinates, threshold=threshold,
                                 mode="sparse")
    try:
        aligned_cmap = align_contact_map(alignment.gapped_sequence,
                                         alignment.gapped_target, cmap,
                                         generated_contacts)
    except (IndexError, ValueError):
        logger.warning(
            "Error aligning contact map for target %s against %s.",
            idx, alignment.query_name)
        aligned_cmap = None
    return (alignment, aligned_cmap)


def build_align_projection(
        alignment: AlignmentResult
) -> Tuple[AlignmentResult, Optional[tuple]]:
    """Target coords → query-indexed coordinate projection (fused-path prep).

    The production path: instead of materialising the O(L²) aligned
    contact map on host (``build_align_contact_map``), gather the target CA
    coordinates through the alignment (O(L)) and let the device build the
    adjacency inside the fused GCN step
    (:func:`metagenomic_deepfri_tpu.ops.cmap_align.project_alignment_coords`).

    Same failure surface as the reference's scatter (reference
    ``bio_utils.py:348-385``): missing coordinates or malformed alignments
    return ``(alignment, None)`` so the query can be rescued by a later DB
    or fall back to sequence-only prediction.
    """
    from metagenomic_deepfri_tpu.ops.cmap_align import project_alignment_coords

    idx = alignment.target_name.rsplit(".", 1)[0]
    coordinates = alignment.coords
    if coordinates is None:
        logger.warning("No coordinates found for %s.", alignment.target_name)
        return (alignment, None)
    try:
        proj, ins_mask, qlen = project_alignment_coords(
            alignment.gapped_sequence, alignment.gapped_target, coordinates)
    except (IndexError, ValueError):
        logger.warning(
            "Error aligning contact map for target %s against %s.",
            idx, alignment.query_name)
        return (alignment, None)
    return (alignment, (proj, ins_mask))
