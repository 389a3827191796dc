"""Length bucketing for variable-size protein batches under XLA static shapes.

The reference mitigates variable length only by sorting proteins by length
for locality (reference ``pipeline.py:528-533``); every forward is still its
own dynamically-shaped ONNX call. Under XLA we need a small, fixed set of
compiled shapes: sequences are padded up to bucket boundaries, and the batch
size per bucket is chosen so the dominant O(B·L²) adjacency footprint stays
roughly constant (constant device memory, near-constant step time per batch).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterable, Sequence

# Bucket boundaries: multiples of 128 (powers of two, so every batch shape
# tiles matmuls evenly).
DEFAULT_BUCKETS = (128, 256, 512, 1024, 2048)

# Target adjacency elements per GCN batch (B·L²): 512M f32 ≈ 2 GB per
# adjacency buffer; large batches keep the LSTM scan's per-step matmul
# (B × 512 × 2048) busy. The rule was sized for a 16 GB accelerator. On an
# NVIDIA H100 80GB HBM3 (700 W), the 3-mode float32 GCN batch at this rule
# peaked at 19.6–25.9 GB of device memory at bucket 512 (B 2048) and
# 6.0–6.6 GB at bucket 2048 (B 128), of the 63.8 GB JAX reserves
# (`memory_stats()` after the batch, two runs of chip_smoke.py).
_TARGET_ADJ_ELEMS = 512 * 1024 * 1024
# Batch ceiling: bounds host packing latency and partial-batch padding.
_MAX_GCN_BATCH = 2048
# Target token elements per CNN batch (B·L) — CNN has no O(L²) term.
_TARGET_TOK_ELEMS = 512 * 1024


def assign_bucket(length: int,
                  buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket that fits ``length``.

    Lengths beyond the configured ceiling get an ad-hoc 256-aligned bucket
    (one extra compile, tiny batch) instead of an error — the reference
    imposes no length limit (its per-protein ONNX calls are dynamically
    shaped), so neither do we.
    """
    for b in buckets:
        if length <= b:
            return b
    return -(-length // 256) * 256


def gcn_batch_size(bucket: int) -> int:
    """Batch size keeping B·L² ≈ constant (capped), multiple-of-8."""
    b = max(1, min(_MAX_GCN_BATCH, _TARGET_ADJ_ELEMS // (bucket * bucket)))
    if b >= 8:
        b -= b % 8
    return b


def cnn_batch_size(bucket: int) -> int:
    b = max(1, _TARGET_TOK_ELEMS // bucket)
    if b >= 8:
        b -= b % 8
    return b


def bucket_plan(lengths: Iterable[int],
                buckets: Sequence[int] = DEFAULT_BUCKETS) -> dict:
    """Group item indices by bucket: {bucket_len: [indices]}."""
    plan = defaultdict(list)
    for idx, length in enumerate(lengths):
        plan[assign_bucket(length, buckets)].append(idx)
    return dict(plan)
