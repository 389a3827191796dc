"""Multi-device execution: device meshes, shardings, and the fine-tuning step.

The reference has NO multi-device execution of any kind (SURVEY.md §2.3; the
only parallelism is host-side multiprocessing, reference ``pipeline.py:480``,
``alignment.py:314-318``). This package is therefore new capability:

- :mod:`mesh` — build a ``jax.sharding.Mesh`` over the available devices with
  named ``data`` / ``model`` axes.
- :mod:`shard` — PartitionSpec trees for DeepFRI parameter pytrees and padded
  batches (data-parallel batch sharding + Megatron-style column/row tensor
  parallelism on the dense stack); XLA GSPMD inserts the collectives.
- :mod:`train` — a pjit-able fine-tuning step (per-term two-way softmax
  cross-entropy, optax optimizer) sharded over the mesh.
"""

from metagenomic_deepfri_tpu.parallel.mesh import make_mesh
from metagenomic_deepfri_tpu.parallel.shard import (batch_pspecs,
                                                    gcn_param_pspecs,
                                                    make_sharded_gcn_forward)
from metagenomic_deepfri_tpu.parallel.train import (TrainState,
                                                    init_train_state,
                                                    make_train_step)

__all__ = [
    "make_mesh",
    "batch_pspecs",
    "gcn_param_pspecs",
    "make_sharded_gcn_forward",
    "TrainState",
    "init_train_state",
    "make_train_step",
]
