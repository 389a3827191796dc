"""Sharded fine-tuning step for DeepFRI GCN models.

New capability relative to the reference, which is inference-only (SURVEY.md
intro; its models arrive pre-trained as ONNX, reference ``__init__.py:47``).
A framework that hosts the model natively can also fine-tune it on new
GO/EC annotations, so the training step is first-class here:

- loss: per-term two-way softmax cross-entropy, matching the inference head's
  ``(n_labels, 2) → softmax → class-0 score`` contract exactly, so a
  fine-tuned checkpoint drops straight into the batched inference engine;
- optimizer: any optax ``GradientTransformation``;
- distribution: data-parallel over ``data``, tensor-parallel over ``model``
  (see :mod:`.shard`). Parameters are mesh-sharded by
  :func:`init_train_state`; optax mirrors them with ``zeros_like``, so the
  optimizer state inherits the same shardings with no extra bookkeeping, and
  GSPMD's all-reduce over ``data`` performs the gradient average as a
  by-product of the mean loss.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from metagenomic_deepfri_tpu.models.deepfri import (GCNConfig,
                                                    gcn_forward_logits,
                                                    init_gcn)
from metagenomic_deepfri_tpu.parallel.mesh import DATA_AXIS
from metagenomic_deepfri_tpu.parallel.shard import batch_pspecs, shard_params


class TrainState(NamedTuple):
    params: dict
    opt_state: object
    step: jnp.ndarray


def gcn_loss(params: dict, config: GCNConfig, tokens, adjacency, lengths,
             labels) -> jnp.ndarray:
    """Mean per-term cross-entropy against {0,1} GO-term labels.

    The head emits (B, n_labels, 2) logits whose softmax class 0 is the
    positive-term probability (reference output contract
    ``prediction[:, :, 0]``, predict.pyx:98-102), so a positive label selects
    class index 0.
    """
    logits = gcn_forward_logits(params, config, tokens, adjacency, lengths)
    target = (1 - labels).astype(jnp.int32)  # positive → class 0
    ce = optax.softmax_cross_entropy_with_integer_labels(logits, target)
    return jnp.mean(ce)


def init_train_state(key, config: GCNConfig, optimizer,
                     mesh: Optional[Mesh] = None,
                     params: Optional[dict] = None) -> TrainState:
    """Initialise (and mesh-shard) params + optimizer state.

    Pass ``params`` to fine-tune imported weights instead of a fresh init.
    """
    if params is None:
        params = init_gcn(key, config)
    if mesh is not None:
        params = shard_params(params, mesh)
    opt_state = optimizer.init(params)  # zeros_like → inherits shardings
    return TrainState(params=params, opt_state=opt_state,
                      step=jnp.zeros((), jnp.int32))


def make_train_step(mesh: Mesh, config: GCNConfig, optimizer):
    """Build the jitted, mesh-sharded train step.

    Returns ``step_fn(state, tokens, adjacency, lengths, labels) ->
    (state, loss)``. Batch inputs are sharded over ``data``; the TrainState's
    shardings are whatever :func:`init_train_state` committed (params
    tensor-parallel over ``model``), which jit respects for donated state.
    """
    t_s, a_s, l_s = batch_pspecs(with_adj=True)

    def named(s):
        return NamedSharding(mesh, s)

    def step_fn(state: TrainState, tokens, adjacency, lengths, labels):
        loss, grads = jax.value_and_grad(gcn_loss)(
            state.params, config, tokens, adjacency, lengths, labels)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        new_params = optax.apply_updates(state.params, updates)
        return TrainState(new_params, opt_state, state.step + 1), loss

    return jax.jit(
        step_fn,
        in_shardings=(None, named(t_s), named(a_s), named(l_s),
                      named(P(DATA_AXIS, None))),
        donate_argnums=(0,),
    )
