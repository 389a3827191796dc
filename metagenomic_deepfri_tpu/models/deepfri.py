"""DeepFRI GCN and CNN architectures — functional JAX, batched and masked.

The reference runs these as opaque ONNX graphs, one protein at a time
(reference ``mDeepFRI/predict.pyx:75-102``; I/O contract: GCN takes
``A:(1,L,L) f32`` + ``S:(1,L,26) f32``, CNN takes ``S`` only; output sliced
``[:, :, 0]`` into a flat per-term score vector). Here both networks are
explicit parameter-tree + pure-function pairs operating on padded batches with
length masks, so the whole hot path is one jitted XLA program per length
bucket.

Architecture (from the model-name encoding ``gcd_512-512-512_fcd_1024``,
reference ``mDeepFRI/__init__.py:70-80``, and the DeepFRI publication cited at
reference ``README.md:320-322``):

GCN:   one-hot(26) ─┬─ LSTM-LM stack ── Dense(no bias) ──┐
                    └─ Dense(bias) ──────────────────────┴─ add → ReLU
       → 3 × GraphConv(512, ReLU):  Hₗ₊₁ = relu(Â · Hₗ · Wₗ)
       → concat(H₁‖H₂‖H₃) → masked sum-pool over L
       → Dense(1024, ReLU) → Dense(2·n_labels) → reshape (n_labels, 2)
       → softmax(last) → score = [..., 0]

CNN ("DeepCNN-MERGED"): parallel Conv1D branches (per kernel size) → concat →
       ReLU → masked global max-pool → Dense stack → same two-way-softmax head.

Exact hyperparameters of the published weights (LM depth/width, conv filter
sizes, adjacency normalisation) are config fields resolved by the ONNX
importer when real weights are loaded; the defaults below mirror the model
names and paper. The output contract (per-term softmax, score at class 0) is
fixed by the reference's ``prediction[:, :, 0]`` slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import jax
import jax.numpy as jnp

from metagenomic_deepfri_tpu.models.lstm import (init_lstm_stack,
                                                 lstm_stack_forward)
from metagenomic_deepfri_tpu.ops.one_hot import VOCAB_SIZE, tokens2onehot


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GCNConfig:
    n_labels: int
    vocab: int = VOCAB_SIZE
    lm_hidden: int = 512
    lm_layers: int = 2
    lm_bidirectional: bool = False
    embed_dim: int = 1024
    gc_dims: Tuple[int, ...] = (512, 512, 512)
    fc_dims: Tuple[int, ...] = (1024,)
    adj_norm: str = "sym"          # 'sym' | 'row' | 'none'
    pool: str = "sum"              # 'sum' | 'mean' over the length axis
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'


@dataclass(frozen=True)
class CNNConfig:
    n_labels: int
    vocab: int = VOCAB_SIZE
    conv_filters: int = 512
    conv_kernels: Tuple[int, ...] = (8, 16)
    fc_dims: Tuple[int, ...] = (1024,)
    compute_dtype: str = "float32"


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------

def _dense_init(key, in_dim, out_dim, bias=True, dtype=jnp.float32):
    scale = (6.0 / (in_dim + out_dim)) ** 0.5
    p = {"kernel": jax.random.uniform(key, (in_dim, out_dim), dtype,
                                      -scale, scale)}
    if bias:
        p["bias"] = jnp.zeros((out_dim,), dtype)
    return p


def _dense(p, x):
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def init_gcn(key, config: GCNConfig, *, gc_bias: bool = False,
             lm_embed_bias: bool = False) -> dict:
    """Random GCN parameter tree.

    ``gc_bias`` / ``lm_embed_bias`` add the *optional* bias terms some Keras
    exports carry on the GraphConv layers and the LM embedding; the published
    DeepFRI architecture is bias-free there, but the ONNX importer consumes
    such biases when a graph has them, so tests can exercise both forms.
    """
    keys = jax.random.split(key, 8 + len(config.gc_dims) + len(config.fc_dims))
    ki = iter(keys)
    lm_out = config.lm_hidden * (2 if config.lm_bidirectional else 1)
    params = {
        "lm": init_lstm_stack(next(ki), config.vocab, config.lm_hidden,
                              config.lm_layers,
                              bidirectional=config.lm_bidirectional),
        "lm_embed": _dense_init(next(ki), lm_out, config.embed_dim,
                                bias=lm_embed_bias),
        "aa_embed": _dense_init(next(ki), config.vocab, config.embed_dim,
                                bias=True),
        "gc": [],
        "fc": [],
    }
    in_dim = config.embed_dim
    for d in config.gc_dims:
        params["gc"].append(_dense_init(next(ki), in_dim, d, bias=gc_bias))
        in_dim = d
    concat_dim = sum(config.gc_dims)
    in_dim = concat_dim
    for d in config.fc_dims:
        params["fc"].append(_dense_init(next(ki), in_dim, d, bias=True))
        in_dim = d
    params["head"] = _dense_init(next(ki), in_dim, 2 * config.n_labels,
                                 bias=True)
    return params


def init_cnn(key, config: CNNConfig) -> dict:
    keys = jax.random.split(key, 4 + len(config.conv_kernels)
                            + len(config.fc_dims))
    ki = iter(keys)
    params = {"conv": [], "fc": []}
    for ksize in config.conv_kernels:
        k = next(ki)
        scale = (6.0 / (ksize * config.vocab + config.conv_filters)) ** 0.5
        params["conv"].append({
            # (width, in_channels, out_channels) — lax.conv_general_dilated
            "kernel": jax.random.uniform(
                k, (ksize, config.vocab, config.conv_filters),
                jnp.float32, -scale, scale),
            "bias": jnp.zeros((config.conv_filters,), jnp.float32),
        })
    in_dim = config.conv_filters * len(config.conv_kernels)
    for d in config.fc_dims:
        params["fc"].append(_dense_init(next(ki), in_dim, d, bias=True))
        in_dim = d
    params["head"] = _dense_init(next(ki), in_dim, 2 * config.n_labels,
                                 bias=True)
    return params


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------

def normalize_adjacency(adj: jnp.ndarray, mode: str = "sym") -> jnp.ndarray:
    """Degree-normalise a (B, L, L) adjacency; safe on zero (padded) rows."""
    if mode == "none":
        return adj
    deg = jnp.sum(adj, axis=-1)
    if mode == "sym":
        inv_sqrt = jax.lax.rsqrt(jnp.maximum(deg, 1e-12))
        inv_sqrt = jnp.where(deg > 0, inv_sqrt, 0.0)
        return adj * inv_sqrt[:, :, None] * inv_sqrt[:, None, :]
    if mode == "row":
        inv = jnp.where(deg > 0, 1.0 / jnp.maximum(deg, 1e-12), 0.0)
        return adj * inv[:, :, None]
    raise ValueError(f"Unknown adjacency normalisation: {mode}")


def _head_scores(head_params, x, n_labels: int) -> jnp.ndarray:
    """Per-term 2-way softmax; score = class-0 probability.

    Matches the reference output contract ``prediction[:, :, 0].reshape(-1)``
    (reference predict.pyx:98-102).
    """
    logits = _dense(head_params, x)
    logits = logits.reshape(*logits.shape[:-1], n_labels, 2)
    probs = jax.nn.softmax(logits, axis=-1)
    return probs[..., 0]


def graphconv_apply(layer: dict, agg: jnp.ndarray, dtype) -> jnp.ndarray:
    """relu(agg · W [+ b]) — one GraphConv layer after the A·H aggregation.

    The published DeepFRI GraphConv is bias-free, but the importer preserves
    a bias when an ONNX graph carries one; padded rows are re-masked at pool
    time, so a bias never leaks into the pooled feature.
    """
    h = agg @ layer["kernel"].astype(dtype)
    if "bias" in layer:
        h = h + layer["bias"].astype(dtype)
    return jax.nn.relu(h)


def graphconv_aggregate(adj: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """A·H for a (B, L, L) adjacency and (B, L, D) features, f32 accumulate.

    Named ``graphconv_aggregate`` in profiler traces so per-layer device
    time can be read from a trace by scope name.
    """
    with jax.named_scope("graphconv_aggregate"):
        return jnp.einsum("bij,bjd->bid", adj, x,
                          preferred_element_type=jnp.float32)


def _pool_over_length(concat: jnp.ndarray, valid: jnp.ndarray,
                      lengths: jnp.ndarray, mode: str) -> jnp.ndarray:
    """Masked sum- or mean-pool of (B, L, C) over L."""
    pooled = jnp.sum(concat * valid[:, :, None], axis=1)
    if mode == "mean":
        denom = jnp.maximum(lengths, 1).astype(pooled.dtype)
        pooled = pooled / denom[:, None]
    elif mode != "sum":
        raise ValueError(f"Unknown pooling mode: {mode}")
    return pooled


def _gcn_trunk(params: dict, config: GCNConfig, tokens: jnp.ndarray,
               adjacency: jnp.ndarray, lengths: jnp.ndarray,
               stages: dict | None = None) -> jnp.ndarray:
    """Shared GCN trunk: one-hot → LM branch → GraphConv stack → pooled FC.

    Returns the (B, fc_dims[-1]) feature tensor fed to the per-term head.
    ``stages`` (if given) collects named intermediates for per-stage parity
    localisation against the ONNX oracle.
    """
    dtype = jnp.dtype(config.compute_dtype)
    onehot = tokens2onehot(tokens, dtype=jnp.float32)
    L = tokens.shape[1]
    valid = (jnp.arange(L, dtype=jnp.int32)[None, :]
             < lengths[:, None]).astype(jnp.float32)
    onehot = onehot * valid[:, :, None]

    # Sequence branch: LSTM-LM + residue embedding (frozen-LM design of the
    # reference models; see module docstring).
    lm_out = lstm_stack_forward(params["lm"], onehot, lengths,
                                compute_dtype=dtype)
    x = _dense(params["lm_embed"], lm_out) + _dense(params["aa_embed"], onehot)
    x = jax.nn.relu(x).astype(dtype)
    if stages is not None:
        stages["embed"] = x

    adj = normalize_adjacency(adjacency.astype(jnp.float32),
                              config.adj_norm).astype(dtype)

    # GraphConv stack; every layer's output contributes to the concat
    # (DeepFRI's GCNN_concatenate pattern).
    gc_outputs = []
    for gi, layer in enumerate(params["gc"]):
        x = graphconv_apply(layer, graphconv_aggregate(adj, x), dtype)
        gc_outputs.append(x)
        if stages is not None:
            stages[f"gc{gi}"] = x
    concat = jnp.concatenate(gc_outputs, axis=-1).astype(jnp.float32)

    # Padded rows are exactly zero (zero adjacency rows → relu(0) = 0) unless
    # a GraphConv bias shifted them, so pooling always re-masks to valid
    # positions.
    pooled = _pool_over_length(concat, valid, lengths, config.pool)
    if stages is not None:
        stages["pooled"] = pooled

    for fi, layer in enumerate(params["fc"]):
        pooled = jax.nn.relu(_dense(layer, pooled))
        if stages is not None:
            stages[f"fc{fi}"] = pooled
    return pooled


def gcn_forward(params: dict, config: GCNConfig, tokens: jnp.ndarray,
                adjacency: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """Batched GCN forward.

    Args:
        tokens: (B, L) uint8 token ids (padded with PAD_TOKEN).
        adjacency: (B, L, L) float 0/1 contact maps, padded rows/cols zeroed,
            identity on valid diagonal (the contract produced by
            ``ops.cmap_align`` / ``ops.contact``).
        lengths: (B,) int32 true lengths.

    Returns:
        (B, n_labels) float32 per-term scores in [0, 1].
    """
    pooled = _gcn_trunk(params, config, tokens, adjacency, lengths)
    return _head_scores(params["head"], pooled, config.n_labels)


def gcn_forward_logits(params: dict, config: GCNConfig, tokens: jnp.ndarray,
                       adjacency: jnp.ndarray,
                       lengths: jnp.ndarray) -> jnp.ndarray:
    """Batched GCN forward returning (B, n_labels, 2) pre-softmax logits.

    Training entry point: the fine-tuning loss needs raw logits, not the
    class-0 probabilities of the inference contract.
    """
    pooled = _gcn_trunk(params, config, tokens, adjacency, lengths)
    logits = _dense(params["head"], pooled)
    return logits.reshape(*logits.shape[:-1], config.n_labels, 2)


def gcn_forward_stages(params: dict, config: GCNConfig, tokens: jnp.ndarray,
                       adjacency: jnp.ndarray, lengths: jnp.ndarray) -> dict:
    """Batched GCN forward returning every named stage for parity debugging.

    Keys: ``embed``, ``gc0..gcN``, ``pooled``, ``fc0..fcM``, ``logits``
    ((B, n_labels, 2) pre-softmax), ``scores``. Stage names line up with
    :func:`..onnx_import.gcn_stage_tensors` so a JAX-vs-ONNX divergence can
    be pinned to the first disagreeing stage.
    """
    stages: dict = {}
    pooled = _gcn_trunk(params, config, tokens, adjacency, lengths,
                        stages=stages)
    logits = _dense(params["head"], pooled)
    stages["logits"] = logits.reshape(*logits.shape[:-1], config.n_labels, 2)
    stages["scores"] = jax.nn.softmax(stages["logits"], axis=-1)[..., 0]
    return stages


def gcn_forward_multimode(shared: dict, per_mode: dict, configs: dict,
                          tokens: jnp.ndarray, adjacency: jnp.ndarray,
                          lengths: jnp.ndarray) -> dict:
    """Evaluate several GCN modes over ONE batch, computing the shared trunk once.

    The published DeepFRI GCN models reuse one frozen pretrained LSTM-LM
    across bp/cc/mf (the model-name templates at reference
    ``mDeepFRI/__init__.py:70-80`` encode a single LM; the "MERGED" tf2onnx
    export bakes a copy of it into each ``.onnx``). When the engine detects
    bitwise-identical LM subtrees across the loaded modes, a multi-mode
    batch evaluates the LM — and the embedding merge, if those weights are
    also shared — ONCE instead of once per mode. The LSTM is ~70% of
    per-protein matmul FLOPs, so a 3-mode pass does ~1.9× less device work;
    the adjacency normalisation is likewise computed once (configs must
    agree on ``adj_norm``, which the engine validates).

    Args:
        shared: common subtrees — always ``lm``, optionally ``lm_embed`` /
            ``aa_embed`` when those are also bitwise-shared.
        per_mode: {mode: remainder-of-param-tree} (keys absent from
            ``shared``).
        configs: {mode: GCNConfig}; must agree on everything but
            ``n_labels``.

    Returns:
        {mode: (B, n_labels_mode) float32 scores}.
    """
    cfg0 = next(iter(configs.values()))
    dtype = jnp.dtype(cfg0.compute_dtype)
    onehot = tokens2onehot(tokens, dtype=jnp.float32)
    L = tokens.shape[1]
    valid = (jnp.arange(L, dtype=jnp.int32)[None, :]
             < lengths[:, None]).astype(jnp.float32)
    onehot = onehot * valid[:, :, None]
    adj = normalize_adjacency(adjacency.astype(jnp.float32),
                              cfg0.adj_norm).astype(dtype)

    lm_shared = (lstm_stack_forward(shared["lm"], onehot, lengths,
                                    compute_dtype=dtype)
                 if "lm" in shared else None)
    x_shared = None
    if lm_shared is not None and "lm_embed" in shared and "aa_embed" in shared:
        x_shared = jax.nn.relu(
            _dense(shared["lm_embed"], lm_shared)
            + _dense(shared["aa_embed"], onehot)).astype(dtype)

    out = {}
    for mode, p in per_mode.items():
        cfg = configs[mode]
        if x_shared is not None:
            x = x_shared
        else:
            lm_out = (lm_shared if lm_shared is not None
                      else lstm_stack_forward(p["lm"], onehot, lengths,
                                              compute_dtype=dtype))
            x = jax.nn.relu(
                _dense(shared.get("lm_embed", p.get("lm_embed")), lm_out)
                + _dense(shared.get("aa_embed", p.get("aa_embed")), onehot)
            ).astype(dtype)
        gc_outputs = []
        for layer in p["gc"]:
            x = graphconv_apply(layer, graphconv_aggregate(adj, x), dtype)
            gc_outputs.append(x)
        concat = jnp.concatenate(gc_outputs, axis=-1).astype(jnp.float32)
        pooled = _pool_over_length(concat, valid, lengths, cfg.pool)
        for layer in p["fc"]:
            pooled = jax.nn.relu(_dense(layer, pooled))
        out[mode] = _head_scores(p["head"], pooled, cfg.n_labels)
    return out


def _cnn_trunk(params: dict, config: CNNConfig, tokens: jnp.ndarray,
               lengths: jnp.ndarray, stages: dict | None = None):
    """Conv branches → masked global max-pool → FC stack.

    Zeroing padded one-hot rows makes 'SAME' convolution over a padded batch
    bit-identical (on valid positions) to the reference's unpadded per-protein
    execution; the global max-pool is masked to valid positions.
    """
    onehot = tokens2onehot(tokens, dtype=jnp.float32)
    L = tokens.shape[1]
    valid = jnp.arange(L, dtype=jnp.int32)[None, :] < lengths[:, None]
    onehot = onehot * valid[:, :, None].astype(jnp.float32)

    branches = []
    for conv in params["conv"]:
        y = jax.lax.conv_general_dilated(
            onehot, conv["kernel"],
            window_strides=(1,), padding="SAME",
            dimension_numbers=("NWC", "WIO", "NWC"),
            preferred_element_type=jnp.float32)
        branches.append(y + conv["bias"])
    x = jax.nn.relu(jnp.concatenate(branches, axis=-1))

    neg_inf = jnp.asarray(-jnp.inf, x.dtype)
    x = jnp.where(valid[:, :, None], x, neg_inf)
    pooled = jnp.max(x, axis=1)
    pooled = jnp.where(jnp.isfinite(pooled), pooled, 0.0)
    if stages is not None:
        stages["pooled"] = pooled

    for fi, layer in enumerate(params["fc"]):
        pooled = jax.nn.relu(_dense(layer, pooled))
        if stages is not None:
            stages[f"fc{fi}"] = pooled
    return pooled


def cnn_forward(params: dict, config: CNNConfig, tokens: jnp.ndarray,
                lengths: jnp.ndarray) -> jnp.ndarray:
    """Batched sequence-only CNN forward → (B, n_labels) scores."""
    pooled = _cnn_trunk(params, config, tokens, lengths)
    return _head_scores(params["head"], pooled, config.n_labels)


def cnn_forward_logits(params: dict, config: CNNConfig, tokens: jnp.ndarray,
                       lengths: jnp.ndarray) -> jnp.ndarray:
    """Batched CNN forward returning (B, n_labels, 2) pre-softmax logits."""
    pooled = _cnn_trunk(params, config, tokens, lengths)
    logits = _dense(params["head"], pooled)
    return logits.reshape(*logits.shape[:-1], config.n_labels, 2)


def cnn_forward_stages(params: dict, config: CNNConfig, tokens: jnp.ndarray,
                       lengths: jnp.ndarray) -> dict:
    """Named CNN stages (``pooled``, ``fc*``, ``logits``, ``scores``) for
    parity localisation — see :func:`gcn_forward_stages`."""
    stages: dict = {}
    pooled = _cnn_trunk(params, config, tokens, lengths, stages=stages)
    logits = _dense(params["head"], pooled)
    stages["logits"] = logits.reshape(*logits.shape[:-1], config.n_labels, 2)
    stages["scores"] = jax.nn.softmax(stages["logits"], axis=-1)[..., 0]
    return stages


# ---------------------------------------------------------------------------
# Single-protein convenience API (reference Predictor.forward_pass parity)
# ---------------------------------------------------------------------------

def forward_pass_single(params: dict, config, seqres: str,
                        cmap=None) -> jnp.ndarray:
    """Per-protein forward mirroring reference ``predict.pyx:75-102``.

    GCN when a contact map is provided, CNN otherwise; returns the flat
    per-term score vector. Intended for parity tests and small one-off use —
    the production path is the batched engine.
    """
    import numpy as np

    from metagenomic_deepfri_tpu.ops.one_hot import seq2tokens

    tokens = jnp.asarray(seq2tokens(seqres)[None, :])
    lengths = jnp.asarray(np.array([len(seqres)], np.int32))
    if cmap is not None:
        adj = jnp.asarray(np.asarray(cmap, np.float32)[None])
        scores = gcn_forward(params, config, tokens, adj, lengths)
    else:
        scores = cnn_forward(params, config, tokens, lengths)
    return scores.reshape(-1)


def forward_stages_single(params: dict, config, seqres: str,
                          cmap=None) -> dict:
    """Per-protein staged forward (GCN when ``cmap`` given, else CNN).

    Returns the named-stage dict of :func:`gcn_forward_stages` /
    :func:`cnn_forward_stages` for a single protein — the JAX side of the
    per-stage parity localiser in :mod:`metagenomic_deepfri_tpu.parity`.
    """
    import numpy as np

    from metagenomic_deepfri_tpu.ops.one_hot import seq2tokens

    tokens = jnp.asarray(seq2tokens(seqres)[None, :])
    lengths = jnp.asarray(np.array([len(seqres)], np.int32))
    if cmap is not None:
        adj = jnp.asarray(np.asarray(cmap, np.float32)[None])
        return gcn_forward_stages(params, config, tokens, adj, lengths)
    return cnn_forward_stages(params, config, tokens, lengths)
