"""LSTM layers for the DeepFRI language-model branch.

The reference executes the pretrained LSTM-LM inside the merged ONNX graph
("MERGED" model names, reference ``mDeepFRI/__init__.py:70-80``; background at
SURVEY.md §2.4). Here it is a functional ``lax.scan`` over the length axis —
XLA compiles the per-step (4H×H) recurrences to one matmul per step and the
scan carries only the (B, H) state.

Gate convention is Keras/ONNX ``[i, f, c, o]`` with the input-kernel and
recurrent-kernel stored as (in_dim, 4H) and (H, 4H); this is the layout the
ONNX ``LSTM`` op's ``W/R/B`` initializers map onto (transposed, gate-reordered
from ONNX's ``[i, o, f, c]`` by :mod:`.onnx_import`), so imported weights slot
in without per-step reshuffling.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def init_lstm(key, in_dim: int, hidden: int, dtype=jnp.float32) -> dict:
    """Glorot-uniform kernel, orthogonal-free recurrent init, unit forget bias."""
    k1, k2 = jax.random.split(key)
    scale = np.sqrt(6.0 / (in_dim + 4 * hidden))
    kernel = jax.random.uniform(k1, (in_dim, 4 * hidden), dtype, -scale, scale)
    rscale = np.sqrt(6.0 / (hidden + 4 * hidden))
    recurrent = jax.random.uniform(k2, (hidden, 4 * hidden), dtype, -rscale, rscale)
    bias = jnp.zeros((4 * hidden,), dtype)
    # unit forget-gate bias (Keras default) — gates ordered [i, f, c, o]
    bias = bias.at[hidden:2 * hidden].set(1.0)
    return {"kernel": kernel, "recurrent": recurrent, "bias": bias}


def lstm_forward(params: dict, x: jnp.ndarray,
                 reverse: bool = False,
                 compute_dtype=jnp.float32) -> jnp.ndarray:
    """Run an LSTM over the length axis of ``x`` (B, L, D) → (B, L, H).

    ``reverse=True`` scans right-to-left (for bidirectional stacks). Padded
    positions are processed like any other step; forward-direction states at
    valid positions are unaffected by right-padding, and reverse-direction
    use requires length-aware flipping by the caller.

    ``compute_dtype=bfloat16`` runs the recurrent matmul and hidden state in
    bf16 (the cell state and gate nonlinearities stay f32 for stability) —
    the scan is the dominant per-batch compute and is matmul-bound, so this
    tracks the rest of the model's compute-dtype choice.
    """
    hidden = params["recurrent"].shape[0]
    B = x.shape[0]
    cdt = jnp.dtype(compute_dtype)
    # Pre-compute the input contribution for all steps in one big matmul.
    xw = jnp.einsum("bld,dg->blg", x.astype(cdt),
                    params["kernel"].astype(cdt),
                    preferred_element_type=jnp.float32) + params["bias"]
    recurrent = params["recurrent"].astype(cdt)

    def step(carry, xw_t):
        h, c = carry
        gates = (xw_t + (h @ recurrent).astype(jnp.float32))
        i, f, g, o = jnp.split(gates, 4, axis=-1)
        i = jax.nn.sigmoid(i)
        f = jax.nn.sigmoid(f)
        g = jnp.tanh(g)
        o = jax.nn.sigmoid(o)
        c = f * c + i * g
        h = o * jnp.tanh(c)
        return (h.astype(cdt), c), h

    h0 = jnp.zeros((B, hidden), cdt)
    c0 = jnp.zeros((B, hidden), jnp.float32)
    xw_t = jnp.swapaxes(xw, 0, 1)  # (L, B, 4H)
    (_, _), hs = jax.lax.scan(step, (h0, c0), xw_t, reverse=reverse)
    return jnp.swapaxes(hs, 0, 1)  # (B, L, H)


def init_lstm_stack(key, in_dim: int, hidden: int, layers: int,
                    dtype=jnp.float32, bidirectional: bool = False) -> list:
    params = []
    layer_out = hidden * (2 if bidirectional else 1)
    for i in range(layers):
        d = in_dim if i == 0 else layer_out
        if bidirectional:
            key, k1, k2 = jax.random.split(key, 3)
            params.append({"fwd": init_lstm(k1, d, hidden, dtype),
                           "bwd": init_lstm(k2, d, hidden, dtype)})
        else:
            key, sub = jax.random.split(key)
            params.append(init_lstm(sub, d, hidden, dtype))
    return params


def reverse_sequences(x: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """Flip each row of a right-padded (B, L, D) batch within its length.

    Positions beyond the row's length stay in place (they are zero/ignored),
    so a reverse-direction scan sees the sequence back-to-front exactly as an
    unpadded per-protein run would (ONNX LSTM ``direction=reverse``
    semantics under our padding convention).
    """
    B, L = x.shape[0], x.shape[1]
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    flipped = lengths[:, None] - 1 - pos
    idx = jnp.where(pos < lengths[:, None], flipped, pos)
    return jnp.take_along_axis(x, idx[:, :, None], axis=1)


def lstm_bidirectional_forward(params: dict, x: jnp.ndarray,
                               lengths: jnp.ndarray,
                               compute_dtype=jnp.float32) -> jnp.ndarray:
    """Bidirectional layer {'fwd': ..., 'bwd': ...} → (B, L, 2H) concat.

    The backward pass runs a forward scan over the length-aware reversed
    input, and its outputs are reversed back — matching ONNX bidirectional
    LSTM output ordering [forward ‖ backward] per position.
    """
    fwd = lstm_forward(params["fwd"], x, compute_dtype=compute_dtype)
    x_rev = reverse_sequences(x, lengths)
    bwd = reverse_sequences(
        lstm_forward(params["bwd"], x_rev, compute_dtype=compute_dtype),
        lengths)
    return jnp.concatenate([fwd, bwd], axis=-1)


def lstm_stack_forward(params: list, x: jnp.ndarray,
                       lengths: jnp.ndarray | None = None,
                       compute_dtype=jnp.float32) -> jnp.ndarray:
    """Run a stack of LSTM layers; entries are unidirectional param dicts or
    {'fwd','bwd'} bidirectional pairs (which require ``lengths``)."""
    for layer in params:
        if "fwd" in layer:
            if lengths is None:
                raise ValueError(
                    "bidirectional LSTM layers require sequence lengths")
            x = lstm_bidirectional_forward(layer, x, lengths,
                                           compute_dtype=compute_dtype)
        else:
            x = lstm_forward(layer, x, compute_dtype=compute_dtype)
    return x
