"""Sequence tokenisation and one-hot encoding.

Replaces the reference's Cython ``seq2onehot`` (reference
``mDeepFRI/predict.pyx:17-48``). The 26-character vocabulary order is the
bit-compatibility contract with the DeepFRI weights and MUST NOT change
(reference ``predict.pyx:32``).

Sequences are tokenised once on the host into compact
``uint8`` token arrays; the (padded, batched) one-hot expansion happens on
device as part of the jitted forward pass, so the host→device transfer is
O(B·L) bytes instead of O(B·L·26) floats.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

# Exact DeepFRI vocabulary (reference mDeepFRI/predict.pyx:32).
ALPHABET = "-DGULNTKHYWCPVSOIEFXQABZRM"
VOCAB_SIZE = len(ALPHABET)  # 26

# 256-entry ASCII → token lookup; -1 marks invalid characters
# (mirrors the char_map construction at reference predict.pyx:30-33).
_CHAR_MAP = np.full(256, -1, dtype=np.int16)
for _i, _c in enumerate(ALPHABET):
    _CHAR_MAP[ord(_c)] = _i

# Token used to fill padded positions. Padding reuses the gap token '-' but is
# always masked out by the sequence mask before it can affect model output.
PAD_TOKEN = 0


def seq2tokens(seq: str) -> np.ndarray:
    """Tokenise a protein sequence into uint8 codes over :data:`ALPHABET`.

    Raises ``ValueError`` on characters outside the vocabulary, matching the
    reference behaviour (reference predict.pyx:45-46).
    """
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    tokens = _CHAR_MAP[raw]
    bad = np.nonzero(tokens < 0)[0]
    if bad.size:
        raise ValueError(f"Invalid character in sequence: {seq[int(bad[0])]}")
    return tokens.astype(np.uint8)


def seq2onehot(seq: str) -> np.ndarray:
    """(L, 26) float32 one-hot of a sequence — drop-in for the reference API."""
    tokens = seq2tokens(seq)
    onehot = np.zeros((tokens.shape[0], VOCAB_SIZE), dtype=np.float32)
    onehot[np.arange(tokens.shape[0]), tokens] = 1.0
    return onehot


def tokens2onehot(tokens: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """Device-side one-hot expansion of a (…, L) uint8/int token array.

    Used inside jitted forwards; XLA fuses this into the consuming matmul, so
    the one-hot never materialises in HBM.
    """
    return jnp.equal(
        tokens[..., None].astype(jnp.int32),
        jnp.arange(VOCAB_SIZE, dtype=jnp.int32),
    ).astype(dtype)


def batch_tokens(seqs: list[str], pad_to: int) -> tuple[np.ndarray, np.ndarray]:
    """Tokenise and right-pad a list of sequences to a fixed length.

    Returns ``(tokens (B, pad_to) uint8, lengths (B,) int32)``. The padded
    region is filled with :data:`PAD_TOKEN` and must be masked downstream.
    """
    batch = np.full((len(seqs), pad_to), PAD_TOKEN, dtype=np.uint8)
    lengths = np.zeros(len(seqs), dtype=np.int32)
    for i, seq in enumerate(seqs):
        tokens = seq2tokens(seq)
        if tokens.shape[0] > pad_to:
            raise ValueError(
                f"Sequence length {tokens.shape[0]} exceeds pad_to={pad_to}")
        batch[i, : tokens.shape[0]] = tokens
        lengths[i] = tokens.shape[0]
    return batch, lengths
