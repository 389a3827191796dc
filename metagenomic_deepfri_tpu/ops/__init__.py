"""Device compute for the DeepFRI data path, in plain JAX/XLA.

Each module replaces one of the reference's Cython/C++/OpenMP kernels with a
batched, device-resident equivalent (reference inventory: SURVEY.md §2.2):

- :mod:`.one_hot` — sequence tokenisation / one-hot (ref ``predict.pyx:17-48``)
- :mod:`.contact` — batched pairwise squared-euclidean + contact thresholding
  (ref ``contact_map_utils.pyx:17-37``, ``bio_utils.py:196-227``)
- :mod:`.cmap_align` — alignment-driven contact-map remapping
  (ref ``contact_map_utils.pyx:44-117``)
- :mod:`.nw` — Needleman–Wunsch pairwise alignment (host C++/ctypes + reference
  Python implementation; replaces pyOpal, ref ``alignment.py:163-220``)
"""

from metagenomic_deepfri_tpu.ops.one_hot import (ALPHABET, seq2onehot,
                                                 seq2tokens, tokens2onehot)

__all__ = ["ALPHABET", "seq2onehot", "seq2tokens", "tokens2onehot"]
