"""Metagenomic-DeepFRI on JAX: protein function annotation framework.

A from-scratch JAX/XLA re-design of the capabilities of
bioinf-mcb/Metagenomic-DeepFRI (reference layout: ``mDeepFRI/__init__.py``):
GO-term / EC-number annotation of protein catalogues with the DeepFRI model
family — contact-map GCNs over per-residue protein graphs plus a sequence-only
CNN fallback — fed by homology search against structure databases and
contact-map-to-query alignment.

Unlike the reference (serial per-protein ONNX inference, batch size 1,
reference ``mDeepFRI/predict.pyx:75-102``), the compute core here executes
length-bucketed mega-batches of protein graphs on an accelerator, with all
ontology modes evaluated in a single stacked forward pass, and scales over device meshes via
``jax.sharding`` / ``shard_map``.

Public registry mirrors the reference's mode registry and Hugging Face weight
links (reference ``mDeepFRI/__init__.py:47-80``).
"""

import os

__version__ = "0.1.0"

# Ontology / prediction mode registry (reference mDeepFRI/__init__.py:49-54).
DEEPFRI_MODES = {
    "bp": "GO Biological Process",
    "cc": "GO Cellular Component",
    "mf": "GO Molecular Function",
    "ec": "Enzyme Commission",
}

# Weight distribution endpoint (reference mDeepFRI/__init__.py:47). Weights are
# ONNX exports of the original TF2 DeepFRI models; we import them with our own
# ONNX reader (models/onnx_reader.py) — no onnxruntime dependency.
WEIGHTS_REPO_URL = "https://huggingface.co/valentynbez/mDeepFRI/resolve/main/"


def make_links(repo_url: str, prefix: str, terms) -> dict:
    """Build per-mode weight/config URL dict (reference mDeepFRI/__init__.py:57-65)."""
    return {
        term: {
            "model": os.path.join(repo_url, f"{prefix}_{term}.onnx"),
            "config": os.path.join(repo_url, f"{prefix}_{term}_model_params.json"),
        }
        for term in terms
    }


cnn_model_links = make_links(WEIGHTS_REPO_URL, "DeepCNN-MERGED", DEEPFRI_MODES.keys())

# v1.0 GCN covers all four modes; v1.1 drops EC (reference mDeepFRI/__init__.py:70-80).
gcn_model_links = {
    "1.0": make_links(
        WEIGHTS_REPO_URL,
        "DeepFRI-MERGED_GraphConv_gcd_512-512-512_fcd_1024_ca_10.0",
        DEEPFRI_MODES.keys(),
    ),
    "1.1": make_links(
        WEIGHTS_REPO_URL,
        "DeepFRI-UNIPROT_GraphConv_gcd_512-512-512_fcd_1024_ca_10.0_ext_desc",
        ["bp", "cc", "mf"],
    ),
}

__all__ = [
    "DEEPFRI_MODES",
    "WEIGHTS_REPO_URL",
    "cnn_model_links",
    "gcn_model_links",
    "make_links",
    "__version__",
]
