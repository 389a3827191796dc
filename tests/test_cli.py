"""CLI wiring tests (reference ``tests/test_cli.py`` scope: version + help),
plus a real make-cmaps run."""

import numpy as np
import pytest

from metagenomic_deepfri_tpu import __version__
from metagenomic_deepfri_tpu.cli import VERBS, main

PDB = """ATOM      2  CA  MET A   1      11.639   6.071  -5.147  1.00  0.00           C
ATOM      3  CA  LYS A   2      12.685   9.140  -4.392  1.00  0.00           C
ATOM      4  CA  GLY A   3      15.125   8.370  -1.512  1.00  0.00           C
END
"""


def _exit_code(argv) -> int:
    """Run ``main(argv)``; the exit code (argparse exits via SystemExit)."""
    try:
        return main(argv) or 0
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else 1


def test_version(capsys):
    assert _exit_code(["--version"]) == 0
    assert __version__ in capsys.readouterr().out


def test_help_lists_commands(capsys):
    assert _exit_code(["--help"]) == 0
    out = capsys.readouterr().out
    for cmd in VERBS:
        assert cmd in out


@pytest.mark.parametrize("verb", VERBS)
def test_verb_help(verb, capsys):
    assert _exit_code([verb, "--help"]) == 0
    assert capsys.readouterr().out.startswith("usage:")


def test_subcommand_help(capsys):
    for cmd in ("predict-function", "search-databases"):
        assert _exit_code([cmd, "--help"]) == 0
        assert "--mmseqs-min-coverage" in capsys.readouterr().out


def test_usage_error_exits_nonzero(capsys):
    assert _exit_code(["predict-function"]) == 2
    err = capsys.readouterr().err
    assert "usage:" in err and "required" in err


def test_make_cmaps(tmp_path):
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "test.pdb").write_text(PDB)
    assert _exit_code([
        "make-cmaps", "-i", str(tmp_path / "in"),
        "-o", str(tmp_path / "out"), "-t", "6.0"]) == 0
    cmap = np.load(tmp_path / "out" / "test_cmap.npy")
    assert cmap.shape == (3, 3)
    assert cmap[0, 1] == 1  # consecutive CAs ~3.8 Å apart


def test_verify_weights(tmp_path, capsys):
    """The parity harness passes on a freshly exported weights folder and
    fails when a weight file is corrupted."""
    import json

    import jax
    import numpy as np

    from metagenomic_deepfri_tpu.models.deepfri import (CNNConfig, GCNConfig,
                                                        init_cnn, init_gcn)
    from metagenomic_deepfri_tpu.models.onnx_import import (export_cnn_to_onnx,
                                                            export_gcn_to_onnx)
    from metagenomic_deepfri_tpu.utils import generate_config_json

    gcn_cfg = GCNConfig(n_labels=4, lm_hidden=8, lm_layers=1, embed_dim=16,
                        gc_dims=(8, 12), fc_dims=(16,), adj_norm="none")
    cnn_cfg = CNNConfig(n_labels=4, conv_filters=8, conv_kernels=(3,),
                        fc_dims=(16,))
    w = tmp_path / "weights"
    w.mkdir()
    goterms = [f"GO:000000{i}" for i in range(4)]
    key = jax.random.PRNGKey(0)
    for mode in ("bp", "cc", "mf", "ec"):
        k1, k2, key = jax.random.split(key, 3)
        g = f"DeepFRI-MERGED_GraphConv_gcd_8-12_fcd_16_ca_10.0_{mode}.onnx"
        c = f"DeepCNN-MERGED_{mode}.onnx"
        export_gcn_to_onnx(init_gcn(k1, gcn_cfg), gcn_cfg, str(w / g))
        export_cnn_to_onnx(init_cnn(k2, cnn_cfg), cnn_cfg, str(w / c))
        for name in (g, c):
            with open(w / (name[:-5] + "_model_params.json"), "w") as f:
                json.dump({"goterms": goterms, "gonames": goterms}, f)
    generate_config_json(w, "1.0")

    assert _exit_code(["verify-weights", "-w", str(w),
                       "--n-proteins", "2"]) == 0
    assert "All 8 models within" in capsys.readouterr().out

    # a mis-importing registry (the failure class this harness exists to
    # catch: JAX import diverging from the graph) must be flagged
    import metagenomic_deepfri_tpu.models.registry as registry_mod

    real_import = registry_mod.import_gcn_params

    def broken_import(graph, config):
        params = real_import(graph, config)
        params["fc"][0]["kernel"] = params["fc"][0]["kernel"] + 0.5
        return params

    monkeypatch = None
    try:
        from _pytest.monkeypatch import MonkeyPatch

        monkeypatch = MonkeyPatch()
        monkeypatch.setattr(registry_mod, "import_gcn_params", broken_import)
        assert _exit_code(["verify-weights", "-w", str(w),
                           "--n-proteins", "2"]) != 0
    finally:
        if monkeypatch:
            monkeypatch.undo()
