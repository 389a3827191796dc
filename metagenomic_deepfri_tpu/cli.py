"""Command-line interface.

Verb-for-verb parity with the reference CLI (reference ``mDeepFRI/cli.py``):
``get-models`` (:244-268), ``generate-config`` (:271-300),
``search-databases`` (:303-335), ``predict-function`` (:338-497),
``make-cmaps`` (:500-530), with the same shared ``search_options`` flag set
(:96-221), default thresholds (the clinical-grade foldseek-paper values), and
the full-help-on-usage-error behaviour (:67-92). Adds ``benchmark`` (device
throughput) — the reference keeps its benchmarks out-of-package.

Built on the standard library's ``argparse``: ``main(argv)`` parses
``argv`` (default ``sys.argv[1:]``) and runs the chosen verb.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path

import numpy as np

from metagenomic_deepfri_tpu import __version__

logger = logging.getLogger(__name__)

MODES = ["bp", "cc", "ec", "mf"]


def setup_logging(debug: bool = False):
    """Root logger configuration (reference cli.py:46-56)."""
    logging.basicConfig(
        level=logging.DEBUG if debug else logging.INFO,
        format="%(asctime)s %(levelname)-7s %(name)s :: %(message)s",
        datefmt="%Y-%m-%dT%H:%M:%S",
        handlers=[logging.StreamHandler(sys.stdout)],
        force=True,
    )


def log_command_params(params: dict):
    """Dump invocation parameters to the log (reference cli.py:59-64)."""
    logger.info("Command parameters:")
    max_key_len = max(len(k) for k in params)
    for key, value in params.items():
        logger.info(f"{key:<{max_key_len + 2}} : {value}")


class _Parser(argparse.ArgumentParser):
    """Print the full help before a usage error (reference cli.py:67-92)."""

    def error(self, message):
        self.print_help(sys.stderr)
        sys.stderr.write("\n")
        super().error(message)


def _path(exists: bool = False, file_okay: bool = True,
          dir_okay: bool = True):
    """argparse type: a ``Path``, optionally required to exist as a file
    and/or directory."""
    def convert(value: str) -> Path:
        path = Path(value)
        if exists and not path.exists():
            raise argparse.ArgumentTypeError(f"path {value!r} does not exist")
        if path.exists():
            if not file_okay and path.is_file():
                raise argparse.ArgumentTypeError(f"{value!r} is a file")
            if not dir_okay and path.is_dir():
                raise argparse.ArgumentTypeError(f"{value!r} is a directory")
        return path
    return convert


def _float_range(lo: float, hi: float):
    def convert(value: str) -> float:
        x = float(value)
        if not lo <= x <= hi:
            raise argparse.ArgumentTypeError(
                f"{x} is not in the range {lo}<=x<={hi}")
        return x
    return convert


def _default(text: str) -> str:
    """Help text with the default appended (click's ``show_default``)."""
    return (text + " " if text else "") + "[default: %(default)s]"


def _add_search_options(p: argparse.ArgumentParser):
    """Shared search flags (reference cli.py:96-221; defaults from
    https://doi.org/10.1038/s41586-023-06510-w)."""
    p.add_argument("-i", "--input", required=True,
                   type=_path(exists=True, dir_okay=False),
                   help="Path to input protein sequences (FASTA file, may be "
                        "gzipped).")
    p.add_argument("-o", "--output", required=True, type=_path(),
                   help="Path to output file or directory.")
    p.add_argument("-d", "--db-path", dest="db_path", action="append",
                   default=[], type=_path(exists=True),
                   help="Path to a structures database (FoldComp, FASTA, or "
                        "a directory of .pdb/.cif[.gz] files).")
    p.add_argument("-s", "--mmseqs-sensitivity", default=5.7,
                   type=_float_range(1, 7.5),
                   help=_default("Sensitivity of the MMseqs2 search."))
    p.add_argument("--min-length", default=None, type=int,
                   help="Minimum length of the protein sequence.")
    p.add_argument("--max-length", default=None, type=int,
                   help="Maximum length of the protein sequence.")
    p.add_argument("--mmseqs-min-bitscore", default=0, type=float,
                   help=_default("Minimum bitscore for search hits."))
    p.add_argument("--mmseqs-max-evalue", default=0.001, type=float,
                   help=_default("Maximum e-value for search hits."))
    p.add_argument("--mmseqs-min-identity", default=0.5, type=float,
                   help=_default("Minimum identity for search hits."))
    p.add_argument("--mmseqs-min-coverage", default=0.9, type=float,
                   help=_default("Minimum coverage for search hits (query "
                                 "and target)."))
    p.add_argument("--top-k", default=5, type=int,
                   help=_default("Number of top search hits to save."))
    p.add_argument("--overwrite", action="store_true",
                   help="Overwrite existing files.")
    p.add_argument("-t", "--threads", default=1, type=int,
                   help=_default("Number of threads to use."))
    p.add_argument("--skip-pdb", action="store_true",
                   help="Skip PDB100 database search.")
    p.add_argument("--tmpdir", default=None,
                   type=_path(file_okay=False),
                   help="Path to a temporary directory. Required for very "
                        "large searches.")
    p.add_argument("--shard", default=None, type=str,
                   help="'I/N': process only this host's deterministic slice "
                        "of the input catalogue (multi-host runs; merge the "
                        "per-host outputs with `merge-results`).")


def _search_kwargs(args) -> dict:
    return dict(mmseqs_sensitivity=args.mmseqs_sensitivity,
                min_bits=args.mmseqs_min_bitscore,
                max_eval=args.mmseqs_max_evalue,
                min_ident=args.mmseqs_min_identity,
                min_coverage=args.mmseqs_min_coverage,
                top_k=args.top_k,
                skip_pdb=args.skip_pdb,
                overwrite=args.overwrite,
                tmpdir=args.tmpdir,
                threads=args.threads)


def _command_params(args) -> dict:
    return {k: v for k, v in vars(args).items()
            if k not in ("func", "debug", "command")}


# ---------------------------------------------------------------------------
# Verbs
# ---------------------------------------------------------------------------

def get_models(args):
    """Download model weights (ONNX + vocabularies) for DeepFRI."""
    from metagenomic_deepfri_tpu.utils import (download_model_weights,
                                               generate_config_json)

    logger.info("Downloading DeepFRI models.")
    output_path = Path(args.output)
    output_path.mkdir(parents=True, exist_ok=True)
    download_model_weights(output_path, args.version)
    generate_config_json(output_path, args.version)
    logger.info("DeepFRI models v%s downloaded to %s.", args.version,
                output_path)


def get_binaries(args):
    """Download the external mmseqs/foldcomp engines for this CPU.

    The reference vendors these binaries at build time (its setup.py
    downloads per-arch tarballs from mmseqs.com); this verb fetches the
    same builds on demand into a tools directory that binary discovery
    checks automatically. Without them the package still works — built-in
    k-mer search, FASTA / PDB-directory databases — but FoldComp (.fcz)
    databases require foldcomp.
    """
    from metagenomic_deepfri_tpu.search.binaries import fetch_binaries

    wanted = [t.strip() for t in args.tools.split(",") if t.strip()]
    installed = fetch_binaries(args.output, wanted)
    for tool, path in installed.items():
        print(f"{tool}: {path}")


def generate_config(args):
    """Generate model_config.json for manually downloaded weights."""
    from metagenomic_deepfri_tpu.utils import generate_config_json

    logger.info("Generating config file.")
    generate_config_json(Path(args.weights_path), args.version)
    logger.info("Config file generated in %s.", args.weights_path)


def search_databases(args):
    """Hierarchically search structure databases for similar proteins."""
    from metagenomic_deepfri_tpu.pipeline import (
        hierarchical_database_search, load_query_file)

    log_command_params(_command_params(args))
    query_file = load_query_file(query_file=args.input,
                                 min_length=args.min_length,
                                 max_length=args.max_length,
                                 shard=args.shard)
    hierarchical_database_search(query_file=query_file,
                                 databases=args.db_path,
                                 output_path=args.output,
                                 **_search_kwargs(args))


def predict_function(args):
    """Predict protein function from sequence (full pipeline)."""
    from metagenomic_deepfri_tpu.pipeline import (
        hierarchical_database_search, load_query_file,
        predict_protein_function)

    logger.info("Starting metagenomic-deepfri.")
    output_path = Path(args.output)
    output_path.mkdir(parents=True, exist_ok=True)
    log_command_params(_command_params(args))

    def queries():
        return load_query_file(query_file=args.input,
                               min_length=args.min_length,
                               max_length=args.max_length, shard=args.shard)

    deepfri_dbs = hierarchical_database_search(
        query_file=queries(),
        output_path=output_path / "database_search",
        databases=args.db_path,
        **_search_kwargs(args))

    # refresh the query file: the search mutates it (reference cli.py:473-479)
    predict_protein_function(
        query_file=queries(),
        databases=tuple(deepfri_dbs),
        weights=args.weights,
        output_path=output_path,
        deepfri_processing_modes=list(args.processing_modes or MODES),
        angstrom_contact_threshold=args.angstrom_contact_thresh,
        generate_contacts=args.generate_contacts,
        alignment_gap_open=args.alignment_gap_open,
        alignment_gap_continuation=args.alignment_gap_extend,
        remove_intermediate=args.remove_intermediate,
        threads=args.threads,
        save_structures=args.save_structures,
        save_cmaps=args.save_cmaps,
        skip_matrix=args.skip_matrix,
        scoring_matrix=args.scoring_matrix,
        propagate_go_terms=args.propagate_go_terms,
        obo_path=args.obo_path)


def make_cmaps(args):
    """Compute CA contact maps for all PDB/mmCIF files in a directory."""
    from metagenomic_deepfri_tpu.bio_utils import (calculate_contact_map,
                                                   get_residues_coordinates,
                                                   load_structure)

    input_dir, output_dir = args.input_dir, args.output_dir
    os.makedirs(output_dir, exist_ok=True)
    for fname in os.listdir(input_dir):
        if not fname.endswith((".pdb", ".cif")):
            continue
        filetype = "pdb" if fname.endswith(".pdb") else "mmcif"
        with open(os.path.join(input_dir, fname), encoding="utf-8") as f:
            structure_str = f.read()
        residues, coords = get_residues_coordinates(
            load_structure(structure_str, filetype), chain="A")
        cmap = calculate_contact_map(coords, args.threshold)
        # Divergence from reference cli.py:517-531, which only strips a
        # ".pdb" suffix so an mmCIF input saves as "X.cif.npy"; we strip
        # whichever structure extension the input actually has.
        stem = fname[:-4]
        np.save(os.path.join(output_dir, stem + "_cmap.npy"), cmap)


def serve(args):
    """Run a resident annotation server on a Unix socket (JSONL protocol).

    Models stay on device and databases stay indexed between requests —
    the serving counterpart of the batch `predict-function` verb. Protocol:
    one JSON object per line, {"proteins": {id: sequence, ...}} in,
    {"results": ..., "skipped": ...} out.
    """
    from metagenomic_deepfri_tpu.serving import AnnotationServer

    server = AnnotationServer(
        args.weights,
        databases=list(args.db_path),
        processing_modes=list(args.processing_modes) or None,
        max_eval=args.mmseqs_max_evalue,
        min_ident=args.mmseqs_min_identity,
        min_coverage=args.mmseqs_min_coverage,
        top_k=args.top_k,
        threads=args.threads,
        obo_path=args.obo_path)
    server.serve_unix(args.socket_path)


def finetune(args):
    """Fine-tune a GCN on labelled structures (mesh-sharded train step).

    Writes a native .npz checkpoint plus an ONNX re-export + params JSON,
    so the result plugs back into the inference registry.
    """
    from metagenomic_deepfri_tpu.training import finetune as run_finetune

    path = run_finetune(args.weights, args.mode, args.structures, args.labels,
                        args.output, epochs=args.epochs,
                        learning_rate=args.learning_rate,
                        batch_size=args.batch_size,
                        contact_threshold=args.angstrom_contact_thresh,
                        model_parallel=args.model_parallel, seed=args.seed)
    print(f"Fine-tuned checkpoint written to {path}")


def merge_results(args):
    """Merge per-host `--shard I/N` pipeline outputs into one directory."""
    from metagenomic_deepfri_tpu.parallel.multihost import merge_shard_results

    for path in merge_shard_results(args.shard_dirs, args.output):
        print(str(path))


def verify_weights(args):
    """Check JAX-vs-ONNX numerical parity for every model in a weights dir.

    Mirrors the reference's ONNX-vs-TF2 conversion validation
    (weight_convert/README.md): each imported model's scores AND pre-softmax
    logits must match executing its actual ONNX graph on random proteins.
    """
    from metagenomic_deepfri_tpu.parity import verify_weights as run_verify

    results = run_verify(args.weights, n_proteins=args.n_proteins,
                         tolerance=args.tolerance,
                         logit_tolerance=args.logit_tolerance,
                         seed=args.seed, trace=args.trace)
    failed = [r for r in results if not r.ok]
    for r in results:
        print(f"{r.net}/{r.mode}: scores max|diff|={r.max_abs_diff:.2e}"
              f" logits max|diff|={r.max_logit_diff:.2e} "
              f"({'OK' if r.ok else 'FAIL'})")
    if failed:
        raise SystemExit(f"Error: {len(failed)}/{len(results)} models exceed "
                         f"tolerance {args.tolerance}")
    print(f"All {len(results)} models within {args.tolerance}.")


def benchmark(args):
    """Measure GCN inference throughput (proteins/sec) on this device."""
    from metagenomic_deepfri_tpu.bench_utils import run_gcn_benchmark

    print(run_gcn_benchmark(bucket=args.bucket, batches=args.batches,
                            n_labels=args.n_labels))


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

def _verb(sub, name: str, func, **kw) -> argparse.ArgumentParser:
    doc = func.__doc__ or ""
    p = sub.add_parser(name, help=doc.strip().splitlines()[0],
                       description=doc,
                       formatter_class=argparse.RawDescriptionHelpFormatter,
                       **kw)
    p.set_defaults(func=func)
    return p


def build_parser() -> argparse.ArgumentParser:
    parser = _Parser(
        prog="mdeepfri",
        description="metagenomic-deepfri — protein function annotation "
                    "with the DeepFRI model family on JAX.")
    parser.add_argument("--debug", dest="debug", action="store_true",
                        default=False)
    parser.add_argument("--no-debug", dest="debug", action="store_false")
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s, version {__version__}")
    sub = parser.add_subparsers(dest="command", metavar="COMMAND",
                                parser_class=_Parser)
    sub.required = True

    p = _verb(sub, "get-models", get_models)
    p.add_argument("-o", "--output", required=True,
                   type=_path(file_okay=False),
                   help="Path to folder where the model weights will be "
                        "downloaded.")
    p.add_argument("-v", "--version", required=True, choices=["1.0", "1.1"],
                   help="Version of the model.")

    p = _verb(sub, "get-binaries", get_binaries)
    p.add_argument("-o", "--output", default=None,
                   type=_path(file_okay=False),
                   help="Install directory (default: ~/.local/share/mdeepfri/"
                        "bin, override with MDEEPFRI_TOOLS_DIR).")
    p.add_argument("--tools", default="mmseqs,foldcomp",
                   help=_default("Comma-separated subset of: mmseqs, "
                                 "foldcomp."))

    p = _verb(sub, "generate-config", generate_config)
    p.add_argument("-w", "--weights_path", required=True,
                   type=_path(exists=True, file_okay=False),
                   help="Path to a folder containing model weights.")
    p.add_argument("-v", "--version", required=True, choices=["1.0", "1.1"],
                   help="Version of the model.")

    p = _verb(sub, "search-databases", search_databases)
    _add_search_options(p)

    p = _verb(sub, "predict-function", predict_function)
    _add_search_options(p)
    p.add_argument("-w", "--weights", required=True,
                   type=_path(exists=True, file_okay=False),
                   help="Path to a folder containing model weights.")
    p.add_argument("-p", "--processing-modes", action="append",
                   choices=MODES, default=None,
                   help="Processing modes. Default is all (biological "
                        "process, cellular component, enzyme commission, "
                        "molecular function).")
    p.add_argument("-a", "--angstrom-contact-thresh", default=6, type=float,
                   help="Angstrom contact threshold. Default is 6.")
    p.add_argument("--generate-contacts", default=2, type=int,
                   help="Gap fill threshold during contact map alignment.")
    p.add_argument("--alignment-gap-open", default=10, type=int,
                   help="Gap open penalty for alignment.")
    p.add_argument("--alignment-gap-extend", default=1, type=int,
                   help="Gap extend penalty for alignment.")
    p.add_argument("--remove-intermediate", action="store_true",
                   help="Remove intermediate files.")
    p.add_argument("--save-structures", action="store_true",
                   help="Save structures of the top hits.")
    p.add_argument("--save-cmaps", action="store_true",
                   help="Save contact maps of the top hits.")
    p.add_argument("--skip-matrix", action="store_true",
                   help="Skip writing prediction matrix files (saves disk "
                        "space).")
    p.add_argument("--scoring-matrix", default="auto",
                   help=_default("Scoring matrix for sequence alignment "
                                 "(name or NCBI matrix file)."))
    p.add_argument("--propagate-go-terms", action="store_true",
                   help="Propagate GO terms up the ontology DAG (true-path "
                        "rule).")
    p.add_argument("--obo-path", default=None, type=_path(dir_okay=False),
                   help="Path to a GO OBO file (go-basic.obo); downloaded "
                        "automatically when needed if not provided.")

    p = _verb(sub, "make-cmaps", make_cmaps)
    p.add_argument("-i", "--input_dir", required=True,
                   type=_path(exists=True),
                   help="Directory containing PDB or mmCIF files.")
    p.add_argument("-o", "--output_dir", required=True, type=_path(),
                   help="Directory to save computed contact maps.")
    p.add_argument("-t", "--threshold", default=6.0, type=float,
                   help=_default("Distance threshold in Å for contact map."))

    p = _verb(sub, "serve", serve)
    p.add_argument("-w", "--weights", required=True, type=_path(exists=True),
                   help="Path to the folder containing model weights.")
    p.add_argument("-d", "--db-path", dest="db_path", action="append",
                   default=[], type=_path(exists=True),
                   help="Structure database(s): FoldComp, FASTA, or a "
                        "directory of .pdb/.cif files. Omit for "
                        "sequence-only (CNN) serving.")
    p.add_argument("--socket", dest="socket_path", required=True,
                   type=_path(), help="Unix socket path to listen on.")
    p.add_argument("-p", "--processing-modes", action="append",
                   choices=["bp", "cc", "mf", "ec"], default=[],
                   help="Modes to serve (default: all in model_config.json).")
    p.add_argument("-t", "--threads", default=1, type=int,
                   help=_default(""))
    p.add_argument("--top-k", default=5, type=int, help=_default(""))
    p.add_argument("--mmseqs-max-evalue", default=1e-5, type=float,
                   help=_default(""))
    p.add_argument("--mmseqs-min-identity", default=0.5, type=float,
                   help=_default(""))
    p.add_argument("--mmseqs-min-coverage", default=0.9, type=float,
                   help=_default(""))
    p.add_argument("--obo", dest="obo_path", default=None,
                   type=_path(exists=True),
                   help="go-basic.obo file: responses gain per-protein "
                        "propagated_scores (true-path GO propagation, the "
                        "serving analogue of results_propagated.tsv).")

    p = _verb(sub, "finetune", finetune)
    p.add_argument("-w", "--weights", required=True, type=_path(exists=True),
                   help="Base model weights folder (model_config.json "
                        "layout).")
    p.add_argument("-m", "--mode", required=True,
                   choices=["bp", "cc", "mf", "ec"],
                   help="Ontology mode whose GCN to fine-tune.")
    p.add_argument("-i", "--structures", required=True,
                   type=_path(exists=True, file_okay=False),
                   help="Directory of labelled .pdb/.cif structure files.")
    p.add_argument("-l", "--labels", required=True,
                   type=_path(exists=True, dir_okay=False),
                   help="TSV: protein<TAB>GO:...;GO:... per line.")
    p.add_argument("-o", "--output", required=True, type=_path(),
                   help="Output directory for the fine-tuned checkpoint/"
                        "ONNX.")
    p.add_argument("--epochs", default=5, type=int, help=_default(""))
    p.add_argument("--learning-rate", default=1e-4, type=float,
                   help=_default(""))
    p.add_argument("--batch-size", default=8, type=int, help=_default(""))
    p.add_argument("--model-parallel", default=1, type=int,
                   help=_default("Tensor-parallel size of the device mesh "
                                 "(rest is DP)."))
    p.add_argument("--angstrom-contact-thresh", default=6.0, type=float,
                   help=_default(""))
    p.add_argument("--seed", default=0, type=int, help=_default(""))

    p = _verb(sub, "merge-results", merge_results)
    p.add_argument("shard_dirs", nargs="+",
                   type=_path(exists=True, file_okay=False))
    p.add_argument("-o", "--output", required=True, type=_path(),
                   help="Directory for the merged catalogue-level results.")

    p = _verb(sub, "verify-weights", verify_weights)
    p.add_argument("-w", "--weights", required=True, type=_path(exists=True),
                   help="Path to the folder containing model weights.")
    p.add_argument("--n-proteins", default=10, type=int,
                   help=_default("Random proteins per model."))
    p.add_argument("--tolerance", default=1e-4, type=float,
                   help=_default("Max allowed abs score difference JAX vs "
                                 "ONNX."))
    p.add_argument("--logit-tolerance", default=None, type=float,
                   help="Max allowed abs PRE-softmax logit difference "
                        "(defaults to --tolerance); the sharp oracle.")
    p.add_argument("--trace", action="store_true",
                   help="On failure, log a per-stage divergence report "
                        "(embed/gc*/pooled/fc*/logits) to localise the "
                        "culprit.")
    p.add_argument("--seed", default=0, type=int, help=_default(""))

    p = _verb(sub, "benchmark", benchmark)
    p.add_argument("--bucket", default=512, type=int,
                   help=_default("Length bucket to benchmark."))
    p.add_argument("--batches", default=8, type=int,
                   help=_default("Number of timed batches."))
    p.add_argument("--n-labels", default=512, type=int, help=_default(""))
    return parser


VERBS = ("get-models", "get-binaries", "generate-config", "search-databases",
         "predict-function", "make-cmaps", "serve", "finetune",
         "merge-results", "verify-weights", "benchmark")


def main(argv=None):
    """Console entry point: parse ``argv`` and run the chosen verb."""
    args = build_parser().parse_args(argv)
    for log in [logging.getLogger(name)
                for name in logging.root.manager.loggerDict]:
        log.setLevel(logging.DEBUG if args.debug else logging.INFO)
    setup_logging(args.debug)
    # The persistent compile cache is enabled by the components that
    # initialise the JAX backend (engine construction, training, benches),
    # so pure-HTTP verbs like get-models never start a backend.
    args.func(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
