"""Pipeline orchestration: hierarchical search → alignment → batched inference.

Behaviour parity with reference ``mDeepFRI/pipeline.py``:

- ``load_query_file`` (:66-104): load, drop selenoproteins, length-filter.
- ``hierarchical_database_search`` (:107-267): PDB100 first unless skipped,
  then user databases in order; per-DB filter (coverage/identity/bits) and
  top-k; per-DB results TSV; queries with non-PDB hits removed from later
  searches while PDB hits stay in play for predicted-structure rescue.
- ``predict_protein_function`` (:322-772): per-DB re-alignment → coords →
  contact-map alignment → ``alignment_summary.tsv`` → per-mode prediction
  matrices (split per network when GCN/CNN vocabularies differ) →
  ``results.tsv`` (score ≥ 0.1, sorted desc) → optional GO propagation →
  optional cleanup.

The execution core differs: instead of a serial per-protein ONNX loop
(reference :292-319), all proteins are packed into length-bucketed device
batches and every requested mode runs while a batch is resident
(:mod:`.batching.engine`).
"""

from __future__ import annotations

import csv
import logging
import pathlib
import pickle
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from metagenomic_deepfri_tpu import DEEPFRI_MODES
from metagenomic_deepfri_tpu.align.pairwise import align_mmseqs_results
from metagenomic_deepfri_tpu.batching.engine import BatchedPredictor
from metagenomic_deepfri_tpu import profiling
from metagenomic_deepfri_tpu.bio_utils import (build_align_contact_map,
                                               build_align_projection)
from metagenomic_deepfri_tpu.checkpoint import PredictionCheckpoint
from metagenomic_deepfri_tpu.models.registry import load_models
from metagenomic_deepfri_tpu.search.database import Database, build_database
from metagenomic_deepfri_tpu.search.pdb import (create_pdb_mmseqs,
                                                extract_calpha_coords)
from metagenomic_deepfri_tpu.search.query import QueryFile
from metagenomic_deepfri_tpu.search.results import SearchResults
from metagenomic_deepfri_tpu.utils import (get_json_values,
                                           remove_intermediate_files)

logger = logging.getLogger(__name__)

ALIGNMENT_HEADER = [
    "query_id", "aligned", "target_id", "db_name", "query_identity",
    "query_coverage", "target_coverage",
]
FINAL_OUTPUT_HEADER = [
    "protein", "network_type", "prediction_mode", "go_term", "score",
    "go_name", "aligned", "target_id", "db_name", "query_identity",
    "query_coverage", "target_coverage",
]
NAN_ALIGNMENT_INFO = [np.nan] * 6
SCORE_THRESHOLD = 0.1  # reference pipeline.py:701,735


class ProgressLog:
    """Periodic ``logger.info`` progress lines for a long inference phase.

    ``update(n)`` counts finished items; a line is logged at most every
    ``interval_s`` seconds, and ``close()`` logs the final count.
    """

    def __init__(self, desc: str, total: Optional[int] = None,
                 interval_s: float = 10.0):
        self.desc = desc
        self.total = total
        self.interval_s = interval_s
        self.n = 0
        self._t0 = self._last = time.monotonic()

    def _log(self, now: float) -> None:
        elapsed = now - self._t0
        rate = self.n / elapsed if elapsed > 0 else 0.0
        of = f"/{self.total}" if self.total is not None else ""
        logger.info("%s: %d%s [%.1f/s]", self.desc, self.n, of, rate)

    def update(self, n: int) -> None:
        self.n += n
        now = time.monotonic()
        if now - self._last >= self.interval_s:
            self._last = now
            self._log(now)

    def close(self) -> None:
        self._log(time.monotonic())


def load_query_file(query_file,
                    min_length: Optional[int] = None,
                    max_length: Optional[int] = None,
                    shard: Optional[str] = None) -> QueryFile:
    """Load + filter sequences (reference pipeline.py:66-104).

    ``shard="I/N"`` keeps only this host's deterministic slice of the
    catalogue (multi-host input sharding —
    :mod:`metagenomic_deepfri_tpu.parallel.multihost`); per-host outputs
    merge with ``merge_shard_results`` / the ``merge-results`` CLI verb.
    """
    qf = QueryFile(filepath=query_file)
    qf.load_sequences()
    removed_seleno = qf.remove_selenocysteine()
    if removed_seleno:
        logger.info("Removed %d selenoproteins (U residues): %s",
                    len(removed_seleno), ", ".join(removed_seleno))
    if min_length or max_length:
        lo = min_length or 0
        hi = max_length or float("inf")
        qf.filter_sequences(lambda x: lo <= len(x) <= hi)
    if shard:
        from metagenomic_deepfri_tpu.parallel.multihost import shard_of

        try:
            idx_s, count_s = str(shard).split("/")
            idx, count = int(idx_s), int(count_s)
        except ValueError as e:
            raise ValueError(f"shard must look like 'I/N', got {shard!r}") \
                from e
        if not 0 <= idx < count:
            raise ValueError(f"shard index {idx} not in [0, {count})")
        before = len(qf.sequences)
        drop = [qid for qid in qf.sequences
                if shard_of(qid, count) != idx]
        qf.remove_sequences(drop)
        logger.info("Shard %d/%d: keeping %d/%d queries.",
                    idx, count, len(qf.sequences), before)
    return qf


def hierarchical_database_search(query_file: QueryFile,
                                 output_path,
                                 databases: Iterable = (),
                                 mmseqs_sensitivity: float = 5.7,
                                 min_bits: float = 0,
                                 max_eval: float = 1e-5,
                                 min_ident: float = 0.5,
                                 min_coverage: float = 0.9,
                                 top_k: int = 5,
                                 skip_pdb: bool = False,
                                 overwrite: bool = False,
                                 tmpdir=None,
                                 threads: int = 1) -> List[Database]:
    """Search each database in order, filter + top-k, persist per-DB TSVs
    (reference pipeline.py:107-267)."""
    output_path = pathlib.Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    sequence_num_start = len(query_file.sequences)

    for idx, seq in query_file.filtered_out.items():
        logger.info("Skipping %s; sequence length %d aa.", idx, len(seq))

    dbs: List[Database] = []
    if not skip_pdb:
        logger.info("Creating PDB100 database.")
        dbs.append(create_pdb_mmseqs(threads=threads))
        logger.info("PDB100 database created.")
    for database in databases:
        database = pathlib.Path(database)
        dbs.append(build_database(input_path=database,
                                  output_path=database.parent,
                                  overwrite=overwrite,
                                  threads=threads))

    aligned_total = 0
    pdb_hits: set = set()
    for db in dbs:
        with profiling.stage(f"search/{db.name}",
                             items=len(query_file.sequences)):
            results = query_file.search(db.mmseqs_db,
                                        mmseqs_sensitivity=mmseqs_sensitivity,
                                        eval=max_eval,
                                        threads=threads,
                                        tmpdir=tmpdir)
        filtered = results.apply_filters(min_cov=min_coverage,
                                         min_bits=min_bits,
                                         min_ident=min_ident)
        best_matches = filtered.find_best_matches(top_k, threads=threads)
        best_matches.query_fasta = results.query_fasta
        best_matches.database = str(db.sequence_db)

        mmseqs_results_path = output_path / f"{db.name}_results.tsv"
        best_matches.save(mmseqs_results_path)
        db.mmseqs_result = mmseqs_results_path

        all_hits = (np.unique(best_matches["query"])
                    if len(best_matches) else np.array([]))
        unique_hits = all_hits
        if "pdb100" in db.name:
            pdb_hits.update(all_hits.tolist())
        elif not skip_pdb:
            unique_hits = [h for h in all_hits if h not in pdb_hits]

        aligned_db = len(unique_hits)
        aligned_total += aligned_db
        denom = max(sequence_num_start, 1)
        logger.info("Aligned %d/%d (%.2f%%) proteins against %s.",
                    aligned_db, sequence_num_start,
                    aligned_db / denom * 100, db.name)
        logger.info("Aligned %d/%d (%.2f%%) proteins in total.",
                    aligned_total, sequence_num_start,
                    aligned_total / denom * 100)

        # queries hit in non-PDB DBs drop out of subsequent searches; PDB
        # hits are re-searched against predicted DBs to rescue failed
        # contact-map alignments (reference pipeline.py:259-265)
        if "pdb100" not in db.name:
            query_file.remove_sequences(list(all_hits))
    return dbs


def _initialize_processing_modes(modes: List[str],
                                 config: Dict[str, Any]) -> List[str]:
    """v1.1 models drop EC prediction (reference pipeline.py:274-289)."""
    filtered = list(modes)
    if config.get("version") == "1.1" and "ec" in filtered:
        filtered.remove("ec")
        logger.info("EC number prediction is not supported in version 1.1.")
    if not filtered:
        raise ValueError("No processing modes selected.")
    return filtered


def _load_blocklist(db_name: str) -> set:
    """Known-broken FoldComp entries for a database.

    The reference filters highquality_clust30 hits against a 27,675-entry
    pickle asset (reference ``pipeline.py:432-444``,
    ``assets/highquality_clust30_error_ids.pkl`` — entries whose
    decompression segfaults foldcomp). We ship the same ID set as a gzipped
    text file (``assets/{db}_error_ids.txt.gz`` — no pickle execution on
    load, 4× smaller) and also accept a user-supplied ``.pkl``/``.txt[.gz]``
    via ``MDEEPFRI_BLOCKLIST``.
    """
    import gzip
    import os

    candidates = []
    env = os.environ.get("MDEEPFRI_BLOCKLIST")
    if env:
        candidates.append(pathlib.Path(env))
    assets = pathlib.Path(__file__).parent / "assets"
    candidates.append(assets / f"{db_name}_error_ids.txt.gz")
    candidates.append(assets / f"{db_name}_error_ids.pkl")
    for path in candidates:
        if not path.exists():
            continue
        if path.suffix == ".pkl":
            with open(path, "rb") as f:
                return set(pickle.load(f))
        opener = gzip.open if path.suffix == ".gz" else open
        with opener(path, "rt", encoding="utf-8") as f:
            return {line.strip() for line in f if line.strip()}
    return set()


def predict_protein_function(
        query_file: QueryFile,
        databases: Tuple[Database, ...],
        weights,
        output_path,
        deepfri_processing_modes: List[str] = ["ec", "bp", "mf", "cc"],
        angstrom_contact_threshold: float = 6,
        generate_contacts: int = 2,
        alignment_gap_open: float = 10,
        alignment_gap_continuation: float = 1,
        remove_intermediate: bool = False,
        threads: int = 1,
        save_structures: bool = False,
        save_cmaps: bool = False,
        skip_matrix: bool = False,
        scoring_matrix: str = "auto",
        propagate_go_terms: bool = False,
        obo_path=None):
    """Main prediction phase (reference pipeline.py:322-772)."""
    from metagenomic_deepfri_tpu.utils import load_deepfri_config

    deepfri_models_config = load_deepfri_config(weights)
    deepfri_processing_modes = _initialize_processing_modes(
        deepfri_processing_modes, deepfri_models_config)

    output_path = pathlib.Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)

    # ---- alignment + contact-map stage --------------------------------------
    # Runs as a PRODUCER: each database's pyOpal-style re-alignment,
    # coordinate extraction, and O(L) projection happen on host threads while
    # the consumer (the batched device engine below) is already predicting the
    # previous database's proteins — removing the reference's strict phase
    # barrier between CPU preprocessing and accelerator compute (SURVEY.md §7
    # hard part (e); reference cli.py:458-497).
    aligned_cmaps: List[tuple] = []

    def _produce_aligned(emit):
        """Walk databases in order, appending to aligned_cmaps and calling
        ``emit((aln, (proj, ins)))`` for each successfully projected hit."""
        for db in databases:
            with profiling.stage(f"align/{db.name}"):
                alignments = align_mmseqs_results(
                    best_matches_filepath=db.mmseqs_result,
                    sequence_db=db.sequence_db,
                    alignment_gap_open=alignment_gap_open,
                    alignment_gap_extend=alignment_gap_continuation,
                    threads=threads,
                    scoring_matrix=scoring_matrix)
            if not alignments:
                logger.info("No alignments found for %s.", db.name)
                continue
            for aln in alignments:
                aln.db_name = db.name

            aligned_queries = {a[0].query_name for a in aligned_cmaps}
            new_alignments = {
                aln.query_name: aln
                for aln in alignments
                if aln.query_name not in aligned_queries
                and aln.query_name in query_file.sequences
            }

            blocklist = _load_blocklist(db.name)
            if blocklist:
                new_alignments = {
                    q: a for q, a in new_alignments.items()
                    if a.target_name not in blocklist
                }
            if not new_alignments:
                continue

            query_ids = [a.query_name for a in new_alignments.values()]
            target_ids = [a.target_name.rsplit(".", 1)[0]
                          for a in new_alignments.values()]

            save_dir = None
            if save_structures:
                save_dir = output_path / "structures" / db.name
                save_dir.mkdir(parents=True, exist_ok=True)
            try:
                with profiling.stage(f"coords/{db.name}",
                                     items=len(query_ids)):
                    coords = extract_calpha_coords(db, target_ids,
                                                   query_ids,
                                                   save_directory=save_dir,
                                                   threads=threads)
            except RuntimeError as e:
                logger.warning("Coordinate extraction failed for %s (%s); "
                               "queries fall back to sequence-only "
                               "prediction.", db.name, e)
                continue
            for aln, coord in zip(new_alignments.values(), coords):
                aln.coords = coord

            # Fused-path prep: O(L) coordinate projection per protein;
            # adjacency is built on device inside the batched GCN step.
            with profiling.stage(f"cmap/{db.name}"), \
                    ThreadPoolExecutor(max_workers=max(threads, 1)) as pool:
                cmaps = list(pool.map(build_align_projection,
                                      new_alignments.values()))

            partial_cmaps = [c for c in cmaps if c[1] is not None]
            for pair in partial_cmaps:
                aligned_cmaps.append(pair)
                emit(pair)
            denom = max(len(query_file.sequences), 1)
            logger.info(
                "Aligned %d/%d (%.2f%%) proteins against %s "
                "[without length invalid].", len(partial_cmaps), denom,
                len(partial_cmaps) / denom * 100, db.name)
            logger.info(
                "Aligned %d/%d (%.2f%%) proteins in total "
                "[without length invalid].", len(aligned_cmaps), denom,
                len(aligned_cmaps) / denom * 100)

    # ---- models + engine (loaded BEFORE alignment so inference overlaps) ----
    with profiling.stage("load/models"):
        gcn_handles, cnn_handles, _ = load_models(weights,
                                                  deepfri_processing_modes)
    # Use every visible device: data-parallel mesh over the local devices
    # (single-device → plain jit). The reference is single-accelerator only.
    import jax as _jax
    mesh = None
    if _jax.device_count() > 1:
        from metagenomic_deepfri_tpu.parallel import make_mesh
        mesh = make_mesh(model_parallel=1)
        logger.info("Sharding inference over %d devices (data-parallel).",
                    _jax.device_count())
    # Under --skip-matrix only scores ≥ SCORE_THRESHOLD reach results.tsv,
    # so large heads (BP: 3992 terms) need not ship their dense float32
    # score matrix over the link: the engine fetches top-k (exact values)
    # and flags the rare proteins with more than k above-threshold terms,
    # which are re-run densely below. With matrices requested, every score
    # must be exact — compaction stays off.
    score_topk = 256 if skip_matrix else None
    predictor = BatchedPredictor(gcn_models=gcn_handles,
                                 cnn_models=cnn_handles,
                                 contact_threshold=angstrom_contact_threshold,
                                 generated_contacts=generate_contacts,
                                 score_topk=score_topk,
                                 score_threshold=SCORE_THRESHOLD,
                                 mesh=mesh)
    overflow: Dict[str, Dict[str, set]] = {"gcn": {}, "cnn": {}}

    def _overflow_collector(net: str):
        # Marks are persisted (ckpt.mark_overflow) the moment the engine
        # reports them: the streamed checkpoint part for these qids holds
        # top-k-truncated rows, so a crash before the dense re-run must
        # leave a durable record that they still need dense scores.
        def cb(mode, qids):
            qids = set(qids)
            overflow[net].setdefault(mode, set()).update(qids)
            ckpt.mark_overflow(net, mode, sorted(qids))
        return cb
    # Pre-compile the program shapes this workload will actually dispatch
    # (derived from the query length histogram — an upper bound for both
    # the GCN and the CNN-fallback populations), on a background thread:
    # executable compile/load overlaps the CPU-side alignment phase so
    # inference starts hot, and straggler flushes reuse the warmed shapes
    # instead of compiling fresh ones on the critical path.
    from collections import Counter

    from metagenomic_deepfri_tpu.batching.buckets import assign_bucket
    expected = Counter(assign_bucket(len(s), predictor.buckets)
                       for s in query_file.sequences.values())
    warmup_future = predictor.warmup(expected=dict(expected)) \
        if expected else None

    # Streaming checkpoint: a killed run resumes here instead of recomputing
    # every score (the reference restarts inference from scratch).
    ckpt = PredictionCheckpoint(output_path / "checkpoints")
    done_gcn = ckpt.completed("gcn", list(gcn_handles))
    done_cnn = ckpt.completed("cnn", list(cnn_handles))
    if done_gcn or done_cnn:
        logger.info("Checkpoint resume: skipping %d GCN and %d CNN queries "
                    "with complete scores.", len(done_gcn), len(done_cnn))

    # ---- overlapped alignment (producer thread) + GCN inference (consumer) --
    import queue as _queue
    import threading as _threading

    work_q: "_queue.Queue" = _queue.Queue(maxsize=4096)
    stop = _threading.Event()
    producer_exc: list = []

    def _safe_put(item) -> bool:
        while True:
            try:
                work_q.put(item, timeout=0.5)
                return True
            except _queue.Full:
                if stop.is_set():  # consumer gone — stop feeding
                    return False

    def _emit(pair):
        aln, (proj, ins) = pair
        if aln.query_name in done_gcn:
            return
        _safe_put((aln.query_name, aln.query_sequence, proj, ins))

    def _producer():
        try:
            _produce_aligned(_emit)
        except BaseException as e:  # surfaced after join
            producer_exc.append(e)
        finally:
            _safe_put(None)

    def _items_iter():
        while True:
            item = work_q.get()
            if item is None:
                return
            yield item

    gcn_bar = ProgressLog("Predicting (GCN)")
    producer_thread = _threading.Thread(target=_producer, daemon=True)
    producer_thread.start()
    try:
        with profiling.stage("inference/gcn"):
            n_gcn = predictor.predict_stream(
                _items_iter(), net="gcn_coords", modes=list(gcn_handles),
                result_cb=lambda part: ckpt.add("gcn", part),
                progress_cb=gcn_bar.update,
                overflow_cb=_overflow_collector("gcn"))
        profiling.add_items("inference/gcn", items=n_gcn)
    finally:
        stop.set()
        producer_thread.join()
        gcn_bar.close()
    if producer_exc:
        raise producer_exc[0]

    # matrix row order: by length, as the reference sorts (pipeline.py:528)
    gcn_items = [(aln.query_name, aln.query_sequence)
                 for aln, _ in sorted(aligned_cmaps,
                                      key=lambda x: len(x[0].query_sequence))]

    if save_cmaps:
        # Dense maps are only materialised on host when explicitly requested
        # (reference pipeline saves .npy cmaps); the inference path never
        # builds them.
        cmap_dir = output_path / "contact_maps"
        cmap_dir.mkdir(parents=True, exist_ok=True)
        for aln, _ in aligned_cmaps:
            _, cmap = build_align_contact_map(
                aln, threshold=angstrom_contact_threshold,
                generated_contacts=generate_contacts)
            if cmap is not None:
                np.save(cmap_dir / f"{aln.query_name}.npy", cmap)

    # a SET, not a list: membership tests below run once per query, and a
    # list scan made this O(aligned × queries) — 630M string compares
    # (~7 minutes of unattributed wall time) on a 30k-query catalogue
    aligned_queries = {a[0].query_name for a in aligned_cmaps}
    unaligned_queries = {
        qid: seq for qid, seq in query_file.sequences.items()
        if qid not in aligned_queries
    }

    # ---- alignment summary ---------------------------------------------------
    alignment_results_file = output_path / "alignment_summary.tsv"
    with open(alignment_results_file, "w", encoding="utf-8",
              newline="") as aln_output:
        writer = csv.writer(aln_output, delimiter="\t")
        writer.writerow(ALIGNMENT_HEADER)
        for aln, _ in aligned_cmaps:
            writer.writerow([
                aln.query_name, True, aln.target_name, aln.db_name,
                aln.query_identity, aln.query_coverage, aln.target_coverage,
            ])
        for qid in unaligned_queries:
            writer.writerow([qid, False, np.nan, np.nan, np.nan, np.nan,
                             np.nan])

    # ---- CNN fallback for queries with no structure hit ----------------------
    unaligned_queries = dict(
        sorted(unaligned_queries.items(), key=lambda x: len(x[1])))
    cnn_items = list(unaligned_queries.items())
    pending_cnn = [it for it in cnn_items if it[0] not in done_cnn]
    bar = ProgressLog("Predicting (CNN)",
                      total=len(pending_cnn) * len(deepfri_processing_modes))
    with profiling.stage("inference/cnn", items=len(pending_cnn)):
        cnn_scores = predictor.predict_cnn(
            pending_cnn, modes=list(cnn_handles),
            progress_cb=lambda n: bar.update(
                n * len(deepfri_processing_modes)),
            result_cb=lambda part: ckpt.add("cnn", part),
            overflow_cb=_overflow_collector("cnn"))
    bar.close()
    gcn_scores = {m: {} for m in gcn_handles}
    ckpt.merge_into("gcn", gcn_scores)
    ckpt.merge_into("cnn", cnn_scores)

    # Dense re-run of top-k overflows: proteins with > score_topk terms at
    # or above the threshold get exact threshold-complete rows (their
    # checkpoint parts are re-written, so a crash-resume also sees the
    # corrected scores — later parts win on reload). Pending marks from a
    # previous crashed run (persisted in overflow.log before the crash) are
    # folded in, so resumed runs re-compute those qids densely too.
    for net in ("gcn", "cnn"):
        for mode, qids in ckpt.overflow(net).items():
            overflow[net].setdefault(mode, set()).update(qids)
    if any(overflow["gcn"].values()) or any(overflow["cnn"].values()):
        n_over = sum(len(q) for d in overflow.values() for q in d.values())
        logger.info("Re-running %d protein/mode pair(s) with dense score "
                    "fetch (top-%d was threshold-incomplete for them).",
                    n_over, score_topk)
        dense_predictor = BatchedPredictor(
            gcn_models=gcn_handles, cnn_models=cnn_handles,
            contact_threshold=angstrom_contact_threshold,
            generated_contacts=generate_contacts, mesh=mesh)
        coords_by_qid = {aln.query_name: (aln.query_sequence, proj, ins)
                         for aln, (proj, ins) in aligned_cmaps}
        for mode, qids in overflow["gcn"].items():
            over_items = [(q,) + coords_by_qid[q] for q in sorted(qids)
                          if q in coords_by_qid]
            if over_items:
                fixed = dense_predictor.predict_gcn_from_coords(
                    over_items, modes=[mode])
                gcn_scores[mode].update(fixed[mode])
                ckpt.add("gcn", fixed)
                ckpt.resolve_overflow("gcn", mode, sorted(fixed[mode]))
        cnn_seq = dict(cnn_items)
        for mode, qids in overflow["cnn"].items():
            over_items = [(q, cnn_seq[q]) for q in sorted(qids)
                          if q in cnn_seq]
            if over_items:
                fixed = dense_predictor.predict_cnn(over_items, modes=[mode])
                cnn_scores[mode].update(fixed[mode])
                ckpt.add("cnn", fixed)
                ckpt.resolve_overflow("cnn", mode, sorted(fixed[mode]))
    if warmup_future is not None and warmup_future.done() \
            and warmup_future.exception():
        logger.warning("Engine warmup failed (inference itself succeeded): "
                       "%s", warmup_future.exception())

    # ---- prediction matrices (reference pipeline.py:540-655) -----------------
    matrix_jobs_by_mode: Dict[str, List[Dict[str, Any]]] = {}
    for i, mode in enumerate(deepfri_processing_modes):
        gcn_handle = gcn_handles.get(mode)
        cnn_handle = cnn_handles.get(mode)
        goterms_gcn = gcn_handle.goterms if gcn_handle else []
        goterms_cnn = cnn_handle.goterms if cnn_handle else []
        split_matrices = (len(goterms_gcn) != len(goterms_cnn)
                          or goterms_gcn != goterms_cnn)
        logger.info("Processing mode: %s; %d/%d", DEEPFRI_MODES[mode], i + 1,
                    len(deepfri_processing_modes))
        if split_matrices:
            logger.info(
                "GCN and CNN use different output vocabularies for mode %s "
                "(%d vs %d labels). Writing separate "
                "prediction_matrix_%s_*.tsv files.", mode, len(goterms_gcn),
                len(goterms_cnn), mode)
        matrix_jobs_by_mode[mode] = []

        def write_matrix(filename, goterms, jobs):
            """Persist one prediction matrix TSV (skipped entirely under
            ``--skip-matrix``; unlike the reference, results.tsv is built
            from the in-memory scores either way, so the matrices are pure
            outputs, never re-parsed)."""
            if skip_matrix:
                return
            with profiling.stage("write/matrices"), \
                    open(output_path / filename, "w", encoding="utf-8",
                         newline="") as fh:
                fh.write("\t".join(["protein", "network_type"]
                                   + list(goterms)) + "\n")
                for qid, net, scores in jobs:
                    # bulk C-level float formatting: a 10k-protein BP
                    # matrix is 40M cells — per-cell float()/str() was the
                    # slowest stage of large runs. %.9g round-trips
                    # float32 exactly.
                    row = np.char.mod(
                        "%.9g", np.asarray(scores, dtype=np.float64))
                    fh.write(qid + "\t" + net + "\t"
                             + "\t".join(row.tolist()) + "\n")

        gcn_rows = [(qid, "gcn", gcn_scores[mode][qid])
                    for qid, *_ in gcn_items] if gcn_handle else []
        cnn_rows = [(qid, "cnn", cnn_scores[mode][qid])
                    for qid, _ in cnn_items] if cnn_handle else []

        if split_matrices:
            if gcn_rows:
                write_matrix(f"prediction_matrix_{mode}_gcn.tsv",
                             goterms_gcn, gcn_rows)
                matrix_jobs_by_mode[mode].append(
                    {"goterms": goterms_gcn,
                     "gonames": gcn_handle.gonames, "rows": gcn_rows})
            if cnn_rows:
                write_matrix(f"prediction_matrix_{mode}_cnn.tsv",
                             goterms_cnn, cnn_rows)
                matrix_jobs_by_mode[mode].append(
                    {"goterms": goterms_cnn,
                     "gonames": cnn_handle.gonames, "rows": cnn_rows})
        else:
            write_matrix(f"prediction_matrix_{mode}.tsv", goterms_gcn,
                         gcn_rows + cnn_rows)
            handle = gcn_handle or cnn_handle
            matrix_jobs_by_mode[mode].append(
                {"goterms": goterms_gcn or goterms_cnn,
                 "gonames": handle.gonames, "rows": gcn_rows + cnn_rows})

    # ---- final results.tsv (reference pipeline.py:657-748) --------------------
    # Same output schema and ordering as the reference, but built from the
    # in-memory score arrays instead of re-parsing the matrix TSVs (the
    # reference re-reads what it just wrote): thresholding is one
    # vectorised compare per protein, and only the surviving entries (a
    # few per protein for calibrated models) are ever formatted.
    with open(alignment_results_file, "r", encoding="utf-8") as aln_input:
        reader = csv.reader(aln_input, delimiter="\t")
        next(reader)
        alignment_data = {row[0]: row[1:] for row in reader}

    final_output = output_path / "results.tsv"
    with profiling.stage("write/results"), \
            open(final_output, "w", encoding="utf-8") as fout:
        fout.write("\t".join(FINAL_OUTPUT_HEADER) + "\n")
        for mode, jobs in matrix_jobs_by_mode.items():
            for job in jobs:
                terms = job["goterms"]
                gonames = job["gonames"]
                for qid, net, scores in job["rows"]:
                    scores = np.asarray(scores, dtype=np.float64)
                    if scores.shape[0] != len(terms):
                        raise ValueError(
                            f"Row length mismatch for mode {mode}: "
                            f"{scores.shape[0]} scores vs "
                            f"{len(terms)} terms.")
                    keep = np.nonzero(scores >= SCORE_THRESHOLD)[0]
                    # descending by score; stable → term order on ties,
                    # matching the reference's stable value sort
                    keep = keep[np.argsort(-scores[keep], kind="stable")]
                    if keep.size == 0:
                        continue
                    aln_info = alignment_data.get(qid, [np.nan] * 6)
                    (aligned, target_id, database, target_identity,
                     query_cov, target_cov) = aln_info
                    suffix = (f"\t{aligned}\t{target_id}\t{database}"
                              f"\t{target_identity}\t{query_cov}"
                              f"\t{target_cov}\n")
                    prefix = f"{qid}\t{net}\t{DEEPFRI_MODES[mode]}\t"
                    for k in keep:
                        go_name = gonames[k] if k < len(gonames) \
                            else "Unknown"
                        fout.write(prefix + terms[k]
                                   + f"\t{scores[k]:.4f}\t" + go_name
                                   + suffix)

    if propagate_go_terms:
        from metagenomic_deepfri_tpu.ontology.go import (download_obo,
                                                         propagate_results)

        obo_file = (pathlib.Path(obo_path) if obo_path
                    else output_path / "go-basic.obo")
        download_obo(obo_file)
        propagate_results(results_path=final_output,
                          output_path=output_path / "results_propagated.tsv",
                          obo_path=obo_file)

    if remove_intermediate:
        for db in databases:
            remove_intermediate_files([db.sequence_db, db.mmseqs_db])

    # results.tsv is written — the streaming checkpoint has served its purpose
    ckpt.remove()
    profiling.log_report()
    logger.info("metagenomic-deepfri-tpu finished successfully.")
