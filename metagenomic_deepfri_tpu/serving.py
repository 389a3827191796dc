"""Resident annotation server — the production serving path.

The reference is strictly batch-oriented: every run pays model loading,
database indexing, and (on GPU) session setup before the first prediction
(reference ``mDeepFRI/cli.py:338-497``). This server loads everything once —
models resident on device, search databases indexed, target sequences in
memory, coordinates LRU-cached — and then annotates request batches with the
same hierarchical-search → alignment → contact-map → GCN/CNN semantics as the
batch pipeline (:mod:`.pipeline`), over an in-memory path with no files
between stages.

Transport: newline-delimited JSON over a Unix domain socket (one JSON object
per line; concurrent connections served by a thread pool; device work is
serialised through the engine, which batches per request). Request::

    {"proteins": {"q1": "MKV...", ...}}

Response::

    {"results": {"q1": {"aligned": true, "target": "af0", "db": "structs",
                        "identity": 0.97, "scores": {"mf": [["GO:...",
                        0.92, "name"], ...]}}},
     "skipped": {"q2": "selenocysteine"}}

Scores are filtered at ≥ 0.1 and sorted descending, matching the pipeline's
``results.tsv`` contract (reference ``pipeline.py:701,735``).
"""

from __future__ import annotations

import json
import logging
import socket
import socketserver
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from metagenomic_deepfri_tpu.align.pairwise import pairwise_against_database
from metagenomic_deepfri_tpu.batching.engine import BatchedPredictor
from metagenomic_deepfri_tpu.bio_utils import build_align_projection
from metagenomic_deepfri_tpu.data.fasta import load_fasta_as_dict
from metagenomic_deepfri_tpu.models.registry import load_models
from metagenomic_deepfri_tpu.search.database import Database, build_database
from metagenomic_deepfri_tpu.search.engine import builtin_search
from metagenomic_deepfri_tpu.search.pdb import extract_calpha_coords

logger = logging.getLogger(__name__)

SCORE_THRESHOLD = 0.1  # reference pipeline.py:701,735


class _CoordCache:
    """Tiny LRU for per-target CA coordinates (repeat hits are common when
    serving a catalogue against a fixed database)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._data: "OrderedDict[tuple, Optional[np.ndarray]]" = OrderedDict()
        self._lock = threading.Lock()

    def get_many(self, db: Database, pairs: List[Tuple[str, str]]
                 ) -> Dict[str, Optional[np.ndarray]]:
        """{target_id: coords} for (target_id, query_id) pairs."""
        out: Dict[str, Optional[np.ndarray]] = {}
        missing: List[Tuple[str, str]] = []
        with self._lock:
            for tid, qid in pairs:
                key = (db.name, tid)
                if key in self._data:
                    self._data.move_to_end(key)
                    out[tid] = self._data[key]
                else:
                    missing.append((tid, qid))
        if missing:
            coords = extract_calpha_coords(
                db, [t for t, _ in missing], [q for _, q in missing])
            with self._lock:
                for (tid, _), coord in zip(missing, coords):
                    out[tid] = coord
                    self._data[(db.name, tid)] = coord
                    while len(self._data) > self.capacity:
                        self._data.popitem(last=False)
        return out


class AnnotationServer:
    """Models + databases resident; annotates protein dicts in memory.

    Args:
        weights: model-weights directory (``model_config.json`` layout).
        databases: structure databases (FoldComp file, FASTA, or a directory
            of .pdb/.cif files), searched in order with the pipeline's
            hierarchical semantics (first DB hit wins a query).
        processing_modes: subset of bp/cc/mf/ec (default: all in config).
        db_workdir: where DB indices are built/cached (default: next to each
            database, like the pipeline).
    """

    def __init__(self,
                 weights,
                 databases: Iterable = (),
                 processing_modes: Optional[List[str]] = None,
                 db_workdir=None,
                 max_eval: float = 1e-5,
                 min_ident: float = 0.5,
                 min_coverage: float = 0.9,
                 top_k: int = 5,
                 contact_threshold: float = 6.0,
                 generated_contacts: int = 2,
                 gap_open: int = 10,
                 gap_extend: int = 1,
                 scoring_matrix: str = "auto",
                 coord_cache: int = 4096,
                 threads: int = 1,
                 score_topk: Optional[int] = None,
                 mesh=None,
                 obo_path=None):
        from metagenomic_deepfri_tpu.pipeline import \
            _initialize_processing_modes
        from metagenomic_deepfri_tpu.utils import load_deepfri_config

        config = load_deepfri_config(weights)
        modes = processing_modes or [m for m in ("bp", "cc", "mf", "ec")
                                     if config.get("gcn", {}).get(m)]
        self.modes = _initialize_processing_modes(list(modes), config)
        gcn, cnn, _ = load_models(weights, self.modes)
        # score_topk: responses only carry scores ≥ SCORE_THRESHOLD, so the
        # top-k compact fetch is response-identical; the rare overflow
        # proteins (> k above-threshold terms) re-run through a lazily
        # created dense-fetch engine below.
        self.engine = BatchedPredictor(
            gcn_models=gcn, cnn_models=cnn,
            contact_threshold=contact_threshold,
            generated_contacts=generated_contacts,
            score_topk=score_topk,
            score_threshold=SCORE_THRESHOLD,
            mesh=mesh)
        self._dense_engine: Optional[BatchedPredictor] = None
        self._engine_kwargs = dict(
            gcn_models=gcn, cnn_models=cnn,
            contact_threshold=contact_threshold,
            generated_contacts=generated_contacts, mesh=mesh)
        self.max_eval = max_eval
        self.min_ident = min_ident
        self.min_coverage = min_coverage
        self.top_k = top_k
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self.scoring_matrix = scoring_matrix
        self.threads = threads
        self._coords = _CoordCache(coord_cache)
        # Optional GO-DAG for per-response true-path propagation (the batch
        # pipeline's results_propagated.tsv analogue): responses gain a
        # "propagated_scores" entry per protein when an OBO file is given.
        self._godag = None
        self._go_anc_cache: Dict[str, frozenset] = {}
        if obo_path is not None:
            from metagenomic_deepfri_tpu.ontology.go import GoDag
            self._godag = GoDag.from_obo(obo_path)
            logger.info("GO propagation enabled (%d terms).",
                        len(self._godag.names))

        self.databases: List[Database] = []
        self._targets: Dict[str, Dict[str, str]] = {}
        for db_path in databases:
            db_path = Path(db_path)
            workdir = Path(db_workdir) if db_workdir else db_path.parent
            db = build_database(db_path, workdir, threads=threads)
            self.databases.append(db)
            self._targets[db.name] = {
                k.split("|")[1] if "|" in k else k: v.upper()
                for k, v in load_fasta_as_dict(db.sequence_db).items()}
            logger.info("Serving database %s: %d targets.",
                        db.name, len(self._targets[db.name]))
        import queue as _queue

        self._req_q: "_queue.Queue" = _queue.Queue()
        self._batcher = None
        self._batcher_lock = threading.Lock()
        # Warm the REQUEST-SIZED programs in the background: server traffic
        # is latency-sized (1..~100 proteins per request). Only the
        # (bucket 512, batch 128) shapes are compiled; the engine routes
        # ANY smaller request up to them (``_ready_bucket_at_least`` in
        # ``_run``'s collapse — a request of all-short proteins pays
        # milliseconds of padding, not a fresh compile), so two small
        # programs cover every request ≤ 128 proteins ≤ 512 residues. A
        # huge request still compiles its steady shape once, on demand.
        self._warmup_future = self.engine.warmup(expected={512: 128})

        def _log_warmup_failure(fut):
            exc = fut.exception()
            if exc is not None:
                logger.warning("Background engine warmup failed "
                               "(first requests will compile inline): %s", exc)

        self._warmup_future.add_done_callback(_log_warmup_failure)
        logger.info("Annotation server ready: modes=%s, databases=%d "
                    "(engine warming in background).",
                    self.modes, len(self.databases))

    # -- core ---------------------------------------------------------------

    def annotate(self, proteins: Dict[str, str]) -> dict:
        """Annotate {query_id: sequence}; returns the response dict."""
        skipped: Dict[str, str] = {}
        queries: Dict[str, str] = {}
        for qid, seq in proteins.items():
            seq = str(seq).upper()
            if "U" in seq:
                # reference drops selenocysteine sequences
                # (mmseqs.py:645); report instead of silently vanishing
                skipped[qid] = "selenocysteine"
            elif not seq:
                skipped[qid] = "empty"
            else:
                queries[qid] = seq

        gcn_items = []           # (qid, seq, proj_coords, ins_mask)
        meta: Dict[str, dict] = {}
        remaining = dict(queries)
        for db in self.databases:
            if not remaining:
                break
            targets = self._targets[db.name]
            results = builtin_search(
                remaining, targets, max_eval=self.max_eval,
                threads=self.threads)
            filtered = results.apply_filters(min_cov=self.min_coverage,
                                             min_ident=self.min_ident)
            best = filtered.find_best_matches(self.top_k,
                                              threads=self.threads)
            if len(best) == 0:
                continue
            hits = {q: best.get_query_targets(q)
                    for q in best.get_queries()}
            # alignment + coordinate projection for this DB's hits
            coord_map = self._coords.get_many(
                db, [(t, q) for q, ts in hits.items() for t in ts[:1]])
            for qid, tids in hits.items():
                partial = {t: targets[t] for t in tids}
                aln = pairwise_against_database(
                    qid, remaining[qid], partial,
                    gap_open=self.gap_open, gap_extend=self.gap_extend,
                    scoring_matrix=self.scoring_matrix)
                tid = aln.target_name
                if tid in coord_map:
                    aln.coords = coord_map[tid]
                else:
                    aln.coords = self._coords.get_many(db, [(tid, qid)])[tid]
                aln, proj = build_align_projection(aln)
                if proj is None:
                    continue  # rescue via next DB or CNN fallback
                gcn_items.append((qid, aln.query_sequence, proj[0], proj[1]))
                meta[qid] = {
                    "aligned": True, "target": tid, "db": db.name,
                    "identity": round(float(aln.query_identity), 4),
                    "query_coverage": round(float(aln.query_coverage), 4),
                    "target_coverage": round(float(aln.target_coverage), 4),
                }
                remaining.pop(qid, None)

        cnn_items = [(qid, seq) for qid, seq in remaining.items()]

        overflow: Dict[str, Dict[str, set]] = {"gcn": {}, "cnn": {}}

        def _overflow(net):
            def cb(mode, qids):
                overflow[net].setdefault(mode, set()).update(qids)
            return cb

        gcn_scores = (self.engine.predict_gcn_from_coords(
            gcn_items, modes=self.modes, overflow_cb=_overflow("gcn"))
            if gcn_items else {})
        cnn_scores = (self.engine.predict_cnn(
            cnn_items, modes=self.modes, overflow_cb=_overflow("cnn"))
            if cnn_items else {})

        # Dense re-run of top-k overflows (see __init__): guarantees the
        # response carries every above-threshold term.
        if any(overflow["gcn"].values()) or any(overflow["cnn"].values()):
            if self._dense_engine is None:
                self._dense_engine = BatchedPredictor(**self._engine_kwargs)
            gcn_by_qid = {it[0]: it for it in gcn_items}
            for mode, qids in overflow["gcn"].items():
                fix_items = [gcn_by_qid[q] for q in sorted(qids)
                             if q in gcn_by_qid]
                if fix_items:
                    fixed = self._dense_engine.predict_gcn_from_coords(
                        fix_items, modes=[mode])
                    gcn_scores[mode].update(fixed[mode])
            cnn_by_qid = dict(cnn_items)
            for mode, qids in overflow["cnn"].items():
                fix_items = [(q, cnn_by_qid[q]) for q in sorted(qids)
                             if q in cnn_by_qid]
                if fix_items:
                    fixed = self._dense_engine.predict_cnn(
                        fix_items, modes=[mode])
                    cnn_scores[mode].update(fixed[mode])

        results: Dict[str, dict] = {}
        for qid in queries:
            aligned = qid in meta
            entry = dict(meta.get(qid, {"aligned": False}))
            entry["network"] = "gcn" if aligned else "cnn"
            scores_by_mode = {}
            source = gcn_scores if aligned else cnn_scores
            handles = (self.engine.gcn_models if aligned
                       else self.engine.cnn_models)
            for mode in self.modes:
                handle = handles.get(mode)
                if handle is None or qid not in source.get(mode, {}):
                    continue
                vec = np.asarray(source[mode][qid])
                goterms = handle.goterms or [str(i) for i in range(len(vec))]
                gonames = handle.gonames or [""] * len(vec)
                keep = [(goterms[i], float(vec[i]), gonames[i])
                        for i in np.argsort(vec)[::-1]
                        if vec[i] >= SCORE_THRESHOLD]
                scores_by_mode[mode] = [(t, round(s, 4), n)
                                        for t, s, n in keep]
            entry["scores"] = scores_by_mode
            if self._godag is not None:
                entry["propagated_scores"] = {
                    mode: self._propagate_mode(rows)
                    for mode, rows in scores_by_mode.items()}
            results[qid] = entry
        return {"results": results, "skipped": skipped}

    def _propagate_mode(self, rows) -> list:
        """Ancestor terms (true-path rule) NOT already in ``rows``.

        Same semantics as the batch pipeline's ``results_propagated.tsv``
        (ontology.go.propagate_results): each GO term's is_a/part_of
        ancestors inherit the maximum descendant score, roots excluded,
        EC numbers pass through unpropagated; returned sorted by score
        descending then term.
        """
        dag = self._godag
        present = {t for t, _, _ in rows}
        inherited: Dict[str, float] = {}
        for term, score, _ in rows:
            if not term.startswith("GO:"):
                continue
            anc = self._go_anc_cache.get(term)
            if anc is None:
                anc = self._go_anc_cache[term] = dag.ancestors(term)
            for a in anc:
                if a not in present and inherited.get(a, -1.0) < score:
                    inherited[a] = score
        return [(t, round(s, 4), dag.name(t))
                for t, s in sorted(inherited.items(),
                                   key=lambda kv: (-kv[1], kv[0]))]

    # -- request micro-batching ---------------------------------------------

    def submit(self, proteins: Dict[str, str], timeout: float = 600.0
               ) -> dict:
        """Annotate via the micro-batching queue (concurrent-safe).

        Concurrent requests landing within ``batch_window_s`` coalesce into
        ONE pass through search/alignment/inference — the engine sees
        fuller batches and per-request overhead amortises. Each request's
        ids are namespaced internally, so collisions across requests are
        fine. Single-threaded callers lose nothing: an idle queue drains
        immediately.
        """
        import concurrent.futures as _cf

        self._ensure_batcher()
        fut: "_cf.Future" = _cf.Future()
        self._req_q.put((proteins, fut))
        return fut.result(timeout=timeout)

    batch_window_s = 0.02
    max_batch_proteins = 2048

    def _ensure_batcher(self) -> None:
        with self._batcher_lock:
            if self._batcher is None:
                self._batcher = threading.Thread(target=self._batch_loop,
                                                 daemon=True,
                                                 name="annotation-batcher")
                self._batcher.start()

    def _batch_loop(self) -> None:
        import queue as _queue

        while True:
            try:
                self._drain_once()
            except _queue.Empty:
                continue

    def _drain_once(self, first_timeout: Optional[float] = 1.0) -> int:
        """Collect one micro-batch from the queue and process it.

        Returns the number of coalesced requests (0 on timeout). Split out
        from the loop for deterministic testing.
        """
        import queue as _queue
        import time as _time

        try:
            pending = [self._req_q.get(timeout=first_timeout)]
        except _queue.Empty:
            return 0
        deadline = _time.monotonic() + self.batch_window_s
        total = len(pending[0][0])
        while total < self.max_batch_proteins:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self._req_q.get(timeout=remaining)
            except _queue.Empty:
                break
            pending.append(req)
            total += len(req[0])

        merged: Dict[str, str] = {}
        for ridx, (proteins, _) in enumerate(pending):
            for qid, seq in proteins.items():
                merged[f"r{ridx}\x1f{qid}"] = seq
        try:
            combined = self.annotate(merged)
        except Exception as e:  # noqa: BLE001 — fan the error out
            for _, fut in pending:
                if not fut.done():
                    fut.set_exception(e)
            return len(pending)
        for ridx, (proteins, fut) in enumerate(pending):
            prefix = f"r{ridx}\x1f"
            res = {"results": {}, "skipped": {}}
            for key, value in combined["results"].items():
                if key.startswith(prefix):
                    res["results"][key[len(prefix):]] = value
            for key, value in combined["skipped"].items():
                if key.startswith(prefix):
                    res["skipped"][key[len(prefix):]] = value
            if not fut.done():
                fut.set_result(res)
        return len(pending)

    # -- transport ----------------------------------------------------------

    def serve_unix(self, socket_path, ready_event=None) -> None:
        """Blocking accept loop on a Unix socket (JSONL protocol)."""
        server = _UnixJsonlServer(str(socket_path), self)
        self._server = server
        if ready_event is not None:
            ready_event.set()
        logger.info("Listening on %s", socket_path)
        try:
            server.serve_forever()
        finally:
            server.server_close()

    def shutdown(self) -> None:
        server = getattr(self, "_server", None)
        if server is not None:
            server.shutdown()


class _UnixJsonlServer(socketserver.ThreadingMixIn,
                       socketserver.UnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, path, annotator: AnnotationServer):
        self.annotator = annotator
        Path(path).unlink(missing_ok=True)
        super().__init__(path, _JsonlHandler)


class _JsonlHandler(socketserver.StreamRequestHandler):
    def handle(self):
        for line in self.rfile:
            line = line.strip()
            if not line:
                continue
            try:
                request = json.loads(line)
                # submit() coalesces concurrent connections' requests into
                # shared engine batches
                response = self.server.annotator.submit(
                    request.get("proteins", {}))
            except Exception as e:  # noqa: BLE001 — protocol boundary
                logger.exception("Request failed")
                response = {"error": f"{type(e).__name__}: {e}"}
            payload = (json.dumps(response) + "\n").encode("utf-8")
            self.wfile.write(payload)
            self.wfile.flush()


def annotate_over_socket(socket_path, proteins: Dict[str, str],
                         timeout: float = 600.0) -> dict:
    """Client helper: one request/response over the Unix socket."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
        sock.settimeout(timeout)
        sock.connect(str(socket_path))
        sock.sendall((json.dumps({"proteins": proteins}) + "\n")
                     .encode("utf-8"))
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = sock.recv(1 << 20)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode("utf-8"))
