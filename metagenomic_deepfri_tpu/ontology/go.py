"""GO-term propagation (true-path rule) with a built-in OBO parser.

Behaviour parity with reference ``mDeepFRI/go_propagation.py``: ancestors via
``is_a``/``part_of`` edges only (:68-94), root terms excluded (:29),
propagated ancestors inherit the maximum descendant score (:97-241), EC
numbers pass through untouched (:186-190), output is ``results.tsv`` plus a
``propagated`` column sorted by (protein, original-first, score desc, term)
(:243-260). obonet/networkx are replaced by a small OBO stanza parser and an
iterative DFS with memoisation.
"""

from __future__ import annotations

import csv
import logging
import urllib.request
from collections import defaultdict
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

logger = logging.getLogger(__name__)

GO_OBO_URL = "http://purl.obolibrary.org/obo/go/go-basic.obo"

# Root GO term IDs: BP, MF, CC (reference go_propagation.py:29)
ROOT_IDS = frozenset({"GO:0008150", "GO:0003674", "GO:0005575"})


def download_obo(obo_path: Path) -> Path:
    """Fetch go-basic.obo unless already present (reference :32-55)."""
    obo_path = Path(obo_path)
    if obo_path.exists():
        logger.info("OBO file already exists: %s", obo_path)
        return obo_path
    obo_path.parent.mkdir(parents=True, exist_ok=True)
    logger.info("Downloading go-basic.obo from %s", GO_OBO_URL)
    req = urllib.request.Request(GO_OBO_URL,
                                 headers={"User-Agent": "mdeepfri"})
    with urllib.request.urlopen(req) as response, open(obo_path, "wb") as out:
        out.write(response.read())
    return obo_path


class GoDag:
    """Parsed GO DAG: child → parents edges typed by relation."""

    def __init__(self):
        self.names: Dict[str, str] = {}
        self.obsolete: Set[str] = set()
        # term -> list of (relation, parent)
        self.parents: Dict[str, List[Tuple[str, str]]] = defaultdict(list)
        self.alt_ids: Dict[str, str] = {}

    @classmethod
    def from_obo(cls, obo_path) -> "GoDag":
        dag = cls()
        term_id: Optional[str] = None
        in_term = False
        with open(obo_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line.startswith("["):
                    in_term = line == "[Term]"
                    term_id = None
                    continue
                if not in_term or not line:
                    continue
                if line.startswith("id:"):
                    term_id = line[3:].strip()
                elif term_id is None:
                    continue
                elif line.startswith("name:"):
                    dag.names[term_id] = line[5:].strip()
                elif line.startswith("alt_id:"):
                    dag.alt_ids[line[7:].strip()] = term_id
                elif line.startswith("is_obsolete: true"):
                    dag.obsolete.add(term_id)
                elif line.startswith("is_a:"):
                    parent = line[5:].strip().split("!")[0].strip()
                    dag.parents[term_id].append(("is_a", parent))
                elif line.startswith("relationship:"):
                    parts = line[13:].strip().split()
                    if len(parts) >= 2:
                        dag.parents[term_id].append((parts[0], parts[1]))
        return dag

    def __contains__(self, term: str) -> bool:
        return term in self.names or term in self.parents

    def name(self, term: str) -> str:
        return self.names.get(term, "")

    def ancestors(self, term: str,
                  relations: Tuple[str, ...] = ("is_a", "part_of"),
                  exclude_roots: bool = True,
                  _cache: Optional[dict] = None) -> frozenset:
        """All ancestors reachable via the given relations (reference
        :68-94 + the obsolete/root handling of :134-142)."""
        if term in self.obsolete:
            return frozenset()
        rel = set(relations)
        visited: Set[str] = set()
        stack = [term]
        while stack:
            node = stack.pop()
            if node in visited:
                continue
            visited.add(node)
            for rtype, parent in self.parents.get(node, ()):
                if rtype in rel and parent not in visited:
                    stack.append(parent)
        visited.discard(term)
        if exclude_roots:
            visited -= ROOT_IDS
        return frozenset(visited)


@dataclass
class _ResultRow:
    """One ``results.tsv`` record with named columns.

    Column order mirrors ``pipeline.FINAL_OUTPUT_HEADER`` (protein,
    network_type, prediction_mode, go_term, score, go_name + six alignment
    columns); short/malformed input rows are padded to the full schema.
    ``score`` is the parsed value used for grouping, inheritance and
    sorting; ``raw_score`` preserves unparsable score text verbatim on
    output (parsable scores are re-rendered to 4 decimals).
    """

    protein: str
    network_type: str
    mode: str
    term: str
    score: float
    raw_score: str
    go_name: str
    alignment: Tuple[str, ...]
    propagated: bool = False

    N_COLS = 12  # len(FINAL_OUTPUT_HEADER)

    @classmethod
    def from_tsv(cls, row: list) -> "_ResultRow":
        row = list(row) + [""] * max(0, cls.N_COLS - len(row))
        try:
            score = float(row[4])
        except ValueError:
            score = 0.0
        return cls(protein=row[0], network_type=row[1], mode=row[2],
                   term=row[3], score=score, raw_score=row[4],
                   go_name=row[5], alignment=tuple(row[6:cls.N_COLS]))

    def to_tsv(self) -> list:
        try:
            score_text = f"{float(self.raw_score):.4f}"
        except ValueError:
            score_text = self.raw_score
        return [self.protein, self.network_type, self.mode, self.term,
                score_text, self.go_name, *self.alignment,
                "True" if self.propagated else "False"]

    def sort_key(self):
        # protein → originals before propagated → score desc → term
        return (self.protein, self.propagated, -self.score, self.term)


def propagate_results(results_path,
                      output_path,
                      obo_path,
                      relations: Tuple[str, ...] = ("is_a", "part_of"),
                      exclude_roots: bool = True) -> Path:
    """Expand ``results.tsv`` with propagated ancestor terms.

    Behaviour parity with reference ``go_propagation.py:97-269``: per
    (protein, prediction-mode) group, every GO term's ancestors join the
    output with the maximum descendant score (true-path rule) and
    ``propagated=True``; original rows pass through unchanged (scores
    re-rendered to 4 decimals); EC numbers are never propagated.
    """
    dag = GoDag.from_obo(obo_path)
    anc_cache: Dict[str, frozenset] = {}

    def ancestors(term: str) -> frozenset:
        if term not in anc_cache:
            anc_cache[term] = dag.ancestors(term, relations, exclude_roots)
        return anc_cache[term]

    with open(results_path, "r", encoding="utf-8") as f:
        reader = csv.reader(f, delimiter="\t")
        header = next(reader)
        records = [_ResultRow.from_tsv(row) for row in reader]

    # best-scoring record per (protein, mode) and term
    groups: Dict[Tuple[str, str], Dict[str, _ResultRow]] = defaultdict(dict)
    for rec in records:
        by_term = groups[(rec.protein, rec.mode)]
        best = by_term.get(rec.term)
        if best is None or rec.score > best.score:
            by_term[rec.term] = rec

    out: List[_ResultRow] = []
    for (protein, mode), by_term in groups.items():
        out.extend(by_term.values())
        # true-path rule: each ancestor inherits its best descendant score
        inherited: Dict[str, float] = {}
        for rec in by_term.values():
            if not rec.term.startswith("GO:"):
                continue  # EC numbers pass through untouched
            for anc in ancestors(rec.term):
                if inherited.get(anc, -1.0) < rec.score:
                    inherited[anc] = rec.score
        # alignment metadata for synthesised ancestor rows comes from an
        # arbitrary row of the group (they all describe the same protein)
        template = next(iter(by_term.values()))
        for term, score in inherited.items():
            if term in by_term:
                continue  # an original row already carries this term
            out.append(replace(template, term=term, score=score,
                               raw_score=f"{score:.4f}",
                               go_name=dag.name(term), propagated=True))

    out.sort(key=_ResultRow.sort_key)

    output_path = Path(output_path)
    with open(output_path, "w", encoding="utf-8", newline="") as f:
        writer = csv.writer(f, delimiter="\t")
        writer.writerow(header + ["propagated"])
        writer.writerows(rec.to_tsv() for rec in out)

    n_prop = sum(rec.propagated for rec in out)
    logger.info(
        "GO propagation complete: %d original + %d propagated = %d total "
        "rows", len(out) - n_prop, n_prop, len(out))
    return output_path
