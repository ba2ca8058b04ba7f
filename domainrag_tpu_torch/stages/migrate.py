"""Migration reader for REFERENCE-produced retrieval artifacts (port of
``domainrag_tpu/stages/migrate.py``).

The port's stages share one canonical contract, so the normal reader
(:func:`stages.generate.top_ranked_refs`) is strict. Artifacts produced by
the reference carry key drift that its own consumers needed ~600 lines of
fuzzy matching to survive (batch_generate_flux_kshot.py:1060-1330,
1590-1818, 302-389): case-variant dataset keys ("NEU-DET"/"neu-det"/
"Neu-Det"), zero-padded vs stripped COCO image ids, hyphen/underscore
sample-name drift, sample-keyed (rather than category-keyed) shot blocks,
and stale absolute image paths. This module is the tolerant reader behind
``reference_artifacts=True``: every non-exact hit is recorded and reported
loudly, so that misses cannot hide behind the random fallback.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.log import get_logger

logger = get_logger("domainrag_tpu_torch.migrate")


@dataclass
class MigrationStats:
    """Per-run tally of how reference-artifact lookups resolved."""

    exact: int = 0
    fuzzy: int = 0
    missed: int = 0
    repaired_paths: int = 0
    notes: List[str] = field(default_factory=list)

    def record(self, sample_id: str, note: Optional[str]) -> None:
        if note is None:
            self.exact += 1
        else:
            self.fuzzy += 1
            self.notes.append(f"{sample_id}: {note}")
            logger.warning("reference-artifact fuzzy hit — %s: %s",
                           sample_id, note)

    def miss(self, sample_id: str) -> None:
        self.missed += 1
        logger.warning("reference-artifact MISS — %s not found under any "
                       "key variant", sample_id)

    def summary(self) -> str:
        return (f"reference-artifact lookups: {self.exact} exact, "
                f"{self.fuzzy} fuzzy, {self.missed} missed, "
                f"{self.repaired_paths} paths repaired")


def _dataset_variants(name: str) -> List[str]:
    """Case variants the reference generated/consumed interchangeably
    (ref :309-322)."""
    out = [name, name.upper(), name.lower(), name.capitalize()]
    seen = set()
    return [v for v in out if not (v in seen or seen.add(v))]


def _sample_variants(sample_id: str) -> List[str]:
    """Zero-padding and separator drift (ref :1624-1631, :1175-1182)."""
    out = [sample_id,
           sample_id.zfill(12),            # COCO 12-digit padding
           sample_id.lstrip("0") or "0",   # stripped COCO id
           sample_id.replace("-", "_"),
           sample_id.replace("_", "-"),
           sample_id.lower(), sample_id.upper()]
    seen = set()
    return [v for v in out if not (v in seen or seen.add(v))]


def _canon(s: str) -> str:
    """Normalize case + separators (the reference's drift is exactly these
    two dimensions, plus zero-padding handled by _sample_variants)."""
    return s.lower().replace("-", "_")


def _resolve_key(mapping: dict, variants: Sequence[str]
                 ) -> Tuple[Optional[str], Optional[str]]:
    """(matched_key, note). Exact first, then variants, then a
    canonical-form (case + separator insensitive) scan."""
    if not isinstance(mapping, dict):
        return None, None
    if variants[0] in mapping:
        return variants[0], None
    for v in variants[1:]:
        if v in mapping:
            return v, f"matched variant {v!r}"
    canon = {_canon(k): k for k in mapping}
    for v in variants:
        hit = canon.get(_canon(v))
        if hit is not None:
            return hit, f"canonical-form match {hit!r}"
    return None, None


def _normalize_entry(entry) -> List[dict]:
    """A sample's retrieval record in any of the reference's shapes ->
    the canonical similar-images list."""
    if isinstance(entry, list):
        # either [per-sample dicts with similar_images] or directly a
        # similar-images list
        if entry and isinstance(entry[0], dict) \
                and "similar_images" in entry[0]:
            return list(entry[0].get("similar_images") or [])
        return [e for e in entry if isinstance(e, dict)]
    if isinstance(entry, dict):
        return list(entry.get("similar_images", entry.get("results", []))
                    or [])
    return []


def _canonical_ref(item: dict, rank: int) -> dict:
    return {
        "rank": int(item.get("rank", rank)),
        "similarity": float(item.get("similarity",
                                     item.get("score", 0.0))),
        "image_path": item.get("image_path", item.get("path", "")),
        "source_dataset": item.get("source_dataset",
                                   item.get("source", "unknown")),
    }


def repair_image_path(path: str, corpus_roots: Dict[str, str],
                      stats: Optional[MigrationStats] = None) -> str:
    """Reference retrieval JSONs carry machine-specific absolute paths
    (repaired by ref :1332-1526). If ``path`` is missing, try its basename
    under each corpus root."""
    if not path or os.path.exists(path):
        return path
    base = os.path.basename(path)
    for root in corpus_roots.values():
        cand = os.path.join(root, base)
        if os.path.exists(cand):
            if stats is not None:
                stats.repaired_paths += 1
            return cand
        # one directory of structure kept (miniimagenet class dirs)
        parent = os.path.basename(os.path.dirname(path))
        cand2 = os.path.join(root, parent, base)
        if os.path.exists(cand2):
            if stats is not None:
                stats.repaired_paths += 1
            return cand2
    return path


def find_sample_refs_tolerant(
        retrieval_results: dict, dataset: str, shot: int, sample_id: str,
        top_ranks: int = 5,
        corpus_roots: Optional[Dict[str, str]] = None,
        stats: Optional[MigrationStats] = None) -> Optional[List[dict]]:
    """Reference-tolerant version of stages.generate.top_ranked_refs.

    Returns <= top_ranks canonical ref dicts, or None on a true miss
    (which the caller may feed to the seeded random fallback). All fuzzy
    resolutions are recorded in ``stats`` and logged."""
    stats = stats if stats is not None else MigrationStats()
    ds_key, ds_note = _resolve_key(retrieval_results,
                                   _dataset_variants(dataset))
    if ds_key is None:
        stats.miss(sample_id)
        return None
    block = retrieval_results[ds_key]
    shot_key, shot_note = _resolve_key(block, [f"{shot}_shot", str(shot)])
    shot_block = block[shot_key] if shot_key is not None else block

    entry = None
    note_parts = [n for n in (ds_note, shot_note) if n]
    if isinstance(shot_block, dict):
        # (a) canonical: category -> [entries with sample_id]
        want = {_canon(v) for v in _sample_variants(sample_id)}
        for cat_entries in shot_block.values():
            if isinstance(cat_entries, list):
                for e in cat_entries:
                    if isinstance(e, dict) \
                            and _canon(str(e.get("sample_id"))) in want:
                        if e.get("sample_id") != sample_id:
                            note_parts.append(
                                f"sample-id variant {e.get('sample_id')!r}")
                        entry = e
                        break
            if entry is not None:
                break
        # (b) reference alternative: sample-name -> record
        if entry is None:
            s_key, s_note = _resolve_key(shot_block,
                                         _sample_variants(sample_id))
            if s_key is not None:
                entry = shot_block[s_key]
                if s_note or s_key != sample_id:
                    note_parts.append(s_note
                                      or f"sample key variant {s_key!r}")
    if entry is None:
        stats.miss(sample_id)
        return None

    sims = _normalize_entry(entry)
    refs = []
    for i, item in enumerate(sims):
        ref = _canonical_ref(item, i + 1)
        if ref["rank"] > top_ranks or not ref["image_path"]:
            continue
        if corpus_roots:
            ref["image_path"] = repair_image_path(ref["image_path"],
                                                  corpus_roots, stats)
        refs.append(ref)
        if len(refs) >= top_ranks:
            break
    if not refs:
        stats.miss(sample_id)
        return None
    stats.record(sample_id, "; ".join(note_parts) if note_parts else None)
    return refs
