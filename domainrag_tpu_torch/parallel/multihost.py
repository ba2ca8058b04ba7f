"""Multi-process coordination, host half (port of
``domainrag_tpu/parallel/multihost.py``).

The port serves one card per process. Several cards run as independent
processes (``--worker_id W --num_workers N``, one per card, as the
reference's ``CUDA_VISIBLE_DEVICES=N nohup python ...`` scripts run):
each takes a disjoint round-robin sample slice
(``core.config.worker_slice``), writes its stage artifacts worker-suffixed
(retrieval partials, per-worker manifests), and worker 0 merges the
partials into the single-file contracts the next stage reads.

Coordinated processes (``torch.distributed``: barriers, a broadcast run
timestamp) are scale-out, ROADMAP A6: without a process group this module
reports one process, :func:`barrier` does nothing, and asking for a group
raises ``NotImplementedError``.
"""

from __future__ import annotations

import glob
import json
import os
import re
import time
from typing import Dict, List, Optional

from ..core.log import get_logger

logger = get_logger("domainrag_tpu_torch.multihost")


def _no_group() -> NotImplementedError:
    return NotImplementedError(
        "coordinated multi-process runs (torch.distributed) are not ported "
        "yet (ROADMAP A6, scale-out); run one process per card with "
        "--worker_id/--num_workers")


def is_distributed() -> bool:
    """False without a process group; a ``torch.distributed`` group raises
    (coordinated runs are ROADMAP A6)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        raise _no_group()
    return False


def process_index() -> int:
    is_distributed()
    return 0


def process_count() -> int:
    is_distributed()
    return 1


def barrier(name: str) -> None:
    """Fence all processes at a stage boundary: without a process group
    there is nothing to fence."""
    is_distributed()


def shared_timestamp() -> str:
    """A run timestamp (``results_*_{timestamp}`` run directories); with
    one process, the local clock's."""
    is_distributed()
    return time.strftime("%Y%m%d_%H%M%S")


# ---------------------------------------------------------------------------
# artifact merges (run on worker 0)
# ---------------------------------------------------------------------------

def merge_worker_retrieval_results(results_dir: str,
                                   out_name: str =
                                   "all_shots_retrieval_results.json"
                                   ) -> Optional[dict]:
    """Merge ``all_shots_retrieval_results.worker{W}.json`` partials into
    the canonical all-shots contract (ref :1095-1097 file).

    Workers hold disjoint sample slices, so the merge concatenates each
    (dataset, shot, category)'s entry lists; entries are de-duplicated by
    sample_id (first worker wins) and sorted for determinism."""
    partials = sorted(glob.glob(os.path.join(
        results_dir, "all_shots_retrieval_results.worker*.json")),
        key=lambda p: int(re.search(r"worker(\d+)", p).group(1)))
    if not partials:
        return None
    merged: Dict[str, dict] = {}
    for path in partials:
        with open(path, encoding="utf-8") as f:
            part = json.load(f)
        for dataset, shots in part.items():
            d = merged.setdefault(dataset, {})
            for shot_key, categories in shots.items():
                s = d.setdefault(shot_key, {})
                for category, entries in categories.items():
                    known = {e["sample_id"]
                             for e in s.setdefault(category, [])}
                    s[category].extend(e for e in entries
                                       if e["sample_id"] not in known)
    for shots in merged.values():
        for categories in shots.values():
            for entries in categories.values():
                entries.sort(key=lambda e: e["sample_id"])
    out = os.path.join(results_dir, out_name)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(merged, f, indent=2, ensure_ascii=False)
    logger.info("merged %d retrieval partials -> %s", len(partials), out)
    return merged


def merge_worker_manifests(paths: List[str], out_path: str) -> dict:
    """Union per-worker manifest files ({"process_id", "samples": {...}} —
    core.manifest layout) into one (replaces the reference's
    merge_gpu_results, ref :1750-1767). Workers hold disjoint samples, so
    conflicts only arise from reruns; later files win those."""
    merged: Dict[str, dict] = {}
    for path in paths:
        if not os.path.exists(path):
            continue
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        merged.update(data.get("samples", {}))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump({"process_id": "merged", "samples": merged}, f, indent=2)
    return merged
