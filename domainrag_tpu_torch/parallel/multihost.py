"""Multi-process coordination (port of
``domainrag_tpu/parallel/multihost.py``).

The port serves one card per process. Several cards run as independent
workers (``--worker_id W --num_workers N``, one per card, as the
reference's ``CUDA_VISIBLE_DEVICES=N nohup python ...`` scripts run, or
``--distributed`` under one ``torch.distributed`` group): each takes a
disjoint round-robin sample slice (``core.config.worker_slice``), writes
its stage artifacts worker-suffixed (retrieval partials, per-worker
manifests), and worker 0 merges the partials into the single-file
contracts the next stage reads.

Under ``--distributed`` a worker is one host: the processes that torchrun
started there (``LOCAL_WORLD_SIZE``, one per card), as JAX's multihost
worker meshes its ``jax.local_devices()``. So ``worker_id = rank //
local`` and ``num_workers = world // local`` (:func:`worker_index`,
:func:`worker_count`), and a worker's processes run its slice as one mesh
(:func:`worker_mesh`), whose first rank writes the worker's partials.

Under a group (``parallel.mesh.initialize_distributed``), the process
index and count are the group's rank and size, :func:`barrier` fences
every process and :func:`shared_timestamp` is rank 0's clock on every
rank; without one, one process: index 0 of 1, and both are local.
"""

from __future__ import annotations

import glob
import json
import os
import re
import time
from typing import Dict, List, Optional

import torch.distributed as dist

from ..core.log import get_logger

logger = get_logger("domainrag_tpu_torch.multihost")


def is_distributed() -> bool:
    """True under a ``torch.distributed`` group of more than one process."""
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def local_size() -> int:
    """Processes per worker under a group: torchrun's ``LOCAL_WORLD_SIZE``
    (1 without a group or without it). It must divide the group."""
    if not is_distributed():
        return 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if local < 1 or process_count() % local:
        raise ValueError(f"LOCAL_WORLD_SIZE={local} does not divide the "
                         f"group of {process_count()} processes")
    return local


def worker_index() -> int:
    """This process's worker (host) under ``--distributed``."""
    return process_index() // local_size()


def worker_count() -> int:
    """The workers (hosts) of the group under ``--distributed``."""
    return process_count() // local_size()


def worker_mesh(build):
    """This worker's mesh over its processes, ``build(ranks)`` of the
    worker's global ranks (e.g. ``lambda r: create_mesh(2, devices=r)``).
    Every process builds every worker's mesh, in worker order, since
    ``torch.distributed.new_group`` is collective, and keeps its own."""
    local = local_size()
    meshes = [build(list(range(w * local, (w + 1) * local)))
              for w in range(worker_count())]
    return meshes[worker_index()]


def barrier(name: str) -> None:
    """Fence all processes at a stage boundary (nothing to fence without a
    group). Replaces the reference's queue-join synchronization
    (outpainting_updown_sampling_redux.py:1666-1713)."""
    if not is_distributed():
        return
    logger.debug("barrier %s", name)
    dist.barrier()


def shared_timestamp() -> str:
    """A run timestamp identical on every process (rank 0's clock,
    broadcast): run directories like ``results_*_{timestamp}`` must agree
    across processes or each worker writes into its own tree."""
    if not is_distributed():
        return time.strftime("%Y%m%d_%H%M%S")
    t = [int(time.time())]
    dist.broadcast_object_list(t, src=0)
    return time.strftime("%Y%m%d_%H%M%S", time.localtime(int(t[0])))


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
