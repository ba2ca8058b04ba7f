"""Stage 2 — domain-aware two-stage retrieval (port of
``domainrag_tpu/stages/retrieve.py``).

Mirrors ``retrieval/clip100_resnet_style_all_shots.py``:

1. first stage: CLIP ViT-B/32 global features, L2-normalized, exact
   inner-product top-100 over the corpus bank (FAISS ``IndexFlatIP`` in the
   reference, ref :425-434 — here one bank resident on the card, searched
   by :func:`ops.topk.topk_ip`, or by the fused kernel B8 with
   ``use_pallas=True``);
2. second stage: re-rank those 100 by L2 distance between 128-d
   ResNet50-stem style vectors, similarity = 1/(1+d) (ref :454-497);
3. artifacts: per-sample + per-dataset-shot + ``all_shots_retrieval_results``
   JSONs with the reference's schemas (ref :866-897,1095-1097), and
   ``.npy`` + paths-JSON feature caches in its file names
   (ref :614-649,794-822).

File names and JSON schemas are the JAX stage's. With a mesh whose
``mesh_axis`` has several ranks, each rank holds its shard of the bank's
rows and the first stage is ``parallel.collectives.sharded_topk`` (B8 or
``topk_ip`` per shard, then an exact merge of the gathered candidates).
``run_retrieval(timer=)`` takes a ``core.log.StepTimer``: spans ``encode``
(the queries' CLIP features), ``search`` (the first stage), ``rerank``
(one per query) and ``write`` (its JSON and grid).
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import device as device_mod
from ..core.config import RetrievalConfig, worker_slice
from ..core.locks import atomic_save_npy, atomic_write_text, file_lock
from ..core.log import StepTimer, get_logger
from ..ops import topk as topk_ops
from .encoders import ClipImageEncoder, StyleEncoder

logger = get_logger("domainrag_tpu_torch.retrieve")


# ---------------------------------------------------------------------------
# embedding bank
# ---------------------------------------------------------------------------

@dataclass
class EmbeddingBank:
    """Multi-source corpus bank. ``features`` is one f32 tensor on the
    device (the card unless ``device="cpu"``); ``paths``/``sources`` map
    row -> image path / source dataset name."""

    features: torch.Tensor
    paths: List[str]
    sources: List[str]
    mesh: Optional[object] = None
    mesh_axis: str = "data"

    @property
    def size(self) -> int:
        return len(self.paths)

    @classmethod
    def from_sources(cls, features_by_source: Dict[str, np.ndarray],
                     paths_by_source: Dict[str, List[str]],
                     mesh=None, mesh_axis: str = "data", *,
                     device=None) -> "EmbeddingBank":
        feats, paths, sources = [], [], []
        for name, f in features_by_source.items():
            if f is None or len(f) == 0:
                continue
            feats.append(np.asarray(f, np.float32))
            paths.extend(paths_by_source[name])
            sources.extend([name] * len(paths_by_source[name]))
        if not feats:
            raise ValueError("no corpus features available")
        full = np.concatenate(feats, axis=0)
        if mesh is not None and mesh.shape.get(mesh_axis, 1) > 1:
            from ..parallel.collectives import pad_bank_for_mesh, shard_bank
            padded, _ = pad_bank_for_mesh(full, mesh, mesh_axis)
            return cls(features=shard_bank(padded, mesh, mesh_axis,
                                           device=device),
                       paths=paths, sources=sources, mesh=mesh,
                       mesh_axis=mesh_axis)
        return cls(features=torch.from_numpy(full).to(
            device_mod.resolve(device)), paths=paths, sources=sources)


def load_pretrained_features(features_path: str, paths_path: str
                             ) -> Tuple[np.ndarray, List[str]]:
    """Load a feature bank produced by the reference (migration path,
    ref :509-629): ``.npy`` arrays or torch ``.pt`` files (either a raw
    tensor or a dict with 'features'/'embeddings' + 'paths'), plus a JSON
    path list."""
    if features_path.endswith(".pt"):
        data = torch.load(features_path, map_location="cpu",
                          weights_only=False)
        paths: Optional[List[str]] = None
        if isinstance(data, dict):
            tensor = None
            for key in ("features", "embeddings", "feats"):
                if key in data:
                    tensor = data[key]
                    break
            if tensor is None:
                raise ValueError(
                    f"{features_path}: no features/embeddings key in dict")
            if "paths" in data:
                paths = list(data["paths"])
        else:
            tensor = data
        feats = np.asarray(tensor.float().numpy()
                           if hasattr(tensor, "float") else tensor,
                           np.float32)
    else:
        feats = np.load(features_path).astype(np.float32)
        paths = None
    if paths is None:
        with open(paths_path) as f:
            paths = json.load(f)
    if len(feats) != len(paths):
        raise ValueError(
            f"feature/path length mismatch: {len(feats)} vs {len(paths)}")
    return feats, paths


def bank_cache_files(results_dir: str, source: str) -> Tuple[str, str]:
    """Reference cache names: ``coco_clip_features.npy`` +
    ``coco_image_paths.json`` (ref :616-617); same pattern per source."""
    return (os.path.join(results_dir, f"{source}_clip_features.npy"),
            os.path.join(results_dir, f"{source}_image_paths.json"))


def load_or_compute_source_features(
        results_dir: str, source: str, image_paths: Sequence[str],
        encoder: ClipImageEncoder, force_recompute: bool = False
) -> Tuple[np.ndarray, List[str]]:
    """Idempotent feature cache per corpus source (ref :500-655).
    Concurrent workers serialize on a lockfile and publish atomically."""
    feat_file, paths_file = bank_cache_files(results_dir, source)

    def try_load():
        if force_recompute or not (os.path.exists(feat_file)
                                   and os.path.exists(paths_file)):
            return None
        feats = np.load(feat_file)
        with open(paths_file) as f:
            paths = json.load(f)
        if len(feats) == len(paths):
            logger.info("loaded %d cached %s features", len(feats), source)
            return feats.astype(np.float32), paths
        logger.warning("cache length mismatch for %s; recomputing", source)
        return None

    cached = try_load()
    if cached is not None:
        return cached
    with file_lock(feat_file):
        cached = try_load()   # another worker may have finished meanwhile
        if cached is not None:
            return cached
        feats, kept = encoder.encode_paths(
            image_paths,
            on_error=lambda p, e: logger.warning("skipping %s: %s", p, e))
        atomic_save_npy(feat_file, feats)
        atomic_write_text(paths_file, json.dumps(kept))
    return feats, kept


# ---------------------------------------------------------------------------
# query discovery (lamainpaint dir contract)
# ---------------------------------------------------------------------------

def get_inpainted_images(lamainpaint_dir: str, dataset: str, shot: int
                         ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """Glob ``{lamainpaint_dir}/{dataset}/{shot}_shot/*.jpg``; categories
    from sidecar ``category_mapping.json`` else sample_id (ref :89-158)."""
    shot_dir = os.path.join(lamainpaint_dir, dataset, f"{shot}_shot")
    if not os.path.isdir(shot_dir):
        logger.error("missing shot dir %s", shot_dir)
        return {}, {}
    image_files = sorted(glob.glob(os.path.join(shot_dir, "*.jpg")))
    mapping_file = os.path.join(shot_dir, "category_mapping.json")
    category_mapping: Dict[str, str] = {}
    if os.path.exists(mapping_file):
        with open(mapping_file) as f:
            category_mapping = json.load(f)
    sample_to_image, sample_to_category = {}, {}
    for path in image_files:
        sample_id = os.path.splitext(os.path.basename(path))[0]
        sample_to_image[sample_id] = path
        sample_to_category[sample_id] = category_mapping.get(sample_id,
                                                             sample_id)
    return sample_to_image, sample_to_category


# ---------------------------------------------------------------------------
# two-stage search
# ---------------------------------------------------------------------------

def first_stage_topk(query_features: np.ndarray, bank: EmbeddingBank,
                     top_k: int = 100, use_pallas: bool = False
                     ) -> List[List[dict]]:
    """Batched CLIP top-k. Returns, per query, the reference's first-stage
    result dicts: similarity / image_path / source_dataset / index
    (ref :436-447). ``use_pallas``: the fused kernel, B8
    (:func:`ops.topk.topk_ip_fused`), for a bank off the CPU (the JAX
    package gates on its backend, the port on the bank's device); else
    :func:`ops.topk.topk_ip`. Both give the same indices. A bank sharded
    over a mesh (``bank.mesh``) searches its shards and merges them
    (``parallel.collectives.sharded_topk``), in the same order."""
    k = min(top_k, bank.size)
    feats = bank.features
    queries = torch.from_numpy(
        np.array(query_features, np.float32)).to(feats.device)
    if bank.mesh is not None:
        from ..parallel.collectives import sharded_topk
        scores, idx = sharded_topk(queries, feats, k, bank.mesh,
                                   n_valid=bank.size, axis=bank.mesh_axis,
                                   use_pallas=use_pallas)
    else:
        fn = topk_ops.topk_ip_fused if (
            use_pallas and feats.device.type != "cpu") else topk_ops.topk_ip
        scores, idx = fn(queries, feats, k)
    scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
    return [
        [{"similarity": float(scores[qi, j]),
          "image_path": bank.paths[idx[qi, j]],
          "source_dataset": bank.sources[idx[qi, j]],
          "index": int(idx[qi, j])}
         for j in range(k)]
        for qi in range(len(scores))
    ]


def style_rerank(query_path: str, first_stage: List[dict],
                 style_encoder: StyleEncoder) -> List[dict]:
    """Second stage (ref :454-497): L2 distance between style vectors,
    ascending; output rank / similarity=1/(1+d) / image_path /
    source_dataset. Falls back to first-stage order when the query image
    is unreadable (ref :461-463)."""
    qfeat = style_encoder.encode_paths([query_path]).get(query_path)
    if qfeat is None:
        logger.warning("cannot compute query style features: %s", query_path)
        return first_stage
    cand_paths = [r["image_path"] for r in first_stage]
    feats = style_encoder.encode_paths(cand_paths)
    scored = []
    for r in first_stage:
        feat = feats.get(r["image_path"])
        if feat is None:
            continue
        d = float(np.linalg.norm(qfeat - feat))
        scored.append((d, r))
    scored.sort(key=lambda t: t[0])
    return [
        {"rank": i + 1,
         "similarity": float(1.0 / (1.0 + d)),
         "image_path": r["image_path"],
         "source_dataset": r.get("source_dataset", "unknown")}
        for i, (d, r) in enumerate(scored)
    ]


# ---------------------------------------------------------------------------
# per-dataset-shot orchestration
# ---------------------------------------------------------------------------

def retrieve_dataset_shot(
        dataset: str, shot: int, bank: EmbeddingBank,
        clip_encoder: ClipImageEncoder, style_encoder: StyleEncoder,
        lamainpaint_dir: str, results_dir: str,
        cfg: RetrievalConfig = RetrievalConfig(),
        force_recompute_inpainted: bool = False,
        worker_id: int = 0, num_workers: int = 1, *,
        timer: Optional[StepTimer] = None) -> Dict[str, List[dict]]:
    """Mirrors ``retrieve_by_category_multi_source`` (ref :773-898):
    returns {category: [{sample_id, image_path, category, similar_images}]}
    and writes per-sample + aggregate JSONs.

    ``worker_id``/``num_workers``: each worker retrieves a disjoint
    round-robin slice of the dataset-shot's samples and writes
    worker-suffixed aggregate/cache files."""
    timer = timer or StepTimer()
    sample_to_image, sample_to_category = get_inpainted_images(
        lamainpaint_dir, dataset, shot)
    if not sample_to_image:
        return {}
    # a bank sharded over a mesh: every rank runs this, rank 0 writes (and
    # only it reads the feature cache it may be writing)
    write = bank.mesh is None or bank.mesh.is_writer()
    if write:
        os.makedirs(results_dir, exist_ok=True)

    wtag = f".worker{worker_id}" if num_workers > 1 else ""
    # query-side feature cache (ref :794-822 file names)
    feat_file = os.path.join(
        results_dir,
        f"{dataset}_{shot}_shot_inpainted_clip_features{wtag}.npy")
    paths_file = os.path.join(
        results_dir,
        f"{dataset}_{shot}_shot_inpainted_image_paths{wtag}.json")
    sample_ids = worker_slice(sorted(sample_to_image), worker_id,
                              num_workers)
    if not sample_ids:
        return {}
    query_paths = [sample_to_image[s] for s in sample_ids]
    features = None
    if write and not force_recompute_inpainted \
            and os.path.exists(feat_file) and os.path.exists(paths_file):
        cached = np.load(feat_file)
        with open(paths_file) as f:
            cached_paths = json.load(f)
        if cached_paths == query_paths:
            features = cached.astype(np.float32)
    if features is None:
        with timer.span("encode"):
            features, kept = clip_encoder.encode_paths(query_paths)
        if kept != query_paths:  # drop unreadable queries
            sample_ids = [s for s, p in zip(sample_ids, query_paths)
                          if p in set(kept)]
            query_paths = kept
        if write:
            np.save(feat_file, features)
            with open(paths_file, "w") as f:
                json.dump(query_paths, f)

    # one batched first-stage search for every query of the dataset-shot
    with timer.span("search"):
        first_stage_all = first_stage_topk(features, bank, cfg.top_k)

    all_results: Dict[str, List[dict]] = {}
    for sample_id, image_path, first_stage in zip(
            sample_ids, query_paths, first_stage_all):
        category = sample_to_category[sample_id]
        with timer.span("rerank"):
            final = style_rerank(image_path, first_stage[:cfg.rerank_top_k],
                                 style_encoder)
        per_sample_file = os.path.join(
            results_dir,
            f"{dataset}_{shot}_shot_{category}_{sample_id}"
            "_retrieval_results.json")
        with timer.span("write"):
            if write:
                with open(per_sample_file, "w", encoding="utf-8") as f:
                    json.dump(final, f, indent=2, ensure_ascii=False)
            if write and cfg.visualize:
                from .visualize import visualize_results
                visualize_results(
                    image_path, [r["image_path"] for r in final[:10]],
                    os.path.join(results_dir,
                                 f"{dataset}_{shot}_shot_{category}_"
                                 f"{sample_id}_visual.jpg"))
        all_results.setdefault(category, []).append({
            "sample_id": sample_id,
            "image_path": image_path,
            "category": category,
            "similar_images": final,
        })

    if write:
        out_file = os.path.join(
            results_dir,
            f"{dataset}_{shot}_shot_retrieval_results{wtag}.json")
        with open(out_file, "w", encoding="utf-8") as f:
            json.dump(all_results, f, indent=2, ensure_ascii=False)
    logger.info("%s %d_shot: %d categories retrieved", dataset, shot,
                len(all_results))
    return all_results


def run_retrieval(datasets: Sequence[str], shots: Sequence[int],
                  bank: EmbeddingBank, clip_encoder: ClipImageEncoder,
                  style_encoder: StyleEncoder, lamainpaint_dir: str,
                  results_dir: str,
                  cfg: RetrievalConfig = RetrievalConfig(),
                  worker_id: int = 0, num_workers: int = 1, *,
                  timer: Optional[StepTimer] = None) -> dict:
    """Top-level sweep; writes ``all_shots_retrieval_results.json``
    (ref :1053-1097) — the contract consumed by the generate stage. With
    ``num_workers`` > 1 each worker writes its disjoint partial as
    ``all_shots_retrieval_results.worker{W}.json``."""
    all_shots: Dict[str, dict] = {}
    for dataset in datasets:
        all_shots[dataset] = {}
        for shot in shots:
            results = retrieve_dataset_shot(
                dataset, shot, bank, clip_encoder, style_encoder,
                lamainpaint_dir, results_dir, cfg,
                worker_id=worker_id, num_workers=num_workers, timer=timer)
            if results:
                all_shots[dataset][f"{shot}_shot"] = results
    if any(all_shots.values()) and (bank.mesh is None
                                    or bank.mesh.is_writer()):
        name = "all_shots_retrieval_results.json" if num_workers <= 1 \
            else f"all_shots_retrieval_results.worker{worker_id}.json"
        out = os.path.join(results_dir, name)
        with open(out, "w", encoding="utf-8") as f:
            json.dump(all_shots, f, indent=2, ensure_ascii=False)
    return all_shots
