"""CLI — one programmatic entry replacing the reference's shell run-book
(port of ``domainrag_tpu/cli/main.py``).

Subcommands mirror the reference scripts' flags where sensible:

  domainrag-tpu-torch inpaint   --datasets NEU-DET --shots 1 5 10
  domainrag-tpu-torch retrieve  --datasets NEU-DET --shots 1 --corpus coco=./coco/train2017
  domainrag-tpu-torch generate  --dataset NEU-DET --shots 5
  domainrag-tpu-torch compose   --dataset NEU-DET --shot 5 --process_id 1 [--resume|--failed_only]
  domainrag-tpu-torch pipeline  --datasets NEU-DET --shots 1 [--stages inpaint,retrieve,...]

``--tiny-models`` runs random tiny weights (no checkpoints needed);
``--checkpoints DIR`` loads real weights from safetensors
(models/convert.py). Models run on ``--device`` (``cuda`` by default,
which raises without a card; ``cpu`` runs the plain versions). One
process serves one card. Several cards run as one mesh when launched
together (``torchrun --nproc_per_node G -m domainrag_tpu_torch.cli.main
...``, ``--model_parallel`` / ``--pipeline_parallel`` shaping it: NCCL
on cards, gloo with ``--device cpu``; rank 0 writes), or as workers over
disjoint sample slices (``--worker_id`` / ``--num_workers``, or
``--distributed`` under one group, where a worker is a host: the
processes torchrun starts there form its mesh, and ``--model_parallel``
/ ``--pipeline_parallel`` apply inside it).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List

from ..core.config import (ComposeConfig, DEFAULT_SHOTS, DATASET_PARAMS,
                           FluxSamplingConfig, GenerateConfig, MeshConfig,
                           PipelineConfig, ReduxConfig, ResolutionPolicy,
                           get_dataset_params, get_shots_for_dataset)
from ..core.log import get_logger, maybe_trace

logger = get_logger("domainrag_tpu_torch.cli")


def _corpus_sources(specs: List[str]) -> Dict[str, List[str]]:
    """--corpus name=dir[,name=dir...] -> {name: [image paths]}."""
    sources: Dict[str, List[str]] = {}
    for spec in specs:
        name, _, directory = spec.partition("=")
        paths = sorted(
            p for ext in ("*.jpg", "*.jpeg", "*.png")
            for p in glob.glob(os.path.join(directory, "**", ext),
                               recursive=True))
        sources[name] = paths
    return sources


def _parse_vcache_interval(v: str):
    """--velocity_cache_interval forms: int N (uniform), "auto"
    (budget-calibrated uniform interval), "sched:K" (DP-placed anchors),
    or an explicit comma list of anchor step indices ("0,2,5,9,...")."""
    if v == "auto" or v.startswith("sched:"):
        if v.startswith("sched:"):
            int(v.split(":", 1)[1])     # validate at parse time
        return v
    if "," in v:
        return tuple(int(x) for x in v.split(","))
    return int(v)


def _vci_on(v) -> bool:
    if isinstance(v, tuple):
        return len(v) > 0
    if isinstance(v, str):
        return True                      # "auto" / "sched:K"
    return v > 1


def _build_cfg(args) -> PipelineConfig:
    # reject unsupported combinations up front, before the inpaint and
    # retrieve stages run for minutes only to die at denoise time
    pp = getattr(args, "pipeline_parallel", 1)
    bci = getattr(args, "block_cache_interval", 1)
    vci = getattr(args, "velocity_cache_interval", 1)
    if pp > 1 and (bci == "auto" or bci > 1):
        raise SystemExit(
            "--pipeline_parallel and --block_cache_interval are mutually "
            "exclusive (block caching is not implemented on the pipelined "
            "denoise path)")
    if (bci == "auto" or bci > 1) and _vci_on(vci):
        raise SystemExit(
            "--block_cache_interval and --velocity_cache_interval are "
            "mutually exclusive accelerators — pick one")
    if pp > 1 and getattr(args, "model_parallel", 1) > 1:
        raise SystemExit(
            "--pipeline_parallel and --model_parallel are mutually "
            "exclusive (the PP path serves unsharded per-stage block "
            "params; pick ONE of TP or PP for the transformer)")
    sampling = FluxSamplingConfig(
        num_steps=args.steps,
        height=args.size, width=args.size,
        seed=args.seed,
        block_cache_interval=getattr(args, "block_cache_interval", 1),
        velocity_cache_interval=getattr(
            args, "velocity_cache_interval", 1),
        velocity_cache_order=getattr(args, "velocity_cache_order", 1))
    # --custom_upscale DATASET:DIM (ref outpainting...py:1920-1932)
    custom = {}
    for spec in args.custom_upscale or []:
        name, _, dim = spec.partition(":")
        custom[name] = int(dim)
    dataset_params = {name: get_dataset_params(name, custom)
                      for name in set(list(DATASET_PARAMS) + args.datasets)}
    compose = ComposeConfig(
        resolution=ResolutionPolicy(max_dimension=args.max_dimension),
        num_steps=args.steps,
        dataset_params=dataset_params,
        max_rank_batch=getattr(args, "max_rank_batch", None),
        velocity_cache_interval=vci,
        velocity_cache_order=getattr(args, "velocity_cache_order", 1))
    return PipelineConfig(
        datasets=tuple(args.datasets),
        shots=tuple(args.shots),
        datasets_dir=args.datasets_dir,
        output_dir=args.output_dir,
        process_id=str(args.process_id),
        worker_id=args.worker_id,
        num_workers=args.num_workers,
        generate=GenerateConfig(sampling=sampling, redux=ReduxConfig(),
                                max_rank_batch=getattr(
                                    args, "max_rank_batch", None)),
        compose=compose,
        mesh=MeshConfig(
            model_parallel_size=getattr(args, "model_parallel", 1),
            pipeline_parallel_size=getattr(args, "pipeline_parallel", 1)),
    )


def _quantize_in_place(params) -> None:
    """``quant.quantize_tree`` of ``params``, entry by entry (each block
    of a block list on its own), so one block's unquantized weights at a
    time stay beside the int8 tree: two bf16 FLUX.1 MMDiTs and the shared
    towers fill most of an 80 GB card."""
    from ..models.quant import quantize_tree
    for key, value in params.items():
        if isinstance(value, list):
            for i, block in enumerate(value):
                value[i] = quantize_tree(block)
        else:
            params[key] = quantize_tree(value)


def _quantize_runner(runner):
    # the weights already live on the serving device; quantization runs
    # there (models.quant computes in f32 on the weight's own device)
    _quantize_in_place(runner.flux_bundle.flux_params)
    _quantize_in_place(runner.fill_bundle.flux_params)


def _pretrained_specs(args):
    specs = {}
    for spec in getattr(args, "corpus_features", []) or []:
        name, _, rest = spec.partition("=")
        feat, _, paths = rest.partition(":")
        specs[name] = (feat, paths)
    return specs


def _build_runner(args):
    cfg = _build_cfg(args)
    corpus = _corpus_sources(args.corpus)
    want_int8 = args.int8 or getattr(args, "w8a8", False)
    if getattr(args, "w8a8", False):
        # process-wide serving mode, read at every quantized linear
        from ..models.common import set_int8_activations
        set_int8_activations(True)
    if getattr(args, "int8_qk", False):
        from ..ops.mmdit_attention import set_int8_qk
        set_int8_qk(True)
    device = getattr(args, "device", "cuda")
    if args.tiny_models:
        from ..pipeline.orchestrator import build_tiny_runner
        runner = build_tiny_runner(cfg, corpus, device=device)
    elif args.checkpoints:
        from ..models.convert import build_runner_from_checkpoints
        runner = build_runner_from_checkpoints(args.checkpoints, cfg, corpus,
                                               device=device)
    else:
        raise SystemExit(
            "provide --checkpoints DIR (converted weights) or --tiny-models")
    runner.force_recompute = args.force_recompute
    runner.pretrained_features = _pretrained_specs(args)
    if want_int8:
        _quantize_runner(runner)
    return runner


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--datasets", "--dataset", nargs="+", dest="datasets",
                   default=["NEU-DET"])
    p.add_argument("--shots", "--shot", nargs="+", dest="shots", type=int,
                   default=list(DEFAULT_SHOTS))
    p.add_argument("--datasets_dir", default="./datasets")
    p.add_argument("--output_dir", default="./output")
    p.add_argument("--process_id", default="0")
    p.add_argument("--corpus", nargs="*", default=[],
                   help="corpus sources: name=dir (e.g. coco=./coco/train2017)")
    p.add_argument("--tiny-models", action="store_true",
                   help="random tiny weights (no checkpoints)")
    p.add_argument("--checkpoints", default=None,
                   help="directory with safetensors checkpoints "
                        "(models/convert.py: flux-dev/, flux-fill/, vae/, "
                        "t5/, clip-text/, siglip/, redux/, clip-vision/, "
                        "resnet-stem/, lama/)")
    p.add_argument("--device", default="cuda",
                   help="device the models run on: cuda (default; raises "
                        "without a card) or cpu (the plain versions)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--failed_only", action="store_true")
    p.add_argument("--collect_only", action="store_true",
                   help="only gather final results, no compute "
                        "(reference --collect_only)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--custom_upscale", nargs="*", default=[],
                   help="per-dataset upscale override DATASET:DIM "
                        "(reference --custom_upscale)")
    p.add_argument("--max_dimension", type=int, default=2800)
    p.add_argument("--auto_shots", action="store_true",
                   help="use each dataset's canonical shot sweep "
                        "(NWPU: 3/5/10/20, Camouflage: 1/2/3/5, else 1/5/10)")
    p.add_argument("--trace_dir", default=None,
                   help="write a torch.profiler Chrome trace of the run "
                        "here; only under it are the stages' spans "
                        "device-synchronised and annotated in the trace")
    p.add_argument("--block_cache_interval", default=1,
                   type=lambda v: v if v == "auto" else int(v),
                   help="block-residual caching: the blocks run every N "
                        "denoise steps and replay their residuals in "
                        "between (outputs change); 1 = exact. The cache "
                        "holds one residual per block per sample (1.87 GB "
                        "per 1024 px sample in bf16). 'auto' calibrates "
                        "the largest interval within a divergence budget "
                        "at first use")
    p.add_argument("--velocity_cache_interval", default=1,
                   type=_parse_vcache_interval,
                   help="velocity-extrapolation caching: the MMDiT runs "
                        "every N-th denoise step, the others integrate a "
                        "velocity extrapolated from the last two computed "
                        "ones (outputs change); 1 = exact. Exclusive with "
                        "--block_cache_interval. 'auto' calibrates the "
                        "largest interval within a divergence budget; "
                        "'sched:K' keeps uniform-K's model-call count and "
                        "ships the DP-placed or the uniform anchors, "
                        "whichever decodes closer to the exact image; a "
                        "comma list '0,2,5,...' gives the anchor steps")
    p.add_argument("--velocity_cache_order", type=int, default=1,
                   choices=(0, 1),
                   help="velocity cache extrapolation order: 1 = linear "
                        "in sigma (default), 0 = hold last velocity")
    p.add_argument("--max_rank_batch", type=int, default=None,
                   help="denoise a sample's ranks (generate) and "
                        "background fills (compose) in chunks of N "
                        "(default: no chunking)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="model axis of the processes' (data, model) mesh "
                        "(torchrun, one process per card): the data axis "
                        "gets the rest")
    p.add_argument("--pipeline_parallel", type=int, default=1,
                   help="PP stages for generate and compose serving "
                        "(parallel/pipeline_parallel.py), one process "
                        "per stage; >1 replaces data parallelism")
    p.add_argument("--worker_id", type=int, default=0,
                   help="independent workers: this worker's index")
    p.add_argument("--num_workers", type=int, default=1,
                   help="independent workers: total workers (one process "
                        "per card; worker 0 merges the partials)")
    p.add_argument("--distributed", action="store_true",
                   help="coordinate workers through a torch.distributed "
                        "group: each host (torchrun's LOCAL_WORLD_SIZE "
                        "processes) is one worker over a disjoint sample "
                        "slice and its processes one mesh; stage barriers "
                        "and worker-0 merges run automatically")
    p.add_argument("--coordinator", default=None,
                   help="--distributed: host:port of process 0 (omit to "
                        "read torchrun's environment)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="--distributed: total process count")
    p.add_argument("--process_index", type=int, default=None,
                   help="--distributed: this process's index")
    p.add_argument("--force_recompute", action="store_true",
                   help="ignore feature caches (reference --force_* flags)")
    p.add_argument("--corpus_features", nargs="*", default=[],
                   help="precomputed bank: name=features.npy|.pt:paths.json "
                        "(reference --pretrained_coco_features migration)")
    p.add_argument("--reference_artifacts", action="store_true",
                   help="read retrieval JSONs produced by the reference "
                        "implementation through the tolerant migration "
                        "reader (zero-padded COCO ids, case-variant "
                        "dataset keys, stale paths); fuzzy hits are "
                        "logged loudly")
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 for the Flux MMDiTs "
                        "(models/quant.py)")
    p.add_argument("--int8_qk", action="store_true",
                   help="int8 QK inside the fused attention kernel (P.V "
                        "stays bf16; ops/mmdit_attention.py). Composes "
                        "with --w8a8")
    p.add_argument("--w8a8", action="store_true",
                   help="implies --int8 and additionally quantizes "
                        "activations per token to int8: the quantized "
                        "linears run the W8A8 int8 GEMM kernel "
                        "(ops/int8_gemm.py)")
    p.add_argument("--legacy_generate", action="store_true",
                   help="legacy no-retrieval-JSON generation mode (ref "
                        "batch_generate_flux_kshot.py:526-736): targets "
                        "from {inpainted_dir}/{D}/inpainted_images/"
                        "{sample}/1_inpainted.png, one generated_image.png "
                        "per sample from the per-dataset legacy retrieval "
                        "file")
    p.add_argument("--inpainted_dir", default=None,
                   help="legacy mode: root of the non-k-shot inpaint "
                        "layout (defaults to <output_dir>/lamainpaint)")
    p.add_argument("--retrieval_results_dir", default=None,
                   help="legacy mode: dir holding {D}_all_categories_"
                        "retrieval_results.json (defaults to "
                        "<output_dir>/retrieval_results)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="domainrag-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("inpaint", "retrieve", "generate", "compose", "pipeline",
                 "export"):
        p = sub.add_parser(name)
        _add_common(p)
        if name == "pipeline":
            p.add_argument("--stages",
                           default="inpaint,retrieve,generate,compose")
    args = parser.parse_args(argv)

    from ..parallel import multihost
    from ..parallel.mesh import initialize_distributed
    # torchrun's environment (or --coordinator) starts the group; without
    # either this process runs alone on one card
    initialize_distributed(args.coordinator if args.distributed else None,
                           args.num_processes, args.process_index,
                           device=args.device)
    if args.distributed:
        # a worker is a host: its processes (LOCAL_WORLD_SIZE) are its mesh
        args.worker_id = multihost.worker_index()
        args.num_workers = multihost.worker_count()
        logger.info("distributed: worker %d/%d of %d process(es)",
                    args.worker_id, args.num_workers,
                    multihost.local_size())

    if args.auto_shots and len(args.datasets) == 1:
        args.shots = list(get_shots_for_dataset(args.datasets[0]))

    if args.command == "export":
        from ..pipeline.export import export_synthetic_coco
        out = {}
        for dataset in args.datasets:
            shots = get_shots_for_dataset(dataset) if args.auto_shots \
                else args.shots
            for shot in shots:
                r = export_synthetic_coco(
                    args.datasets_dir, args.output_dir, dataset, shot,
                    str(args.process_id))
                out[f"{dataset}/{shot}"] = {
                    "images": len(r["images"]),
                    "annotations": len(r["annotations"])}
        print(json.dumps(out, indent=2))
        return 0

    if args.command == "compose" and args.collect_only:
        from ..stages.compose import collect_final_results
        out = {}
        for shot in args.shots:
            out[f"{shot}_shot"] = collect_final_results(
                args.output_dir, str(args.process_id), shot)
        print(json.dumps(out, indent=2))
        return 0

    runner = _build_runner(args)
    from ..core.interrupt import graceful_interrupts
    with graceful_interrupts(), maybe_trace(args.trace_dir):
        if args.command == "inpaint":
            out = runner.run_inpaint(resume=args.resume)
        elif args.command == "retrieve":
            out = runner.run_retrieve()
        elif args.command == "generate":
            if args.legacy_generate:
                out = runner.run_generate_legacy(
                    resume=args.resume,
                    inpainted_dir=args.inpainted_dir,
                    retrieval_results_dir=args.retrieval_results_dir)
            else:
                out = runner.run_generate(
                    resume=args.resume,
                    reference_artifacts=args.reference_artifacts)
        elif args.command == "compose":
            out = runner.run_compose(resume=args.resume,
                                     failed_only=args.failed_only)
        else:
            stages = tuple(x.strip() for x in args.stages.split(",")
                           if x.strip())
            out = runner.run(stages=stages, resume=args.resume,
                             failed_only=args.failed_only,
                             reference_artifacts=args.reference_artifacts)
    print(json.dumps(_summarize(out), indent=2, default=str))
    return 0


def _summarize(out):
    """Counters only — stage outputs can be large nested dicts."""
    if isinstance(out, dict):
        return {k: _summarize(v) for k, v in list(out.items())[:50]}
    if isinstance(out, list):
        return f"[{len(out)} items]"
    return out


if __name__ == "__main__":
    sys.exit(main())
