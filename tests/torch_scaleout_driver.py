"""The process side of the port's scale-out tests (``test_torch_scaleout_*``).

Each test file starts one gloo group of 2-4 processes (``spawn``, a
``file://`` rendezvous under the test's tmp dir) through :func:`launch`;
every process runs the file's scenarios in order, reading its inputs from
``.npy`` / pickle files the test wrote and writing its outputs the same
way (``<scenario>.npy`` etc. from rank 0, or ``<scenario>.r<rank>.npy``).
A scenario that raises writes ``<scenario>.err`` with its traceback; the
test of that scenario fails on it. This module imports no JAX: the
processes run the port alone.
"""

import os
import pickle
import traceback

import numpy as np


def load(workdir, name):
    with open(os.path.join(workdir, name), "rb") as f:
        return pickle.load(f)


def dump(workdir, name, obj):
    with open(os.path.join(workdir, name), "wb") as f:
        pickle.dump(obj, f)


def _main(rank, world, workdir, suite):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    mesh_mod.initialize_distributed(f"file://{workdir}/rendezvous", world,
                                    rank, device="cpu")
    try:
        for name, fn in SUITES[suite]:
            try:
                fn(rank, world, workdir)
            except Exception:
                with open(os.path.join(workdir, f"{name}.err"), "a") as f:
                    f.write(f"rank {rank}:\n{traceback.format_exc()}")
                raise
            dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(workdir, world, suite, timeout=240):
    """Run ``SUITES[suite]`` (a list of (name, fn(rank, world, workdir)))
    in ``world`` spawned processes of one gloo group."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_main, args=(world, workdir, suite),
                             nprocs=world, join=False, start_method="spawn")
    try:
        import time
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{suite} did not finish in {timeout} s")
    except Exception as e:
        with open(os.path.join(workdir, "launch.err"), "w") as f:
            f.write(repr(e))
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def result(workdir, name):
    """A scenario's outputs (its pickle), or the failure it recorded."""
    err = os.path.join(workdir, f"{name}.err")
    if os.path.exists(err):
        with open(err) as f:
            raise AssertionError(f"scenario {name} failed:\n{f.read()}")
    path = os.path.join(workdir, f"{name}.pkl")
    if not os.path.exists(path):
        launch_err = os.path.join(workdir, "launch.err")
        why = open(launch_err).read() if os.path.exists(launch_err) else ""
        raise AssertionError(f"scenario {name} wrote nothing {why}")
    return load(workdir, f"{name}.pkl")


def np_tree(tree):
    """A torch tree as numpy (for the pickles)."""
    import torch
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(np_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy() if tree.dtype == torch.bfloat16 \
            else tree.detach().numpy()
    return tree


def as_np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# inputs both sides draw (numpy, seeded)
# ---------------------------------------------------------------------------

def topk_inputs():
    rng = np.random.default_rng(0)
    queries = rng.integers(-8, 8, (5, 64)).astype(np.float32)
    bank = rng.integers(-8, 8, (1003, 64)).astype(np.float32)  # odd size
    rng = np.random.default_rng(1)
    tq = rng.integers(-2, 3, (3, 32)).astype(np.float32)
    tb = rng.integers(-2, 3, (512, 32)).astype(np.float32)
    tb[100:200] = tb[0:100]                # exact ties across shards
    return (queries, bank, 100), (tq, tb, 64)


def qkv(seed, shape, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def flux_inputs(cfg, batch, seed=0):
    """(img, txt, pooled, t, guidance) as the JAX tests draw them, for a
    4x4 grid and 6 text tokens."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((batch, 16, cfg.in_channels)).astype(
        np.float32)
    txt = rng.standard_normal((batch, 6, cfg.text_dim)).astype(np.float32)
    pooled = rng.standard_normal((batch, cfg.pooled_dim)).astype(np.float32)
    t = np.linspace(0.2, 0.9, batch).astype(np.float32)
    g = np.full((batch,), 4.0, np.float32)
    return img, txt, pooled, t, g


UNEVEN = dict(in_channels=16, out_channels=16, hidden=64, heads=4,
              head_dim=16, depth_double=3, depth_single=5, text_dim=32,
              pooled_dim=24, time_embed_dim=32, axes_dim=(4, 6, 6))


# ---------------------------------------------------------------------------
# ops: sharded top-k, the ring, TP attention and forward, PP, multihost
# ---------------------------------------------------------------------------

def _t(x):
    import torch
    return torch.from_numpy(np.ascontiguousarray(x))


def _flux_apply_args(cfg, batch, seed=0):
    import torch
    from domainrag_tpu_torch.models.flux import model as flux
    img, txt, pooled, t, g = (_t(x) for x in flux_inputs(cfg, batch, seed))
    iid = torch.from_numpy(flux.make_image_ids(4, 4))
    tid = torch.from_numpy(flux.make_text_ids(6))
    return (img, txt, pooled, t, iid, tid), g


def ops_topk(rank, world, workdir):
    from domainrag_tpu_torch.parallel import collectives, mesh as mesh_mod
    mesh = mesh_mod.create_mesh(model_parallel=1)
    out = {}
    for name, (q, bank, k) in zip(("odd", "ties"), topk_inputs()):
        padded, n_valid = collectives.pad_bank_for_mesh(bank, mesh)
        shard = collectives.shard_bank(padded, mesh, device="cpu")
        for use_pallas in (False, True):
            s, i = collectives.sharded_topk(_t(q), shard, k, mesh, n_valid,
                                            use_pallas=use_pallas)
            out[(name, use_pallas)] = (s.numpy(), i.numpy(),
                                       padded.shape[0], shard.shape[0])
    if rank == 0:
        dump(workdir, "topk.pkl", out)


def ops_ring(rank, world, workdir):
    from domainrag_tpu_torch.ops import ring_attention as ring
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    data = mesh_mod.create_mesh(model_parallel=1)
    sp_tp = mesh_mod.create_mesh(model_parallel=2)
    out = {
        "dense": ring.ring_attention(*(_t(x) for x in qkv(0, (1, 2, 64, 16))),
                                     data).numpy(),
        "ragged": ring.ring_attention_padded(
            *(_t(x) for x in qkv(1, (1, 1, 50, 8))), data).numpy(),
        "heads": ring.ring_attention(
            *(_t(x) for x in qkv(2, (1, 4, 64, 16))), sp_tp, axis="data",
            head_axis="model").numpy(),
    }
    if rank == 0:
        dump(workdir, "ring.pkl", out)


def ops_tp_attention(rank, world, workdir):
    """Each rank's heads (all of them where 3 heads do not split over 2),
    attention under tp_attention, gathered over the model axis."""
    from domainrag_tpu_torch.ops import attention as attn
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    mesh = mesh_mod.create_mesh(model_parallel=2)
    j = mesh.index("model")
    q, k, v = (_t(x) for x in qkv(3, (1, 4, 32, 16)))
    with attn.tp_attention(mesh):
        local = attn.attention(q[:, 2 * j:2 * j + 2], k[:, 2 * j:2 * j + 2],
                               v[:, 2 * j:2 * j + 2])
        q3 = _t(qkv(4, (1, 3, 16, 8), 1)[0])
        whole = attn.attention(q3, q3, q3)
    out = {"split": mesh.all_gather(local, "model", dim=1).numpy(),
           "indivisible": whole.numpy()}
    if rank == 0:
        dump(workdir, "tp_attention.pkl", out)


def _port_flux(workdir, name):
    from domainrag_tpu_torch import bridge
    from domainrag_tpu_torch.models.flux import model as flux
    params = bridge.params(load(workdir, name), device="cpu")
    return params, flux


def ops_tp_forward(rank, world, workdir):
    from domainrag_tpu_torch.ops import attention as attn
    from domainrag_tpu_torch.parallel import mesh as mesh_mod, sharding
    params, flux = _port_flux(workdir, "tiny_flux.pkl")
    cfg = flux.TINY_FLUX
    args, g = _flux_apply_args(cfg, 2)
    mesh = mesh_mod.create_mesh(model_parallel=2)
    local = sharding.shard_params(params, mesh)
    with attn.tp_attention(mesh):
        out = flux.apply(local, *args, cfg, guidance=g)
    widths = (local["double"][0]["img_qkv"]["w"].shape,
              local["single"][0]["linear1"]["w"].shape,
              local["single"][0]["linear2"]["w"].shape)
    if rank == 0:
        dump(workdir, "tp_forward.pkl", {"out": out.numpy(),
                                         "widths": widths})


def ops_pp(rank, world, workdir):
    """S = 2 on ranks 0-1 (tiny config, batch 4) and S = 4 (3 doubles + 5
    singles, batch 2), at the JAX tests' microbatch counts and at one
    microbatch, beside the port's own apply."""
    import torch
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    from domainrag_tpu_torch.parallel import pipeline_parallel as pp
    out = {}
    for n, name, cfg_kw, batch, micro in (
            (2, "tiny_flux.pkl", None, 4, 4),
            (4, "uneven_flux.pkl", UNEVEN, 2, 2)):
        params, flux = _port_flux(workdir, name)
        cfg = flux.TINY_FLUX if cfg_kw is None else flux.FluxConfig(**cfg_kw)
        args, g = _flux_apply_args(cfg, batch)
        mesh = mesh_mod.Mesh(np.arange(n), ("pipe",))
        if not mesh.contains_me():
            continue
        stages = pp.prepare_stages(params, n, mesh=mesh)
        ref = flux.apply(params, *args, cfg, guidance=g)
        got = {m: pp.pipelined_apply(params, stages, *args, cfg, mesh,
                                     guidance=g, microbatches=m)
               for m in (micro, 1)}
        out[n] = {"out": got[micro].numpy(), "apply": ref.numpy(),
                  "equal_apply": {m: bool(torch.equal(o, ref))
                                  for m, o in got.items()},
                  "chunks": (len(stages.doubles), len(stages.singles),
                             stages.per_stage_double,
                             stages.per_stage_single)}
    if rank == 0:
        dump(workdir, "pp.pkl", out)


# (S, config, batch) of the interleaved schedule's cases; M in PP_MICRO
PP_SCHEDULES = ((2, None, 12), (4, UNEVEN, 12))
PP_MICRO = (1, 3, 4)


def ops_pp_schedule(rank, world, workdir):
    """The interleaved schedule at S = 2, 4 and M = 1, 3, 4: every rank's
    output, torch.equal to the serial chain of the same (depth-padded)
    chunks one microbatch at a time, and each rank's recorded steps."""
    import torch
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    from domainrag_tpu_torch.parallel import pipeline_parallel as pp
    out = {}
    for n, cfg_kw, batch in PP_SCHEDULES:
        params, flux = _port_flux(workdir, "tiny_flux.pkl" if cfg_kw is None
                                  else "uneven_flux.pkl")
        cfg = flux.TINY_FLUX if cfg_kw is None else flux.FluxConfig(**cfg_kw)
        args, g = _flux_apply_args(cfg, batch)
        mesh = mesh_mod.Mesh(np.arange(n), ("pipe",))
        if not mesh.contains_me():
            continue
        stages = pp.prepare_stages(params, n, mesh=mesh)
        whole = pp.prepare_stages(params, n)
        for m in PP_MICRO:
            steps = []
            got = pp.pipelined_apply(params, stages, *args, cfg, mesh,
                                     guidance=g, microbatches=m,
                                     schedule=steps)
            img, txt, vec, cos, sin = flux._embed(params, *args, cfg, g)
            x, mb, t_len = torch.cat([txt, img], 1), batch // m, txt.shape[1]
            serial = []
            for i in range(m):
                r = slice(i * mb, (i + 1) * mb)
                a = pp.run_doubles(whole.doubles, x[r], vec[r], cos, sin,
                                   t_len, cfg)
                serial.append(pp.run_singles(whole.singles, a, vec[r], cos,
                                             sin, cfg))
            serial = flux._final(params, torch.cat(serial)[:, t_len:], vec)
            out[(n, m, rank)] = {"out": got.numpy(), "steps": steps,
                                 "equal_serial": bool(torch.equal(got,
                                                                  serial))}
    dump(workdir, f"pp_schedule.r{rank}.pkl", out)


def ops_multihost(rank, world, workdir):
    import torch.distributed as dist
    from domainrag_tpu_torch.parallel import multihost
    multihost.barrier("scale-out test")
    seen = [None] * world
    dist.all_gather_object(seen, (multihost.is_distributed(),
                                  multihost.process_index(),
                                  multihost.process_count(),
                                  multihost.shared_timestamp()))
    if rank == 0:
        dump(workdir, "multihost.pkl", seen)


# ---------------------------------------------------------------------------
# serving: DP, PP, SP, TP (bf16 and W8A8), the velocity cache, the errors
# ---------------------------------------------------------------------------

SIZE = 32


def port_bundle(workdir, name, fill):
    """A port bundle on the CPU from the JAX tiny bundle's trees the test
    pickled (``<name>.pkl``: {tree name: numpy tree})."""
    import torch
    from domainrag_tpu_torch import bridge
    from domainrag_tpu_torch.models.flux import pipeline as tfp
    trees = {k: bridge.params(v, device="cpu")
             for k, v in load(workdir, f"{name}.pkl").items()}
    cfgs = tfp.tiny_configs(fill)
    return tfp.FluxBundle(**trees, **cfgs, **tfp.tiny_tokenizers(cfgs),
                          compute_dtype=torch.float32,
                          device=torch.device("cpu"))


def fill_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (n, SIZE, SIZE, 3), dtype=np.uint8)
    masks = np.full((n, SIZE, SIZE), 255, np.uint8)
    masks[:, 8:16, 8:20] = 0
    return images, masks


def _gen_kw(steps=2, **kw):
    return dict(height=SIZE, width=SIZE, num_steps=steps, **kw)


def jax_noise(workdir, seeds):
    """The JAX package's per-seed noise the test pickled
    (``jax_noise.pkl``: {seed: (seq, c)}), stacked."""
    import torch
    table = load(workdir, "jax_noise.pkl")
    return torch.stack([_t(table[s]) for s in seeds])


def serve_dp(rank, world, workdir):
    """generate over a 4-rank data axis, an odd batch padded, against the
    same batch in one process and each row alone, and from the JAX noise
    (against the JAX package's DP generate)."""
    from domainrag_tpu_torch.models.flux import pipeline as tfp
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    b = port_bundle(workdir, "gen", False)
    e, p = (_t(x) for x in load(workdir, "gen_prior.pkl"))
    mesh = mesh_mod.create_mesh()
    kw = _gen_kw(seed=[0, 1, 2])
    noise = jax_noise(workdir, [0, 1, 2])
    out = {"dp": tfp.generate(b, e, p, mesh=mesh, **kw),
           "dp_jax": tfp.generate(b, e, p, mesh=mesh, noise=noise, **kw),
           "vcache_jax": tfp.generate(
               b, e, p, mesh=mesh, velocity_cache_interval=2, noise=noise,
               **_gen_kw(steps=4, seed=[0, 1, 2])),
           "one": tfp.generate(b, e, p, **kw),
           "rows": np.stack([tfp.generate(b, e[i:i + 1], p[i:i + 1],
                                          **_gen_kw(seed=i))
                             for i in range(3)]),
           "vcache": tfp.generate(b, e, p, mesh=mesh,
                                  velocity_cache_interval=2,
                                  **_gen_kw(steps=4, seed=[0, 1, 2])),
           "vcache_one": tfp.generate(b, e, p, velocity_cache_interval=2,
                                      **_gen_kw(steps=4, seed=[0, 1, 2])),
           "vcache_rows": np.stack([tfp.generate(
               b, e[i:i + 1], p[i:i + 1], velocity_cache_interval=2,
               **_gen_kw(steps=4, seed=i)) for i in range(3)])}
    if rank == 0:
        dump(workdir, "dp.pkl", out)


def serve_dp_stage(rank, world, workdir):
    """generate_samples_dp (3 samples x 2 ranks = 6 rows; 5 x 1) against
    generate_sample, each rank's sample alone; then again with the JAX
    noise in place of the port's draw (against the JAX package's
    generate_samples_dp)."""
    from PIL import Image
    from domainrag_tpu_torch.core.config import (FluxSamplingConfig,
                                                 GenerateConfig)
    from domainrag_tpu_torch.models.flux import pipeline as tfp
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    from domainrag_tpu_torch.stages import generate as gen_stage
    stage = gen_stage.GenerateStage(
        port_bundle(workdir, "gen", False),
        GenerateConfig(sampling=FluxSamplingConfig(num_steps=2, height=SIZE,
                                                   width=SIZE, seed=0),
                       top_ranks=2))
    mesh = mesh_mod.create_mesh()
    out = {}
    for case in ("pairs", "odd"):
        items = load(workdir, f"items_{case}.pkl")
        paths = gen_stage.generate_samples_dp(stage, items, mesh)
        mesh.barrier()
        if rank == 0:
            seq_dir = os.path.join(workdir, "seq", case)
            seq = {}
            for it in items:
                d = os.path.join(seq_dir, it["sample_id"])
                stage.generate_sample(it["sample_id"], it["target_path"],
                                      it["refs"], d)
                seq[it["sample_id"]] = [
                    np.asarray(Image.open(os.path.join(
                        d, f"generated_image_rank{r['rank']}.png")))
                    for r in it["refs"]]
            out[case] = {
                "dp": {k: [np.asarray(Image.open(x)) for x in v]
                       for k, v in paths.items()},
                "seq": seq, "paths": paths}
        mesh.barrier()
        real = tfp._noise
        tfp._noise = lambda bundle, seeds, seq, c: jax_noise(workdir, seeds)
        try:
            jitems = [dict(it, sample_dir=os.path.join(
                workdir, "jaxnoise", case, it["sample_id"])) for it in items]
            paths = gen_stage.generate_samples_dp(stage, jitems, mesh)
        finally:
            tfp._noise = real
        mesh.barrier()
        if rank == 0:
            out[case]["dp_jax"] = {k: [np.asarray(Image.open(x)) for x in v]
                                   for k, v in paths.items()}
    if rank == 0:
        dump(workdir, "dp_stage.pkl", out)


def serve_pp(rank, world, workdir):
    """generate and fill_batch with the depth over a 4-rank pipe axis, and
    the velocity cache under it, against one process, and from the JAX
    noise (against the JAX package's pipelined generate and fill)."""
    from domainrag_tpu_torch.models.flux import pipeline as tfp
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    pipe = mesh_mod.Mesh(np.arange(4), ("pipe",))
    b = port_bundle(workdir, "gen", False)
    e, p = (_t(x) for x in load(workdir, "gen_prior.pkl"))
    kw = _gen_kw(seed=[0, 1, 2])
    vkw = _gen_kw(steps=4, seed=[0, 1, 2], velocity_cache_interval=2)
    f = port_bundle(workdir, "fill", True)
    fe, fp_ = (_t(x) for x in load(workdir, "fill_prior.pkl"))
    images, masks = fill_inputs(2)
    fkw = dict(num_steps=4, seeds=[0, 1], guidance=30.0, strength=0.6)
    noise, fnoise = jax_noise(workdir, [0, 1, 2]), jax_noise(workdir, [0, 1])
    out = {"gen": tfp.generate(b, e, p, mesh=pipe, pipe_axis="pipe", **kw),
           "gen_jax": tfp.generate(b, e, p, mesh=pipe, pipe_axis="pipe",
                                   noise=noise, **kw),
           "vcache_jax": tfp.generate(b, e, p, mesh=pipe, pipe_axis="pipe",
                                      noise=noise, **vkw),
           "fill_jax": tfp.fill_batch(f, images, masks, fe, fp_, mesh=pipe,
                                      pipe_axis="pipe", noise=fnoise, **fkw),
           "gen_one": tfp.generate(b, e, p, **kw),
           "gen_micro": tfp.generate(b, e, p, mesh=pipe, pipe_axis="pipe",
                                     microbatches=1, **kw),
           "vcache": tfp.generate(b, e, p, mesh=pipe, pipe_axis="pipe",
                                  microbatches=1, **vkw),
           "vcache_micro": tfp.generate(b, e, p, mesh=pipe,
                                        pipe_axis="pipe", **vkw),
           "vcache_one": tfp.generate(b, e, p, **vkw),
           "fill": tfp.fill_batch(f, images, masks, fe, fp_, mesh=pipe,
                                  pipe_axis="pipe", **fkw),
           "fill_one": tfp.fill_batch(f, images, masks, fe, fp_, **fkw)}
    if rank == 0:
        dump(workdir, "pp_serve.pkl", out)


# The hires fill held against the JAX package's: the ring as above, the
# VAE in one tile (the JAX mesh path compiles the tiled VAE into the one
# fill graph, about a minute on the CPU at vae_tile 6; the tiled VAE is
# held against JAX by test_torch_fill_routes).
SP_JAX_KW = dict(num_steps=4, seeds=[0, 1], guidance=30.0, strength=0.6,
                 hires_threshold_px=1, vae_tile=96, vae_overlap=16)


def serve_sp(rank, world, workdir):
    """The hires fill over a 4-rank data axis: attention rings the joint
    sequence (the batch stays whole), against one process, and from the
    JAX noise (against the JAX package's hires fill on its mesh)."""
    from domainrag_tpu_torch.models.flux import pipeline as tfp
    from domainrag_tpu_torch.ops import ring_attention as ring
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    f = port_bundle(workdir, "fill", True)
    fe, fp_ = (_t(x) for x in load(workdir, "fill_prior.pkl"))
    images, masks = fill_inputs(2)
    kw = dict(num_steps=4, seeds=[0, 1], guidance=30.0, strength=0.6,
              hires_threshold_px=1, vae_tile=6, vae_overlap=2)
    calls = []
    real = ring.ring_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    ring.ring_attention = spy
    try:
        sp = tfp.fill_batch(f, images, masks, fe, fp_,
                            mesh=mesh_mod.create_mesh(), **kw)
    finally:
        ring.ring_attention = real
    out = {"sp": sp, "one": tfp.fill_batch(f, images, masks, fe, fp_, **kw),
           "sp_jax": tfp.fill_batch(f, images, masks, fe, fp_,
                                    mesh=mesh_mod.create_mesh(),
                                    noise=jax_noise(workdir, [0, 1]),
                                    **SP_JAX_KW),
           "ring_calls": len(calls), "ring_shape": calls[0]}
    if rank == 0:
        dump(workdir, "sp.pkl", out)


def serve_tp(rank, world, workdir):
    """shard_bundle on a (2, 2) mesh: generate (DP over data, TP over
    model) in bf16-free f32, with the velocity cache, and under W8A8 on
    the JAX-quantized tree, with the JAX noise."""
    from domainrag_tpu_torch.models import common
    from domainrag_tpu_torch.models.flux import pipeline as tfp
    from domainrag_tpu_torch.parallel import deploy, mesh as mesh_mod
    mesh = mesh_mod.create_mesh(model_parallel=2)
    b = port_bundle(workdir, "gen", False)
    tp = deploy.shard_bundle(b, mesh)
    imgs = load(workdir, "tp_images.pkl")
    e, p = tfp.redux_prior(tp, imgs, ["", ""], [0.8, 1.0], [1.0, 1.0])
    noise = _t(load(workdir, "tp_noise.pkl"))
    kw = _gen_kw(guidance=2.5, seed=0, noise=noise)
    q = deploy.shard_bundle(port_bundle(workdir, "gen_q", False), mesh)
    qe, qp = (_t(x) for x in load(workdir, "gen_prior.pkl"))
    qnoise = _t(load(workdir, "q_noise.pkl"))
    common.set_int8_activations(True)
    try:
        w8a8 = tfp.generate(q, qe, qp, mesh=mesh,
                            **_gen_kw(steps=3, seed=[0, 1, 2], noise=qnoise))
    finally:
        common.set_int8_activations(False)
    out = {"prior": (e.numpy(), p.numpy()),
           "tp": tfp.generate(tp, e, p, mesh=mesh, **kw),
           "one": tfp.generate(b, e, p, **kw),
           "vcache": tfp.generate(tp, e, p, mesh=mesh,
                                  velocity_cache_interval=2,
                                  **_gen_kw(steps=4, seed=0, noise=noise)),
           "vcache_one": tfp.generate(b, e, p, velocity_cache_interval=2,
                                      **_gen_kw(steps=4, seed=0,
                                                noise=noise)),
           "w8a8": w8a8,
           "local_width": tp.flux_params["double"][0]["img_qkv"]["w"]
           .shape[1], "tp_mesh": tp.tp_mesh is mesh}
    if rank == 0:
        dump(workdir, "tp.pkl", out)


def _raises(fn):
    try:
        fn()
    except Exception as e:          # the error's type and text
        return type(e).__name__, str(e)
    return None


def serve_errors(rank, world, workdir):
    """The JAX package's errors, and the pipe stages rebuilt after the
    params are quantized."""
    from domainrag_tpu_torch.models import quant
    from domainrag_tpu_torch.models.flux import pipeline as tfp
    from domainrag_tpu_torch.parallel import deploy, mesh as mesh_mod
    pipe = mesh_mod.Mesh(np.arange(4), ("pipe",))
    data = mesh_mod.create_mesh(model_parallel=2)
    b = port_bundle(workdir, "gen", False)
    e, p = (_t(x) for x in load(workdir, "gen_prior.pkl"))
    kw = _gen_kw(seed=[0, 1, 2])
    out = {
        "pipe_without_axis": _raises(lambda: tfp.generate(
            b, e, p, mesh=data, pipe_axis="pipe", **kw)),
        "pipe_with_tp": _raises(lambda: tfp.generate(
            deploy.shard_bundle(b, data), e, p, mesh=pipe,
            pipe_axis="pipe", **kw)),
        "block_cache_under_pp": _raises(lambda: tfp.generate(
            b, e, p, mesh=pipe, pipe_axis="pipe", block_cache_interval=2,
            **kw)),
        "fill_pipe_without_axis": _raises(lambda: tfp.fill_batch(
            port_bundle(workdir, "fill", True), *fill_inputs(2),
            *(_t(x) for x in load(workdir, "fill_prior.pkl")),
            num_steps=2, seeds=[0, 1], mesh=data, pipe_axis="pipe")),
    }
    f = port_bundle(workdir, "fill", True)
    fe, fp_ = (_t(x) for x in load(workdir, "fill_prior.pkl"))
    images, masks = fill_inputs(2, seed=3)
    fkw = dict(num_steps=2, seeds=[7, 8], guidance=30.0, strength=0.7)
    tfp.fill_batch(f, images, masks, fe, fp_, mesh=pipe, pipe_axis="pipe",
                   **fkw)                           # populate the cache
    before = f._pp_stages[2]
    f.flux_params = quant.quantize_tree(f.flux_params, min_size=256)
    out["quantized_pp"] = tfp.fill_batch(f, images, masks, fe, fp_,
                                         mesh=pipe, pipe_axis="pipe", **fkw)
    out["quantized_one"] = tfp.fill_batch(f, images, masks, fe, fp_, **fkw)
    out["stages_rebuilt"] = f._pp_stages[2] is not before and any(
        "w_q" in blk.get("linear1", {}) for blk in f._pp_stages[2].singles)
    if rank == 0:
        dump(workdir, "errors.pkl", out)


# ---------------------------------------------------------------------------
# stages: the CLI and the orchestrator over a mesh, stage 3's sweep
# ---------------------------------------------------------------------------

def stages_cli(rank, world, workdir):
    """``pipeline --tiny-models`` over the group: --model_parallel 2 (a
    (1, 2) mesh), --pipeline_parallel 2 and the default (a data axis of
    2: the sharded bank, DP generate and compose)."""
    from domainrag_tpu_torch.cli import main as cli
    argv = load(workdir, "argv.pkl")
    for name, flags in (("mp2", ["--model_parallel", "2"]),
                        ("pp2", ["--pipeline_parallel", "2"]),
                        ("dp2", [])):
        assert cli.main(argv + flags + ["--output_dir",
                                        os.path.join(workdir, name)]) == 0
    if rank == 0:
        dump(workdir, "cli.pkl", True)


def stages_generate(rank, world, workdir):
    """Stage 3's ``process_dataset`` over a data mesh of 2, on the
    one-process run's stage-1 and stage-2 output."""
    import json

    from domainrag_tpu_torch.core.config import (FluxSamplingConfig,
                                                 GenerateConfig)
    from domainrag_tpu_torch.models.flux import pipeline as tfp
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    from domainrag_tpu_torch.stages import generate as gen_stage
    ref = os.path.join(workdir, "one")
    with open(os.path.join(ref, "retrieval_results",
                           "all_shots_retrieval_results.json")) as f:
        results = json.load(f)
    stage = gen_stage.GenerateStage(
        tfp.tiny_bundle(device="cpu"),
        GenerateConfig(sampling=FluxSamplingConfig(num_steps=2, height=32,
                                                   width=32, seed=0)))
    counters = gen_stage.process_dataset(
        stage, "NEU-DET", 1, results, os.path.join(ref, "lamainpaint"),
        os.path.join(workdir, "stage3"), run_name="run",
        mesh=mesh_mod.create_mesh())
    if rank == 0:
        dump(workdir, "stage3.pkl", counters)


# ---------------------------------------------------------------------------
# training over a mesh: DP, TP, FSDP, fit, the ring's gradient
# ---------------------------------------------------------------------------

# (name, model_parallel, fsdp, batch dtype) of the 4-rank train meshes: a
# bf16 batch trains in f32, as JAX's flow_match_loss promotes it
TRAIN_MESHES = (("data4", 1, False, "float32"),
                ("data2_model2", 2, False, "float32"),
                ("data4_fsdp", 1, True, "float32"),
                ("data2_model2_fsdp", 2, True, "float32"),
                ("data2_model2_fsdp_bf16", 2, True, "bfloat16"))
TRAIN_LANES = ("x0", "txt", "pooled")      # the batch keys in its dtype
TRAIN_LR = 1e-3


def train_batch(cfg, seed, batch=4, grid=4, s_txt=6):
    rng = np.random.default_rng(seed)
    from domainrag_tpu_torch.models.flux import model as flux
    return {"x0": rng.standard_normal((batch, grid * grid, cfg.in_channels))
            .astype(np.float32),
            "txt": rng.standard_normal((batch, s_txt, cfg.text_dim))
            .astype(np.float32),
            "pooled": rng.standard_normal((batch, cfg.pooled_dim))
            .astype(np.float32),
            "img_ids": flux.make_image_ids(grid, grid),
            "txt_ids": flux.make_text_ids(s_txt)}


def _train_steps(workdir, dtype="float32"):
    """The (batch, t, eps) of each step; a bf16 run's batch lanes hold
    bf16 values (stored as f32) and are cast to bf16 here."""
    import torch
    name = "train_steps.pkl" if dtype == "float32" else \
        f"train_steps_{dtype}.pkl"
    return [({k: _t(v).to(getattr(torch, dtype)) if k in TRAIN_LANES
              else _t(v) for k, v in b.items()}, _t(t), _t(e))
            for b, t, e in load(workdir, name)]


def _train_setup(workdir):
    from domainrag_tpu_torch import bridge
    from domainrag_tpu_torch.models.flux import model as flux
    from domainrag_tpu_torch.train import flow_match as flow
    cfg = flux.TINY_FLUX
    return (lambda: bridge.params(load(workdir, "tiny_flux.pkl"),
                                  device="cpu"),
            cfg, flow.TrainConfig(learning_rate=TRAIN_LR),
            _train_steps(workdir))


def train_meshes(rank, world, workdir):
    """make_sharded_train_step over each mesh of ``TRAIN_MESHES``: two
    steps from JAX's t and eps on batches of the mesh's dtype, then the
    whole tree gathered."""
    from domainrag_tpu_torch.parallel import mesh as mesh_mod, sharding
    from domainrag_tpu_torch.train import flow_match as flow
    fresh, cfg, train_cfg, _ = _train_setup(workdir)
    out = {}
    for name, mp, fsdp, dtype in TRAIN_MESHES:
        steps = _train_steps(workdir, dtype)
        mesh = mesh_mod.create_mesh(model_parallel=mp)
        params = fresh()
        step, local, opt, shardings = flow.make_sharded_train_step(
            mesh, cfg, train_cfg, params, fsdp=fsdp)
        losses = [step(local, opt, b, None, t=t, eps=e)[2].item()
                  for b, t, e in steps]
        whole = sharding.unshard_params(local, fresh(), mesh,
                                        fsdp_axis="data" if fsdp else None)
        out[name] = {"losses": losses, "params": np_tree(whole),
                     "rows": tuple(mesh_mod.local_rows(
                         steps[0][0][k], shardings[k]).shape[0]
                         for k in ("x0", "txt", "pooled", "img_ids"))}
    if rank == 0:
        dump(workdir, "train_meshes.pkl", out)


def train_tp_grads(rank, world, workdir):
    """The gradients of the loss on a (1, 4) mesh (each rank 1 of the 4
    heads and a quarter of every MLP), gathered, beside the errors: a
    split that keeps the attention whole (3 heads over 2 ranks) and an
    indivisible batch."""
    import torch
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.models.flux import model as flux
    from domainrag_tpu_torch.ops.attention import tp_attention
    from domainrag_tpu_torch.parallel import mesh as mesh_mod, sharding
    from domainrag_tpu_torch.train import flow_match as flow
    fresh, cfg, train_cfg, steps = _train_setup(workdir)
    mesh = mesh_mod.create_mesh(model_parallel=4)
    local = sharding.shard_params(fresh(), mesh)
    for p in flow.leaves(local):
        p.requires_grad_(True)
    b, t, e = steps[0]
    with tp_attention(mesh):
        loss = flow.flow_match_loss(local, b, None, cfg, train_cfg, t=t,
                                    eps=e)
        grads = torch.autograd.grad(loss, flow.leaves(local))
    it = iter(grads)
    tree = sharding._map_with_path(lambda _, x: next(it), local)
    out = {"loss": loss.item(),
           "grads": np_tree(sharding.unshard_params(tree, fresh(), mesh))}
    three = flux.FluxConfig(**dict(UNEVEN, hidden=48, heads=3))
    odd = flux.init(prng.PRNGKey(0), three)
    out["whole_attention"] = _raises(lambda: flow.make_sharded_train_step(
        mesh_mod.create_mesh(model_parallel=2), three, train_cfg, odd))
    step, local, opt, _ = flow.make_sharded_train_step(
        mesh_mod.create_mesh(), cfg, train_cfg, fresh())
    odd_batch = {k: v[:3] if k in ("x0", "txt", "pooled") else v
                 for k, v in b.items()}
    out["indivisible_batch"] = _raises(lambda: step(
        local, opt, odd_batch, None, t=t[:3], eps=e[:3]))
    if rank == 0:
        dump(workdir, "train_tp_grads.pkl", out)


def train_fit(rank, world, workdir):
    """fit(model_parallel=2, fsdp=True) over the group: a (2, 2) mesh,
    three steps, a checkpoint every two."""
    from domainrag_tpu_torch.train import flow_match as flow
    from domainrag_tpu_torch.train import loop
    fresh, cfg, train_cfg, _ = _train_setup(workdir)
    batches = [{k: _t(v) for k, v in b.items()}
               for b in load(workdir, "fit_batches.pkl")]
    final, losses = loop.fit(fresh(), cfg, batches, 3, train_cfg,
                             model_parallel=2, fsdp=True,
                             checkpoint_dir=os.path.join(workdir, "ckpt"),
                             checkpoint_every=2)
    if rank == 0:
        dump(workdir, "train_fit.pkl", {"losses": losses,
                                        "params": np_tree(final)})


def train_ring(rank, world, workdir):
    """The gradients of sum(ring(q, k, v)^2) over the 4-rank data axis,
    a ragged 50-token sequence, and the heads over a second axis."""
    import torch
    from domainrag_tpu_torch.ops import ring_attention as ring
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    out = {}
    for name, shape, mp, fn in RING_GRAD_CASES:
        mesh = mesh_mod.create_mesh(model_parallel=mp)
        q, k, v = (_t(x).requires_grad_(True)
                   for x in qkv(*RING_GRAD_SEEDS[name], shape))
        kw = {"head_axis": "model"} if mp > 1 else {}
        o = getattr(ring, fn)(q, k, v, mesh, axis="data", **kw)
        grads = torch.autograd.grad(o.square().sum(), (q, k, v))
        out[name] = [g.numpy() for g in grads]
    if rank == 0:
        dump(workdir, "ring_grad.pkl", out)


# (name, shape, model_parallel, function) of the ring's gradient cases
RING_GRAD_CASES = (("dense", (1, 2, 64, 16), 1, "ring_attention"),
                   ("ragged", (1, 2, 50, 16), 1, "ring_attention_padded"),
                   ("heads", (1, 4, 64, 16), 2, "ring_attention"))
RING_GRAD_SEEDS = {"dense": (20,), "ragged": (21,), "heads": (22,)}


# ---------------------------------------------------------------------------
# --distributed workers of several processes each
# ---------------------------------------------------------------------------

def workers_cli(rank, world, workdir):
    """``pipeline --stages retrieve,generate --distributed`` on 4 processes
    as 2 workers (hosts) of 2 (``LOCAL_WORLD_SIZE=2``), on stage 1's
    output: each worker's mesh a data axis of 2, then a model axis of 2
    (``--model_parallel 2``)."""
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    from domainrag_tpu_torch.cli import main as cli
    from domainrag_tpu_torch.parallel import multihost
    argv = load(workdir, "argv.pkl")
    seen = (multihost.worker_index(), multihost.worker_count(),
            multihost.local_size())
    for name, flags in (("workers", []),
                        ("workers_mp2", ["--model_parallel", "2"])):
        assert cli.main(argv + flags + [
            "--stages", "retrieve,generate", "--distributed",
            "--output_dir", os.path.join(workdir, name)]) == 0
    dump(workdir, f"workers.r{rank}.pkl", seen)
    if rank == 0:
        dump(workdir, "workers.pkl", True)


SUITES = {"ops": [("topk", ops_topk), ("ring", ops_ring),
                  ("tp_attention", ops_tp_attention),
                  ("tp_forward", ops_tp_forward), ("pp", ops_pp),
                  ("pp_schedule", ops_pp_schedule),
                  ("multihost", ops_multihost)],
          "serve": [("dp", serve_dp), ("dp_stage", serve_dp_stage),
                    ("pp_serve", serve_pp), ("sp", serve_sp),
                    ("tp", serve_tp), ("errors", serve_errors)],
          "stages": [("cli", stages_cli), ("stage3", stages_generate)],
          "train": [("train_meshes", train_meshes),
                    ("train_tp_grads", train_tp_grads),
                    ("train_fit", train_fit), ("ring_grad", train_ring)],
          "workers": [("workers", workers_cli)]}
