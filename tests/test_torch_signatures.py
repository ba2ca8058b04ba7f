"""The port's ``generate`` and ``fill_batch`` take the JAX package's
parameters (``domainrag_tpu/models/flux/pipeline.py``): the same names in
the same order with the same defaults, up to the JAX function's last
parameter, so that a call written for the JAX package binds the same
values in the port. The port's own ``noise`` and ``timer`` come after, and
only by keyword. The scale-out functions (``parallel/``,
``ops/ring_attention.py``, the contexts and W8A8 toggles, the stage's
``generate_samples_dp``, the trainer's ``make_sharded_train_step``)
take the JAX parameters too."""

import inspect

import numpy as np
import pytest
import torch

from domainrag_tpu.models.flux import pipeline as jfp
from domainrag_tpu_torch.models.flux import pipeline as tfp

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

FUNCS = ["generate", "fill_batch"]
SIZE = 32


def _params(fn):
    return list(inspect.signature(fn).parameters.values())


@pytest.mark.parametrize("name", FUNCS)
def test_parameters_match_jax(name):
    jax_params = _params(getattr(jfp, name))
    port = _params(getattr(tfp, name))[:len(jax_params)]
    assert [p.name for p in port] == [p.name for p in jax_params]
    assert [p.default for p in port] == [p.default for p in jax_params]
    assert all(p.kind is p.POSITIONAL_OR_KEYWORD for p in port)


@pytest.mark.parametrize("name", FUNCS)
def test_port_only_parameters_are_keyword_only(name):
    n_jax = len(_params(getattr(jfp, name)))
    extra = _params(getattr(tfp, name))[n_jax:]
    assert [p.name for p in extra] == ["noise", "timer"]
    assert all(p.kind is p.KEYWORD_ONLY for p in extra)


@pytest.fixture(scope="module")
def bundle():
    return tfp.tiny_bundle(device="cpu"), tfp.tiny_bundle(device="cpu",
                                                          fill=True)


def _cond(b, n=1):
    g = torch.Generator().manual_seed(4)
    cfg = b.flux_cfg
    return (torch.randn((n, 8, cfg.text_dim), generator=g),
            torch.randn((n, cfg.pooled_dim), generator=g))


def _fill_images(n=1):
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    masks = np.zeros((n, SIZE, SIZE), np.uint8)
    masks[:, 8:24, 4:20] = 255
    return images, masks


def test_generate_jax_order_positional_call(bundle):
    """mesh=None and data_axis="data" by position, as a JAX caller writes
    them: the port binds them as JAX does and matches the keyword call."""
    b = bundle[0]
    e, p = _cond(b)
    by_position = tfp.generate(b, e, p, SIZE, SIZE, 1, 2.5, 3, None, None,
                               "data")
    by_keyword = tfp.generate(b, e, p, height=SIZE, width=SIZE, num_steps=1,
                              guidance=2.5, seed=3)
    assert by_position.shape == (SIZE, SIZE, 3)
    np.testing.assert_array_equal(by_position, by_keyword)


def test_fill_batch_jax_order_positional_call(bundle):
    b = bundle[1]
    e, p = _cond(b)
    images, masks = _fill_images()
    by_position = tfp.fill_batch(b, images, masks, e, p, 2, 30.0, 1.0, [3],
                                 None, "data")
    by_keyword = tfp.fill_batch(b, images, masks, e, p, num_steps=2,
                                guidance=30.0, strength=1.0, seeds=[3])
    assert by_position.shape == (1, SIZE, SIZE, 3)
    np.testing.assert_array_equal(by_position, by_keyword)


@pytest.mark.parametrize("kwargs", [dict(microbatches=2),
                                    dict(velocity_cache_order=2)],
                         ids=["microbatches", "velocity_cache_order"])
@pytest.mark.parametrize("name", FUNCS)
def test_unported_values_raise(bundle, name, kwargs):
    """``microbatches`` without a pipe axis is not read, as in the JAX
    package: the image is the one without it. Every
    ``velocity_cache_order`` is read as the JAX package reads it: any
    order >= 1 extrapolates linearly, so order 2 under an interval-2 cache
    gives order 1's image."""
    if name == "generate":
        b = bundle[0]
        e, p = _cond(b)
        call = lambda **kw: tfp.generate(b, e, p, height=SIZE,  # noqa
                                         width=SIZE, num_steps=3, **kw)
    else:
        b = bundle[1]
        e, p = _cond(b)
        images, masks = _fill_images()
        call = lambda **kw: tfp.fill_batch(  # noqa: E731
            b, images, masks, e, p, num_steps=3, strength=1.0, **kw)
    if "microbatches" in kwargs:
        np.testing.assert_array_equal(call(**kwargs), call())
        return
    np.testing.assert_array_equal(
        call(velocity_cache_interval=2, **kwargs),
        call(velocity_cache_interval=2, velocity_cache_order=1))


# ---------------------------------------------------------------------------
# the stage entry points of stages 1 and 3, the checkpoint loaders, the
# orchestrator and the export
# ---------------------------------------------------------------------------

def _stage_funcs():
    from domainrag_tpu.stages import generate as jgen
    from domainrag_tpu.stages import inpaint as jinp
    from domainrag_tpu_torch.stages import generate as tgen
    from domainrag_tpu_torch.stages import inpaint as tinp
    return {
        "generate_sample": (jgen.GenerateStage.generate_sample,
                            tgen.GenerateStage.generate_sample, []),
        "generate.process_dataset": (jgen.process_dataset,
                                     tgen.process_dataset, ["timer"]),
        "generate.process_dataset_legacy": (jgen.process_dataset_legacy,
                                            tgen.process_dataset_legacy, []),
        "inpaint.process_dataset": (jinp.process_dataset,
                                    tinp.process_dataset, []),
        "inpaint.run_inpaint": (jinp.run_inpaint, tinp.run_inpaint, []),
        "LamaRunner.__init__": (jinp.LamaRunner.__init__,
                                tinp.LamaRunner.__init__, ["device"]),
        **_entry_funcs(),
    }


def _entry_funcs():
    """The checkpoint loaders, the orchestrator and the export."""
    from domainrag_tpu.models import clip as jclip
    from domainrag_tpu.models import convert as jconv
    from domainrag_tpu.models import redux as jredux
    from domainrag_tpu.models import siglip as jsiglip
    from domainrag_tpu.models import t5 as jt5
    from domainrag_tpu.pipeline import export as jexp
    from domainrag_tpu.pipeline import orchestrator as jorch
    from domainrag_tpu_torch.models import clip as tclip
    from domainrag_tpu_torch.models import convert as tconv
    from domainrag_tpu_torch.models import redux as tredux
    from domainrag_tpu_torch.models import siglip as tsiglip
    from domainrag_tpu_torch.models import t5 as tt5
    from domainrag_tpu_torch.pipeline import export as texp
    from domainrag_tpu_torch.pipeline import orchestrator as torch_orch
    out = {
        "load_flux_bundle": (jconv.load_flux_bundle, tconv.load_flux_bundle,
                             ["device"]),
        "build_runner_from_checkpoints": (
            jconv.build_runner_from_checkpoints,
            tconv.build_runner_from_checkpoints, ["device"]),
        "load_safetensors_dir": (jconv.load_safetensors_dir,
                                 tconv.load_safetensors_dir, []),
        "convert_flux_transformer": (jconv.convert_flux_transformer,
                                     tconv.convert_flux_transformer,
                                     ["device", "dtype"]),
        "convert_flux_vae": (jconv.convert_flux_vae, tconv.convert_flux_vae,
                             ["device"]),
        "convert_lama": (jconv.convert_lama, tconv.convert_lama, ["device"]),
        "convert_hf_clip_vision": (jclip.convert_hf_clip_vision,
                                   tclip.convert_hf_clip_vision, ["device"]),
        "convert_hf_clip_text": (jclip.convert_hf_clip_text,
                                 tclip.convert_hf_clip_text, ["device"]),
        "convert_hf_t5": (jt5.convert_hf_t5, tt5.convert_hf_t5, ["device"]),
        "convert_hf_siglip": (jsiglip.convert_hf_siglip,
                              tsiglip.convert_hf_siglip, ["device"]),
        "convert_hf_redux": (jredux.convert_hf_redux,
                             tredux.convert_hf_redux, ["device"]),
        "build_tiny_runner": (jorch.build_tiny_runner,
                              torch_orch.build_tiny_runner, ["device"]),
        "export_synthetic_coco": (jexp.export_synthetic_coco,
                                  texp.export_synthetic_coco, []),
    }
    for name in ("run_inpaint", "run_retrieve", "run_generate",
                 "run_generate_legacy", "run_compose", "run"):
        out[f"PipelineRunner.{name}"] = (
            getattr(jorch.PipelineRunner, name),
            getattr(torch_orch.PipelineRunner, name), [])
    return out


STAGE_FUNCS = sorted(_stage_funcs())


@pytest.mark.parametrize("name", STAGE_FUNCS)
def test_stage_parameters_match_jax(name):
    """The JAX names in the JAX order with the JAX defaults (a compute
    dtype is each framework's float32 / bfloat16), then only the port's
    own keyword-only parameters."""
    import jax.numpy as jnp
    jax_fn, port_fn, extra = _stage_funcs()[name]
    jax_params = _params(jax_fn)
    port = _params(port_fn)
    assert [p.name for p in port[:len(jax_params)]] == \
        [p.name for p in jax_params]
    as_jax = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    assert [as_jax.get(p.default, p.default)
            for p in port[:len(jax_params)]] == \
        [p.default for p in jax_params]
    assert all(p.kind is p.POSITIONAL_OR_KEYWORD
               for p in port[:len(jax_params)])
    rest = port[len(jax_params):]
    assert [p.name for p in rest] == extra
    assert all(p.kind is p.KEYWORD_ONLY for p in rest)


# ---------------------------------------------------------------------------
# the denoise caches, their calibrations, eval/ and native/
# ---------------------------------------------------------------------------

def _cache_eval_funcs():
    from domainrag_tpu.eval import fid as jfid
    from domainrag_tpu.eval import flops as jflops
    from domainrag_tpu.models.flux import model as jflux
    from domainrag_tpu.native import build as jnative
    from domainrag_tpu_torch.eval import fid as tfid
    from domainrag_tpu_torch.eval import flops as tflops
    from domainrag_tpu_torch.models.flux import model as tflux
    from domainrag_tpu_torch.native import build as tnative
    out = {
        "init_block_cache": (jflux.init_block_cache, tflux.init_block_cache,
                             ["device"]),
        "apply_with_cache": (jflux.apply_with_cache, tflux.apply_with_cache,
                             []),
        "calibrate_block_cache_interval": (
            jfp.calibrate_block_cache_interval,
            tfp.calibrate_block_cache_interval, ["probe_noise"]),
        "calibrate_vcache_schedule": (jfp.calibrate_vcache_schedule,
                                      tfp.calibrate_vcache_schedule,
                                      ["probe_noise"]),
        "calibrate_fill_vcache": (jfp.calibrate_fill_vcache,
                                  tfp.calibrate_fill_vcache, []),
    }
    for name in ("plan_vcache_anchors", "select_vcache_anchors"):
        out[name] = (getattr(jfp, name), getattr(tfp, name), [])
    for mod, jm, tm in (("flops", jflops, tflops), ("fid", jfid, tfid),
                        ("native", jnative, tnative)):
        names = {"flops": ("flux_forward_flops", "mfu"),
                 "fid": ("compute_stats", "frechet_distance",
                         "fid_from_features", "fid_from_paths"),
                 "native": ("load_native", "native_available",
                            "topk_ip_native", "resize_native",
                            "resize_batch_native")}[mod]
        for name in names:
            out[f"{mod}.{name}"] = (getattr(jm, name), getattr(tm, name), [])
    return out


CACHE_EVAL_FUNCS = sorted(_cache_eval_funcs())


@pytest.mark.parametrize("name", CACHE_EVAL_FUNCS)
def test_cache_and_eval_parameters_match_jax(name):
    """The new public functions take the JAX names in the JAX order, of
    the same kinds, with the JAX defaults (a dtype is each framework's
    bfloat16; ``mfu``'s default peak is the card's, not a TPU's), then
    only the port's own keyword-only parameters."""
    import jax.numpy as jnp
    jax_fn, port_fn, extra = _cache_eval_funcs()[name]
    jax_params = _params(jax_fn)
    port = _params(port_fn)
    head = port[:len(jax_params)]
    assert [(p.name, p.kind) for p in head] == \
        [(p.name, p.kind) for p in jax_params]
    as_jax = {torch.bfloat16: jnp.bfloat16}
    defaults = [as_jax.get(p.default, p.default) for p in head]
    want = [p.default for p in jax_params]
    if name == "flops.mfu":
        assert defaults[-1] == 989.0
        defaults, want = defaults[:-1], want[:-1]
    assert defaults == want
    rest = port[len(jax_params):]
    assert [p.name for p in rest] == extra
    assert all(p.kind is p.KEYWORD_ONLY for p in rest)


# ---------------------------------------------------------------------------
# scale-out
# ---------------------------------------------------------------------------

def _scale_out_funcs():
    from domainrag_tpu.ops import attention as jattn
    from domainrag_tpu.ops import int8_gemm as jgemm
    from domainrag_tpu.ops import ring_attention as jring
    from domainrag_tpu.parallel import collectives as jcoll
    from domainrag_tpu.parallel import deploy as jdeploy
    from domainrag_tpu.parallel import mesh as jmesh
    from domainrag_tpu.parallel import multihost as jmh
    from domainrag_tpu.parallel import pipeline_parallel as jpp
    from domainrag_tpu.parallel import sharding as jsharding
    from domainrag_tpu.stages import generate as jgen
    from domainrag_tpu.train import flow_match as jflow
    from domainrag_tpu_torch.ops import attention as tattn
    from domainrag_tpu_torch.ops import int8_gemm as tgemm
    from domainrag_tpu_torch.ops import ring_attention as tring
    from domainrag_tpu_torch.parallel import collectives as tcoll
    from domainrag_tpu_torch.parallel import deploy as tdeploy
    from domainrag_tpu_torch.parallel import mesh as tmesh
    from domainrag_tpu_torch.parallel import multihost as tmh
    from domainrag_tpu_torch.parallel import pipeline_parallel as tpp
    from domainrag_tpu_torch.parallel import sharding as tsharding
    from domainrag_tpu_torch.stages import generate as tgen
    from domainrag_tpu_torch.train import flow_match as tflow
    names = {
        "mesh": (jmesh, tmesh, ("initialize_distributed", "create_mesh",
                                "replicated", "data_sharded")),
        "sharding": (jsharding, tsharding, ("flux_param_specs",
                                            "shard_params",
                                            "validate_divisibility")),
        "collectives": (jcoll, tcoll, ("pad_bank_for_mesh", "sharded_topk",
                                       "shard_bank")),
        "deploy": (jdeploy, tdeploy, ("shard_bundle",)),
        "ring": (jring, tring, ("ring_attention", "ring_attention_padded")),
        "pp": (jpp, tpp, ("prepare_stages", "pipelined_apply")),
        "multihost": (jmh, tmh, ("is_distributed", "process_index",
                                 "process_count", "barrier",
                                 "shared_timestamp")),
        "attention": (jattn, tattn, ("tp_attention", "sp_attention")),
        "int8_gemm": (jgemm, tgemm, ("set_w8a8_pallas",
                                     "disable_pallas_w8a8",
                                     "w8a8_pallas_enabled")),
        "generate": (jgen, tgen, ("generate_samples_dp",)),
        "flow_match": (jflow, tflow, ("make_sharded_train_step",)),
    }
    extra = {"mesh.initialize_distributed": ["device"],
             "collectives.shard_bank": ["device"],
             "pp.pipelined_apply": ["schedule"]}
    return {f"{mod}.{n}": (getattr(jm, n), getattr(tm, n),
                           extra.get(f"{mod}.{n}", []))
            for mod, (jm, tm, ns) in names.items() for n in ns}


SCALE_OUT_FUNCS = sorted(_scale_out_funcs())


@pytest.mark.parametrize("name", SCALE_OUT_FUNCS)
def test_scale_out_parameters_match_jax(name):
    """The JAX names in the JAX order, of the same kinds, with the JAX
    defaults, then only the port's own keyword-only parameters."""
    jax_fn, port_fn, extra = _scale_out_funcs()[name]
    jax_params = _params(jax_fn)
    port = _params(port_fn)
    head = port[:len(jax_params)]
    assert [(p.name, p.kind, p.default) for p in head] == \
        [(p.name, p.kind, p.default) for p in jax_params]
    rest = port[len(jax_params):]
    assert [p.name for p in rest] == extra
    assert all(p.kind is p.KEYWORD_ONLY for p in rest)


def test_w8a8_toggles_route_like_jax():
    """The JAX toggles keep their state as the JAX ones do. Off, a CPU
    tensor still takes the plain version (bitwise the same numbers, as
    always on the CPU), and a tensor off the CPU (here ``meta``, standing
    in for the card) raises instead of leaving B4 for the plain version."""
    from domainrag_tpu_torch.ops import int8_gemm as tgemm
    assert tgemm.w8a8_pallas_enabled()
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    w_q = torch.randint(-127, 128, (16, 32), dtype=torch.int8,
                        generator=torch.Generator().manual_seed(1))
    w_s = torch.rand(16, generator=torch.Generator().manual_seed(2))
    want = tgemm.w8a8_linear(x, w_q, w_s)
    xm, w_qm, w_sm = (t.to("meta") for t in (x, w_q, w_s))
    launches = tgemm.w8a8_linear.launches
    with tgemm.disable_pallas_w8a8():
        assert torch.equal(tgemm.w8a8_linear(x, w_q, w_s), want)
        with pytest.raises(RuntimeError, match="only route"):
            tgemm.w8a8_linear(xm, w_qm, w_sm)
    assert tgemm.w8a8_pallas_enabled()
    tgemm.set_w8a8_pallas(False)
    try:
        assert not tgemm.w8a8_pallas_enabled()
        assert torch.equal(tgemm.w8a8_linear(x, w_q, w_s), want)
        with pytest.raises(RuntimeError, match="only route"):
            tgemm.w8a8_linear(xm, w_qm, w_sm)
    finally:
        tgemm.set_w8a8_pallas(True)
    assert tgemm.w8a8_linear.launches == launches
