"""The port's scale-out operations against the JAX package's sharded
functions on its 8-device CPU mesh.

The port side runs in one gloo group of four spawned processes
(``torch_scaleout_driver``, suite ``ops``), started once for this file;
the JAX side runs here. Tolerances are the JAX package's own tests':
- sharded top-k (``tests/test_parallel.py:31-54``): indices
  ``array_equal``, ties included, scores rtol 1e-6;
- ring attention, ragged padded and with the heads over a second axis
  (``tests/test_ring_attention.py:17-33``): rtol = atol = 2e-5;
- TP attention and its indivisible-heads fallback
  (``tests/test_tp_attention.py``): 2e-5; the TP Flux forward
  (``tests/test_parallel.py:75-100``): rtol 5e-4, atol 5e-5;
- pipelined apply (``tests/test_pipeline_parallel.py:34-111``) at S = 2
  and, with uneven depths, S = 4: rtol 2e-4, atol 3e-6 of JAX's
  ``pipelined_apply``, and ``torch.equal`` to the port's own ``apply``
  at one microbatch (a split batch runs each block's GEMMs at fewer rows,
  whose CPU summation order may differ in the last bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

import torch_scaleout_driver as drv
from domainrag_tpu.models.flux import model as jflux
from domainrag_tpu.ops import attention as jattn
from domainrag_tpu.ops import ring_attention as jring
from domainrag_tpu.ops import topk as jtopk
from domainrag_tpu.parallel import collectives as jcoll
from domainrag_tpu.parallel import mesh as jmesh
from domainrag_tpu.parallel import pipeline_parallel as jpp
from domainrag_tpu.parallel import sharding as jsharding
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.parallel import mesh as tmesh
from domainrag_tpu_torch.parallel import pipeline_parallel as tpp
from domainrag_tpu_torch.parallel import sharding as tsharding

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The ``ops`` suite run once in four gloo processes; its directory."""
    work = str(tmp_path_factory.mktemp("scaleout_ops"))
    drv.dump(work, "tiny_flux.pkl", _np_tree(
        jflux.init(jax.random.PRNGKey(0), jflux.TINY_FLUX)))
    drv.dump(work, "uneven_flux.pkl", _np_tree(
        jflux.init(jax.random.PRNGKey(1), jflux.FluxConfig(**drv.UNEVEN))))
    drv.launch(work, 4, "ops")
    return work


@pytest.fixture(scope="module")
def mesh8():
    return jmesh.create_mesh(model_parallel=1)


@pytest.fixture(scope="module")
def mesh_tp():
    return jmesh.create_mesh(model_parallel=2)


@pytest.mark.parametrize("case", ["odd", "ties"])
def test_sharded_topk_matches_jax(group, mesh8, case):
    got = drv.result(group, "topk")
    q, bank, k = drv.topk_inputs()[["odd", "ties"].index(case)]
    padded, n_valid = jcoll.pad_bank_for_mesh(bank, mesh8)
    s, i = jcoll.sharded_topk(jnp.asarray(q),
                              jcoll.shard_bank(padded, mesh8), k, mesh8,
                              n_valid)
    oracle_s, oracle_i = jtopk.topk_ip_numpy(q, bank, k)
    for use_pallas in (False, True):
        gs, gi, n_pad, rows = got[(case, use_pallas)]
        assert n_pad % 4 == 0 and rows == n_pad // 4
        np.testing.assert_array_equal(gi, np.asarray(i))
        np.testing.assert_array_equal(gi, oracle_i)
        np.testing.assert_allclose(gs, np.asarray(s), rtol=1e-6)
        np.testing.assert_allclose(gs, oracle_s, rtol=1e-6)


@pytest.mark.parametrize("case", ["dense", "ragged", "heads"])
def test_ring_attention_matches_jax(group, mesh8, case):
    got = drv.result(group, "ring")[case]
    if case == "dense":
        q, k, v = (jnp.asarray(x) for x in drv.qkv(0, (1, 2, 64, 16)))
        want = jring.ring_attention(q, k, v, mesh8)
    elif case == "ragged":
        q, k, v = (jnp.asarray(x) for x in drv.qkv(1, (1, 1, 50, 8)))
        want = jring.ring_attention_padded(q, k, v, mesh8)
    else:
        q, k, v = (jnp.asarray(x) for x in drv.qkv(2, (1, 4, 64, 16)))
        want = jring.ring_attention(q, k, v,
                                    jmesh.create_mesh(model_parallel=2),
                                    axis="data", head_axis="model")
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(jattn.attention_reference(
        q, k, v)), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["split", "indivisible"])
def test_tp_attention_matches_jax(group, mesh_tp, case):
    got = drv.result(group, "tp_attention")[case]
    if case == "split":
        q, k, v = (jnp.asarray(x) for x in drv.qkv(3, (1, 4, 32, 16)))
    else:
        q = k = v = jnp.asarray(drv.qkv(4, (1, 3, 16, 8), 1)[0])
    with jattn.tp_attention(mesh_tp):
        want = np.asarray(jattn.attention(q, k, v))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_flux_tp_forward_matches_jax(group, mesh_tp):
    """The port's Megatron split on a (2, 2) mesh against JAX's GSPMD
    forward with TP params and head-sharded attention; rank (d, m) holds
    its heads of q, k and v (h/2 of each of the fused 3h lanes) and half
    of the single block's MLP hidden."""
    got = drv.result(group, "tp_forward")
    cfg = jflux.TINY_FLUX
    params = jflux.init(jax.random.PRNGKey(0), cfg)
    img, txt, pooled, t, g = (jnp.asarray(x)
                              for x in drv.flux_inputs(cfg, 2))
    iid = jnp.asarray(jflux.make_image_ids(4, 4))
    tid = jnp.asarray(jflux.make_text_ids(6))
    sharded = jsharding.shard_params(
        params, mesh_tp, jsharding.flux_param_specs(params))
    with jattn.tp_attention(mesh_tp):
        fn = jax.jit(lambda p, *a: jflux.apply(p, *a, cfg, guidance=g))
        want = np.asarray(fn(sharded, img, txt, pooled, t, iid, tid))
    np.testing.assert_allclose(got["out"], want, rtol=5e-4, atol=5e-5)
    h, mh = cfg.hidden, cfg.mlp_hidden
    assert got["widths"] == ((h, 3 * h // 2), (h, (3 * h + mh) // 2),
                             ((h + mh) // 2, h))


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipelined_apply_matches_jax(group, n_stages):
    got = drv.result(group, "pp")[n_stages]
    if n_stages == 2:
        cfg, key, batch, micro = jflux.TINY_FLUX, 0, 4, 4
    else:
        cfg, key, batch, micro = jflux.FluxConfig(**drv.UNEVEN), 1, 2, 2
    params = jflux.init(jax.random.PRNGKey(key), cfg)
    img, txt, pooled, t, g = (jnp.asarray(x)
                              for x in drv.flux_inputs(cfg, batch))
    iid = jnp.asarray(jflux.make_image_ids(4, 4))
    tid = jnp.asarray(jflux.make_text_ids(6))
    stages = jpp.prepare_stages(params, n_stages)
    want = np.asarray(jpp.pipelined_apply(
        params, stages, img, txt, pooled, t, iid, tid, cfg,
        mesh=JMesh(np.array(jax.devices()[:n_stages]), ("pipe",)),
        guidance=g, microbatches=micro))
    np.testing.assert_allclose(got["out"], want, rtol=2e-4, atol=3e-6)
    np.testing.assert_allclose(got["apply"], want, rtol=2e-4, atol=3e-6)
    assert got["equal_apply"][1]
    d, g_ = stages.per_stage_double, stages.per_stage_single
    assert got["chunks"] == (d, g_, d, g_)


def _pp_schedule(group):
    drv.result(group, "pp")             # the suite ran through this point
    got = {}
    for r in range(4):
        got.update(drv.load(group, f"pp_schedule.r{r}.pkl"))
    return got


@pytest.mark.parametrize("m", drv.PP_MICRO)
@pytest.mark.parametrize("case", drv.PP_SCHEDULES, ids=["S2", "S4"])
def test_interleaved_schedule(group, case, m):
    """JAX's M + 2S-step ring: every rank's output torch.equal to the
    serial chain and within the JAX test's tolerance of JAX's
    ``pipelined_apply``; rank s runs its double chunk on microbatch t - s
    and its single chunk on t - S - s at step t, so that rank s + 1 works
    on m - 1 while rank s works on m, and the last chunk runs at step
    M + 2S - 2 (the finished microbatch reaches rank 0 in the last)."""
    n, cfg_kw, batch = case
    got = _pp_schedule(group)
    cfg = jflux.TINY_FLUX if cfg_kw is None else jflux.FluxConfig(**cfg_kw)
    params = jflux.init(jax.random.PRNGKey(0 if cfg_kw is None else 1), cfg)
    img, txt, pooled, t, g = (jnp.asarray(x)
                              for x in drv.flux_inputs(cfg, batch))
    want = np.asarray(jpp.pipelined_apply(
        params, jpp.prepare_stages(params, n), img, txt, pooled, t,
        jnp.asarray(jflux.make_image_ids(4, 4)),
        jnp.asarray(jflux.make_text_ids(6)), cfg,
        mesh=JMesh(np.array(jax.devices()[:n]), ("pipe",)), guidance=g,
        microbatches=m))
    for r in range(n):
        res = got[(n, m, r)]
        assert res["equal_serial"]
        np.testing.assert_allclose(res["out"], want, rtol=2e-4, atol=3e-6)
        assert res["steps"] == sorted(
            [(r + i, "double", i) for i in range(m)]
            + [(n + r + i, "single", i) for i in range(m)])
    last = max(step for r in range(n) for step, _, _ in got[(n, m, r)]
               ["steps"])
    assert last == m + 2 * n - 2
    if m > 1:       # stages overlap: rank 1 on m - 1 while rank 0 is on m
        at = {(r, step): mb for r in range(n)
              for step, kind, mb in got[(n, m, r)]["steps"]
              if kind == "double"}
        assert at[(0, 1)] == 1 and at[(1, 1)] == 0


def test_multihost_through_the_group(group):
    seen = drv.result(group, "multihost")
    assert [s[:3] for s in seen] == [(True, r, 4) for r in range(4)]
    assert len({s[3] for s in seen}) == 1     # rank 0's clock everywhere


# ---------------------------------------------------------------------------
# without a group
# ---------------------------------------------------------------------------

def test_one_process_mesh_and_multihost():
    """A process without a group: a one-rank mesh whose collectives return
    their input, and multihost's single-process answers."""
    from domainrag_tpu_torch.parallel import multihost
    mesh = tmesh.create_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.is_writer()
    x = torch.arange(6.0).reshape(2, 3)
    assert mesh.all_reduce(x, "data") is x
    assert mesh.all_gather(x, "model") is x
    assert mesh.broadcast(x, "data") is x
    assert tmesh.data_sharded(mesh).spec == tmesh.P("data")
    assert tmesh.replicated(mesh).spec == tmesh.P()
    with pytest.raises(ValueError, match="not divisible by TP"):
        tmesh.create_mesh(model_parallel=3)
    with pytest.raises(ValueError, match="process group"):
        tmesh.create_mesh(devices=[0, 1])
    assert (multihost.is_distributed(), multihost.process_index(),
            multihost.process_count()) == (False, 0, 1)
    multihost.barrier("alone")
    assert len(multihost.shared_timestamp()) == 15


def test_flux_param_specs_match_jax():
    """The specs tree is the JAX package's, with and without FSDP, on a
    float and on an int8 tree."""
    from domainrag_tpu.models import quant as jquant
    params = jflux.init(jax.random.PRNGKey(0), jflux.TINY_FLUX)
    for tree in (params, jquant.quantize_tree(params, min_size=1024)):
        port_tree = bridge.params(_np_tree(tree), device="cpu")
        for fsdp in (None, "data"):
            want = jax.tree.leaves(
                jsharding.flux_param_specs(tree, fsdp_axis=fsdp),
                is_leaf=lambda x: isinstance(x, JP))
            got = jax.tree.leaves(
                tsharding.flux_param_specs(port_tree, fsdp_axis=fsdp),
                is_leaf=lambda x: isinstance(x, tmesh.P))
            assert [tuple(s) for s in got] == [tuple(s) for s in want]


def test_shard_params_splits_by_segment():
    """On a two-rank mesh the fused qkv keeps each rank's heads of q, of k
    and of v; linear1 its heads and MLP slice; linear2 the same rows; the
    int8 w_q (K-major) and w_s follow; with FSDP over a data axis of 2
    the other 2-d leaves are cut along dim 0 (JAX's rule) and the TP
    shares are unchanged."""
    from domainrag_tpu_torch.models import quant as tquant

    class TwoRanks:                    # a rank of a 2-way model axis
        shape = {"data": 1, "model": 2}

        def __init__(self, r):
            self.r = r

        def index(self, axis):
            return self.r if axis == "model" else 0

    params = bridge.params(_np_tree(jflux.init(jax.random.PRNGKey(0),
                                               jflux.TINY_FLUX)),
                           device="cpu")
    h = jflux.TINY_FLUX.hidden
    q8 = tquant.quantize_tree(params, min_size=1024)
    for r in (0, 1):
        local = tsharding.shard_params(params, TwoRanks(r))
        w = params["double"][0]["img_qkv"]["w"]
        lw = local["double"][0]["img_qkv"]["w"]
        half = h // 2
        for seg in range(3):
            assert torch.equal(
                lw[:, seg * half:(seg + 1) * half],
                w[:, seg * h + r * half:seg * h + (r + 1) * half])
        l2 = params["single"][0]["linear2"]["w"]
        ll2 = local["single"][0]["linear2"]["w"]
        assert torch.equal(ll2[:half], l2[r * half:(r + 1) * half])
        assert torch.equal(local["single"][0]["linear2"]["b"],
                           params["single"][0]["linear2"]["b"])
        lq = tsharding.shard_params(q8, TwoRanks(r))
        wq = q8["double"][0]["img_mlp2"]["w_q"]          # (out, in)
        mh = wq.shape[1] // 2
        assert torch.equal(lq["double"][0]["img_mlp2"]["w_q"],
                           wq[:, r * mh:(r + 1) * mh])
        assert torch.equal(lq["double"][0]["img_mlp2"]["w_s"],
                           q8["double"][0]["img_mlp2"]["w_s"])
    class Grid(TwoRanks):              # rank (r, r) of a 2 x 2 mesh
        shape = {"data": 2, "model": 2}

        def index(self, axis):
            return self.r

    for r in (0, 1):
        tp = tsharding.shard_params(params, TwoRanks(r))
        both = tsharding.shard_params(params, Grid(r), fsdp_axis="data")
        w = params["img_in"]["w"]
        assert torch.equal(both["img_in"]["w"],
                           w[r * w.shape[0] // 2:(r + 1) * w.shape[0] // 2])
        assert torch.equal(both["img_in"]["b"], params["img_in"]["b"])
        mod = params["double"][0]["img_mod"]["w"]
        assert torch.equal(both["double"][0]["img_mod"]["w"],
                           mod[r * mod.shape[0] // 2:
                               (r + 1) * mod.shape[0] // 2])
        for key in ("img_qkv", "img_mlp2"):
            assert torch.equal(both["double"][0][key]["w"],
                               tp["double"][0][key]["w"])


def test_prepare_stages_and_zero_blocks():
    """Depth padding as the JAX package pads (2 + 2 blocks over 4 stages:
    4 + 4), and an all-zero block is a bitwise identity."""
    params = bridge.params(_np_tree(jflux.init(jax.random.PRNGKey(0),
                                               jflux.TINY_FLUX)),
                           device="cpu")
    st = tpp.prepare_stages(params, 4)
    assert (len(st.doubles), len(st.singles), st.per_stage_double,
            st.per_stage_single) == (4, 4, 1, 1)
    cfg = tflux.TINY_FLUX
    rng = np.random.default_rng(0)
    img = torch.tensor(rng.standard_normal((2, 16, cfg.hidden)),
                       dtype=torch.float32)
    txt = torch.tensor(rng.standard_normal((2, 6, cfg.hidden)),
                       dtype=torch.float32)
    vec = torch.tensor(rng.standard_normal((2, cfg.hidden)),
                       dtype=torch.float32)
    ids = torch.cat([torch.from_numpy(tflux.make_text_ids(6)),
                     torch.from_numpy(tflux.make_image_ids(4, 4))])
    cos, sin = tflux.rope_cos_sin(ids, cfg.axes_dim, cfg.theta)
    i2, t2 = tflux._double_block(st.doubles[-1], img, txt, vec, cos, sin,
                                 cfg)
    assert torch.equal(i2, img) and torch.equal(t2, txt)
    x = torch.cat([txt, img], dim=1)
    assert torch.equal(tflux._single_block(st.singles[-1], x, vec, cos, sin,
                                           cfg), x)
