"""The port's trainer over a mesh
(``train.flow_match.make_sharded_train_step``, ``train.loop.fit``) and the
ring's gradient against the JAX package's on its 8-device CPU mesh.

The port side runs in one gloo group of four spawned processes
(``torch_scaleout_driver``, suite ``train``), started once for this file;
the JAX side runs here, on the same mesh shapes built from 4 of its
devices, from the same numpy batches and initial tree (TINY_FLUX, f32,
batch 4), with JAX's t and eps injected into the port. Limits, and why
(``tests/test_torch_train.py`` and ``test_torch_train_step.py`` state
them for one device):
- each step's loss within rtol 1e-5 of JAX's (the same algorithm, other
  summation orders), and within 1e-6 of the port's one-process step; a
  bf16 batch (the TP + FSDP mesh's last case) is held to the same limits,
  since both packages promote it and train in f32;
- the params after two steps: each leaf's update within 1e-3 of JAX's in
  relative norm and every element within 2.2 lr per step (Adam's
  g / (|g| + eps) amplifies the gradients' relative error where |g| is
  near eps); against the port's one process, 5e-4 and 0.1 lr per step
  (only the sums' order differs: a shard's partial products, the
  all-reduces of the data axis; measured 1.2e-4 and 0.015 lr at worst);
- TP's gradients (the F1 pin: Megatron's reduce and copy) gathered
  against one process's: atol 1e-5 of the largest, rtol 1e-5; without
  the copy's all-reduce the replicated leaves' gradients are partial and
  miss by far;
- the ring's gradients: JAX's rtol 2e-4 / atol 2e-5
  (``tests/test_ring_attention.py:36-55``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scaleout_driver as drv
from domainrag_tpu.models.flux import model as jflux
from domainrag_tpu.ops import attention as jattn
from domainrag_tpu.ops import ring_attention as jring
from domainrag_tpu.parallel import mesh as jmesh
from domainrag_tpu.train import flow_match as jflow
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.train import checkpoint as tckpt
from domainrag_tpu_torch.train import flow_match as tflow
from domainrag_tpu_torch.train import loop as tloop

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

CFG = jflux.TINY_FLUX
JTRAIN = jflow.TrainConfig(learning_rate=drv.TRAIN_LR)
LR = drv.TRAIN_LR


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t_eps(key, x0):
    k_t, k_eps = jax.random.split(key)
    return (np.asarray(jflow.sample_timesteps(k_t, x0.shape[0], JTRAIN)),
            np.asarray(jax.random.normal(k_eps, x0.shape, x0.dtype)))


@pytest.fixture(scope="module")
def inputs():
    params = _np_tree(jflux.init(jax.random.PRNGKey(0), CFG))
    steps = []
    for i in range(2):
        b = drv.train_batch(CFG, 30 + i)
        key = jax.random.PRNGKey(100 + i)
        steps.append((b, *_t_eps(key, jnp.asarray(b["x0"])), key))
    return params, steps


def _steps_in(steps, dtype):
    """``steps`` with the batch lanes rounded to ``dtype`` and JAX's eps
    drawn in it from the same key (both stored as f32 numpy), the t
    alike."""
    if dtype == "float32":
        return steps
    out = []
    for b, _, _, key in steps:
        b = {k: np.asarray(jnp.asarray(v, dtype), np.float32)
             if k in drv.TRAIN_LANES else v for k, v in b.items()}
        t, e = _t_eps(key, jnp.asarray(b["x0"], dtype))
        out.append((b, t, np.asarray(e, np.float32), key))
    return out


def _dtypes():
    return sorted({m[3] for m in drv.TRAIN_MESHES})


@pytest.fixture(scope="module")
def group(tmp_path_factory, inputs):
    """The ``train`` suite run once in four gloo processes; its
    directory."""
    params, steps = inputs
    work = str(tmp_path_factory.mktemp("scaleout_train"))
    drv.dump(work, "tiny_flux.pkl", params)
    drv.dump(work, "train_steps.pkl", [s[:3] for s in steps])
    for dtype in _dtypes():
        if dtype != "float32":
            drv.dump(work, f"train_steps_{dtype}.pkl",
                     [s[:3] for s in _steps_in(steps, dtype)])
    drv.dump(work, "fit_batches.pkl",
             [drv.train_batch(CFG, 40 + i) for i in range(3)])
    drv.launch(work, 4, "train")
    return work


def _port_cfg():
    return (bridge.config(CFG, tflux.FluxConfig),
            bridge.config(JTRAIN, tflow.TrainConfig))


def _torch(batch, dtype="float32"):
    return {k: torch.from_numpy(np.asarray(v)).to(getattr(torch, dtype))
            if k in drv.TRAIN_LANES else torch.from_numpy(np.asarray(v))
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def one_process(inputs):
    """The port's one-device step, two steps, per batch dtype: (losses,
    tree)."""
    params, steps = inputs
    cfg, train_cfg = _port_cfg()
    out = {}
    for dtype in _dtypes():
        step, tree, opt = tflow.make_train_step(
            cfg, train_cfg, bridge.params(params, device="cpu"))
        losses = [step(tree, opt, _torch(b, dtype), None,
                       t=torch.from_numpy(t),
                       eps=torch.from_numpy(e))[2].item()
                  for b, t, e, _ in _steps_in(steps, dtype)]
        out[dtype] = (losses, drv.np_tree(tree))
    return out


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """JAX's make_sharded_train_step on each mesh, on batches of the
    mesh's dtype: (losses, tree)."""
    params, steps = inputs
    out = {}
    for name, mp, fsdp, dtype in drv.TRAIN_MESHES:
        mesh = jmesh.create_mesh(model_parallel=mp,
                                 devices=jax.devices()[:4])
        step, sp, opt, shardings = jflow.make_sharded_train_step(
            mesh, CFG, JTRAIN, jax.tree.map(jnp.asarray, params), fsdp=fsdp)
        losses = []
        for b, _, _, key in steps:
            batch = {k: jax.device_put(
                jnp.asarray(v, dtype) if k in drv.TRAIN_LANES
                else jnp.asarray(v), shardings[k]) for k, v in b.items()}
            run = step
            if dtype != "float32":
                # under jit, XLA's CPU backend may keep bf16 values in f32
                # (excess precision): the bf16 eps draw and eps - x0 go
                # unrounded. Without it the step computes the dtypes the
                # program states, as JAX's eager flow_match_loss does.
                run = step.lower(sp, opt, batch, key).compile(
                    compiler_options={"xla_allow_excess_precision": False})
            sp, opt, loss = run(sp, opt, batch, key)
            losses.append(float(loss))
        out[name] = (losses, _np_tree(sp))
    return out


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _paths(v, prefix + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: x for i, v in enumerate(tree)
                for p, x in _paths(v, prefix + (i,)).items()}
    return {prefix: tree}


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _updates_close(got, want, start, rel, per_step, steps=2):
    got, want, start = _paths(got), _paths(want), _paths(start)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        d_got, d_want = got[path] - start[path], w - start[path]
        assert _rel(d_got, d_want) < rel, (path, _rel(d_got, d_want))
        assert np.abs(d_got - d_want).max() <= per_step * LR * steps, path


@pytest.mark.parametrize("name", [m[0] for m in drv.TRAIN_MESHES])
def test_sharded_step_matches_jax(group, inputs, jax_runs, one_process,
                                  name):
    got = drv.result(group, "train_meshes")[name]
    params, _ = inputs
    want_losses, want_tree = jax_runs[name]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    _updates_close(got["params"], want_tree, params, 1e-3, 2.2)
    mp, dtype = {m[0]: (m[1], m[3]) for m in drv.TRAIN_MESHES}[name]
    one_losses, one_tree = one_process[dtype]
    np.testing.assert_allclose(got["losses"], one_losses, rtol=1e-6)
    _updates_close(got["params"], one_tree, params, 5e-4, 0.1)
    # the batch's rows over data, the ids whole
    n_data = 4 // mp
    assert got["rows"] == (4 // n_data,) * 3 + (16,)


def test_tp_grads_equal_one_process_grads(group, inputs):
    """F1's pin: the (1, 4) mesh's gradients, gathered, are the
    one-process gradients, every leaf (the replicated ones through the
    copy's all-reduce, the sharded ones through the reduce)."""
    got = drv.result(group, "train_tp_grads")
    params, steps = inputs
    b, t, e, _ = steps[0]
    cfg, train_cfg = _port_cfg()
    tree = bridge.params(params, device="cpu")
    leaves = tflow.leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    loss = tflow.flow_match_loss(tree, _torch(b), None, cfg, train_cfg,
                                 t=torch.from_numpy(t),
                                 eps=torch.from_numpy(e))
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    want = _paths(drv.np_tree(jax.tree.map(lambda _: next(it), tree)))
    np.testing.assert_allclose(got["loss"], loss.item(), rtol=1e-6)
    got_g = _paths(got["grads"])
    assert sorted(got_g) == sorted(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        np.testing.assert_allclose(got_g[path], w, atol=1e-5 * top,
                                   rtol=1e-5, err_msg=str(path))


def test_untrainable_splits_and_batches_raise(group):
    got = drv.result(group, "train_tp_grads")
    kind, text = got["whole_attention"]
    assert kind == "ValueError" and "cannot train" in text
    kind, text = got["indivisible_batch"]
    assert kind == "ValueError" and "not divisible over data=4" in text


def test_fit_over_the_group_is_the_one_process_fit(group, inputs, tmp_path):
    """fit(model_parallel=2, fsdp=True) over 4 processes: the one-process
    fit's losses and params, and a checkpoint (written by rank 0, of the
    whole tree) that restores the final tree, as JAX's
    ``test_fit_runs_and_checkpoints``."""
    got = drv.result(group, "train_fit")
    params, _ = inputs
    cfg, train_cfg = _port_cfg()
    batches = drv.load(group, "fit_batches.pkl")
    final, losses = tloop.fit(bridge.params(params, device="cpu"), cfg,
                              [_torch(b) for b in batches], 3, train_cfg,
                              checkpoint_dir=str(tmp_path / "one"),
                              checkpoint_every=2)
    assert len(got["losses"]) == 3 and np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-6)
    _updates_close(got["params"], drv.np_tree(final), params, 5e-4, 0.1,
                   steps=3)
    ckpt = f"{group}/ckpt"
    assert tckpt.latest_step(ckpt) == 3
    assert sorted(__import__("os").listdir(ckpt)) == ["step_2", "step_3"]
    restored = _paths(drv.np_tree(tckpt.restore_checkpoint(ckpt)["params"]))
    for path, w in _paths(got["params"]).items():
        np.testing.assert_array_equal(restored[path], w, err_msg=str(path))
    w_final = _paths(got["params"])[("img_in", "w")]
    assert np.abs(w_final - params["img_in"]["w"]).max() > 0


@pytest.fixture(scope="module")
def mesh8():
    return jmesh.create_mesh(model_parallel=1)


def _jax_ring_grads(name, shape, mp, fn):
    q, k, v = (jnp.asarray(x)
               for x in drv.qkv(*drv.RING_GRAD_SEEDS[name], shape))
    mesh = jmesh.create_mesh(model_parallel=mp)
    kw = {"head_axis": "model"} if mp > 1 else {}

    def ring_loss(q, k, v):
        return jnp.sum(jnp.square(getattr(jring, fn)(q, k, v, mesh,
                                                     axis="data", **kw)))

    def dense_loss(q, k, v):
        return jnp.sum(jnp.square(jattn.attention_reference(q, k, v)))

    return (jax.grad(ring_loss, argnums=(0, 1, 2))(q, k, v),
            jax.grad(dense_loss, argnums=(0, 1, 2))(q, k, v))


@pytest.mark.parametrize("case", drv.RING_GRAD_CASES, ids=lambda c: c[0])
def test_ring_grads_match_jax(group, case):
    got = drv.result(group, "ring_grad")[case[0]]
    ring_g, dense_g = _jax_ring_grads(*case)
    for g, r, d in zip(got, ring_g, dense_g):
        np.testing.assert_allclose(g, np.asarray(r), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(g, np.asarray(d), rtol=2e-4, atol=2e-5)


def test_remat_recompute_keeps_the_tp_context_on_another_thread(inputs):
    """On the card the backward runs on autograd's device thread, where the
    thread-local ``tp_attention`` is not entered: a checkpointed block's
    recompute re-enters the contexts of its forward. Here the backward
    runs on another Python thread (the CPU engine runs it on the calling
    thread): a TP rank's remat gradients equal those computed on the
    forward's thread."""
    import threading

    from domainrag_tpu_torch.ops.attention import tp_attention
    from domainrag_tpu_torch.parallel import sharding as tsharding

    class RankAlone:                   # rank 0 of 2; sums return the input
        shape = {"model": 2}

        def index(self, axis):
            return 0

        def all_reduce(self, x, axis, op="sum"):
            return x

    params, steps = inputs
    b, t, e, _ = steps[0]
    cfg, train_cfg = _port_cfg()
    grads = []
    for elsewhere in (False, True):
        local = tsharding.shard_params(bridge.params(params, device="cpu"),
                                       RankAlone())
        leaves = tflow.leaves(local)
        for p in leaves:
            p.requires_grad_(True)
        with tp_attention(RankAlone()):
            loss = tflow.flow_match_loss(
                local, _torch(b), None, cfg, train_cfg,
                t=torch.from_numpy(t), eps=torch.from_numpy(e))
        out = []

        def backward():
            try:
                out.append(torch.autograd.grad(loss, leaves))
            except Exception as err:      # noqa: BLE001
                out.append(err)

        if elsewhere:
            worker = threading.Thread(target=backward)
            worker.start()
            worker.join()
        else:
            with tp_attention(RankAlone()):
                backward()
        assert not isinstance(out[0], Exception), out[0]
        grads.append(out[0])
    assert train_cfg.remat
    for a, g in zip(*grads):
        assert torch.equal(a, g)
