"""The port's training path (domainrag_tpu_torch.train, the autograd of the
fused MMDiT attention) against the JAX package's, on the same numpy inputs
and bridged weights, on the CPU.

Limits, and why:
- f32 single ops (the fused wrappers' gradients in f32, the global-norm
  clip): 1e-5, the same algorithm with another summation order;
- bf16 fused wrappers: the port's backward is autograd of its unfused
  composition, JAX's is ``jax.vjp`` of its own; both round q/k/v and P to
  bf16 at the same places but sum in another order, so the gradients
  agree to 2e-2 in relative Frobenius norm (about four bf16 ulps);
- the flow-matching loss on the tiny models in f32: 1e-5 relative on the
  loss and 1e-4 on the gradients (errors compound over the blocks, and
  small gradient leaves carry larger relative error, so each leaf is held
  to 1e-4 of the largest gradient);
- the loss of a bf16 batch against JAX's own ``flow_match_loss``: both
  packages promote x_t to f32 and compute in f32, so the f32 limits
  above hold (``test_torch_train_bf16.py``);
- one train step against optax (``test_torch_train_step.py``): each
  leaf's update within 1e-3 of JAX's in relative norm, and every element
  within 2.2 lr. A step is about
  lr = 1e-3 per element, and Adam's g / (|g| + eps) amplifies the
  gradients' relative error where |g| is near eps: a few elements in
  10^4 move by up to a few percent of a step (at most 2 lr, a reversal).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.models.flux import model as jflux
from domainrag_tpu.ops import mmdit_attention as jmma
from domainrag_tpu.train import flow_match as jflow
from domainrag_tpu.train import loop as jloop
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.core import interrupt, prng
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.ops import mmdit_attention as tmma
from domainrag_tpu_torch.train import checkpoint as tckpt
from domainrag_tpu_torch.train import flow_match as tflow
from domainrag_tpu_torch.train import loop as tloop

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

HEADS, HD = 2, 128
HD128 = dataclasses.replace(jflux.TINY_FLUX, hidden=256, heads=2,
                            head_dim=128, depth_double=1, depth_single=1,
                            axes_dim=(16, 56, 56))
CONFIGS = [jflux.TINY_FLUX, HD128]
CONFIG_IDS = ["tiny", "head_dim128"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return bridge.params(_np(tree), device="cpu")


def _rel(got, want):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)


# ---------------------------------------------------------------------------
# the fused wrappers' autograd
# ---------------------------------------------------------------------------

def _attn_inputs(seed, shapes, s_total):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ang = rng.uniform(-np.pi, np.pi, size=(s_total, HD // 2))
    norms = [rng.uniform(0.5, 1.5, size=(HD,)).astype(np.float32)
             for _ in range(4)]
    cot = [rng.standard_normal((s[0], s[1], HEADS * HD)).astype(np.float32)
           for s in shapes]
    return xs, np.cos(ang).astype(np.float32), \
        np.sin(ang).astype(np.float32), norms, cot


def _qknorm(wq, wk):
    return {"q": {"scale": wq}, "k": {"scale": wk}}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_double_autograd_matches_jax_vjp(dtype):
    """Gradients of the double wrapper for both streams and all four
    qk-norm scales. bf16 runs the port's custom Function (plain forward,
    unfused backward) against JAX's custom VJP (Pallas forward in
    interpret mode, unfused vjp); f32 runs the unfused composition in
    both packages."""
    (txt, img), cos, sin, ws, cot = _attn_inputs(
        1, [(1, 24, 3 * HEADS * HD), (1, 40, 3 * HEADS * HD)], 64)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jfun(t, i, wqt, wkt, wqi, wki):
        return jmma.mmdit_double_attention(
            t, i, _qknorm(wqt, wkt), _qknorm(wqi, wki), jnp.asarray(cos),
            jnp.asarray(sin), HEADS, HD, interpret=True)

    jargs = [jnp.asarray(txt, jdt), jnp.asarray(img, jdt)] + \
        [jnp.asarray(w) for w in ws]
    jout, vjp = jax.vjp(jfun, *jargs)
    want = vjp(tuple(jnp.asarray(c, jdt) for c in cot))

    targs = [torch.tensor(txt).to(tdt).requires_grad_(),
             torch.tensor(img).to(tdt).requires_grad_()] + \
        [torch.tensor(w).requires_grad_() for w in ws]
    out = tmma.mmdit_double_attention(
        targs[0], targs[1], _qknorm(*targs[2:4]), _qknorm(*targs[4:6]),
        torch.from_numpy(cos), torch.from_numpy(sin), HEADS, HD)
    torch.autograd.backward(out, [torch.tensor(c).to(tdt) for c in cot])
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for o, jo in zip(out, jout):
        assert _rel(o.detach().float(), jo) < tol
    for a, g in zip(targs, want):
        assert a.grad.dtype == a.dtype
        assert _rel(a.grad.float(), g) < tol, _rel(a.grad.float(), g)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_single_autograd_matches_jax_vjp(dtype):
    width = 7 * HEADS * HD                         # q/k/v + MLP lanes
    (proj,), cos, sin, ws, (cot,) = _attn_inputs(2, [(2, 48, width)], 48)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jfun(p, wq, wk):
        return jmma.mmdit_single_attention(
            p, _qknorm(wq, wk), jnp.asarray(cos), jnp.asarray(sin), HEADS,
            HD, interpret=True)

    jargs = [jnp.asarray(proj, jdt), jnp.asarray(ws[0]), jnp.asarray(ws[1])]
    _, vjp = jax.vjp(jfun, *jargs)
    want = vjp(jnp.asarray(cot, jdt))
    targs = [torch.tensor(proj).to(tdt).requires_grad_(),
             torch.tensor(ws[0]).requires_grad_(),
             torch.tensor(ws[1]).requires_grad_()]
    out = tmma.mmdit_single_attention(targs[0], _qknorm(*targs[1:]),
                                      torch.from_numpy(cos),
                                      torch.from_numpy(sin), HEADS, HD)
    out.backward(torch.tensor(cot).to(tdt))
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for a, g in zip(targs, want):
        assert _rel(a.grad.float(), g) < tol, _rel(a.grad.float(), g)
    # the MLP lanes, which the attention never reads, get zero gradient
    assert not targs[0].grad[..., 3 * HEADS * HD:].any()


def test_fused_backward_recomputes_the_unfused_composition(monkeypatch):
    """The custom Function's backward differentiates reference_double
    (the JAX bwd's ``jax.vjp(ref, ...)``), not the plain forward it ran."""
    calls = []
    real = tmma.reference_double

    def spy(*args):
        calls.append(torch.is_grad_enabled())
        return real(*args)

    monkeypatch.setattr(tmma, "reference_double", spy)
    (txt, img), cos, sin, ws, _ = _attn_inputs(
        3, [(1, 8, 3 * HEADS * HD), (1, 8, 3 * HEADS * HD)], 16)
    t = torch.tensor(txt).to(torch.bfloat16).requires_grad_()
    i = torch.tensor(img).to(torch.bfloat16)
    n = [torch.tensor(w) for w in ws]
    out = tmma.mmdit_double_attention(t, i, _qknorm(*n[:2]), _qknorm(*n[2:]),
                                      torch.from_numpy(cos),
                                      torch.from_numpy(sin), HEADS, HD)
    assert calls == [False]                  # the forward (no graph)
    (out[0].float().sum() + out[1].float().sum()).backward()
    assert calls == [False, True]            # the recompute in the backward
    assert t.grad is not None and t.grad.shape == t.shape


# ---------------------------------------------------------------------------
# the flow-matching loss
# ---------------------------------------------------------------------------

def _batch(cfg, seed=0, batch=2, gh=2, gw=3, s_txt=4):
    rng = np.random.default_rng(seed)
    return {
        "x0": rng.standard_normal((batch, gh * gw, cfg.in_channels))
        .astype(np.float32),
        "txt": rng.standard_normal((batch, s_txt, cfg.text_dim))
        .astype(np.float32),
        "pooled": rng.standard_normal((batch, cfg.pooled_dim))
        .astype(np.float32),
        "img_ids": jflux.make_image_ids(gh, gw),
        "txt_ids": jflux.make_text_ids(s_txt),
    }


def _jax_t_eps(key, x0, cfg):
    """The t and eps JAX's flow_match_loss draws from ``key``."""
    k_t, k_eps = jax.random.split(key)
    return (jflow.sample_timesteps(k_t, x0.shape[0], cfg),
            jax.random.normal(k_eps, x0.shape, x0.dtype))


def _port_loss_and_grads(params, batch, cfg, train_cfg, t, eps):
    tparams = _port(params)
    leaves = tflow.leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss = tflow.flow_match_loss(
        tparams, {k: torch.from_numpy(np.asarray(v)) for k, v in
                  batch.items()}, None, bridge.config(cfg, tflux.FluxConfig),
        bridge.config(train_cfg, tflow.TrainConfig),
        t=torch.tensor(np.asarray(t)), eps=torch.tensor(np.asarray(eps)))
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_flow_match_loss_and_grads_match_jax(cfg, remat):
    params = jflux.init(jax.random.PRNGKey(1), cfg)
    batch = _batch(cfg)
    train_cfg = jflow.TrainConfig(remat=remat)
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(jflow.flow_match_loss)(
        params, jbatch, key, cfg, train_cfg)
    t, eps = _jax_t_eps(key, jbatch["x0"], train_cfg)
    loss, grads = _port_loss_and_grads(params, batch, cfg, train_cfg, t, eps)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jgrads))
    got = tflow.leaves(grads)
    # the port's leaf order is the tree's; JAX sorts dict keys
    flat = sorted(zip(_paths(_np(params)), got), key=lambda x: x[0])
    assert len(flat) == len(want)
    top = max(float(np.abs(w).max()) for w in want)
    for (_, g), w in zip(flat, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * top, rtol=1e-4)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, prefix + (k,))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, prefix + (i,))]
    return [prefix]


@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_remat_gives_the_same_grads(cfg):
    params = jflux.init(jax.random.PRNGKey(2), cfg)
    batch = _batch(cfg, seed=1)
    t, eps = _jax_t_eps(jax.random.PRNGKey(6), jnp.asarray(batch["x0"]),
                        jflow.TrainConfig())
    out = [_port_loss_and_grads(params, batch, cfg,
                                jflow.TrainConfig(remat=remat), t, eps)
           for remat in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_timesteps_are_logit_normal_and_seeded():
    cfg = tflow.TrainConfig(t_mean=0.5, t_std=2.0)
    a = tflow.sample_timesteps(prng.PRNGKey(3), 4096, cfg)
    b = tflow.sample_timesteps(prng.PRNGKey(3), 4096, cfg)
    assert torch.equal(a, b) and bool(((a > 0) & (a < 1)).all())
    z = torch.logit(a.double())
    assert abs(z.mean().item() - 0.5) < 0.1 and abs(z.std().item() - 2) < 0.1


def test_meshes_raise():
    """A TP degree the processes cannot hold raises JAX's error (one
    process is one card); the one-process mesh's step is the one-card
    step."""
    cfg = bridge.config(jflux.TINY_FLUX, tflux.FluxConfig)
    params = _port(jflux.init(jax.random.PRNGKey(9), jflux.TINY_FLUX))
    with pytest.raises(ValueError) as want:
        jloop.fit(jflux.init(jax.random.PRNGKey(9), jflux.TINY_FLUX),
                  jflux.TINY_FLUX, [], 1,
                  model_parallel=2 * len(jax.devices()))
    with pytest.raises(ValueError) as got:
        tloop.fit(params, cfg, [], 1, model_parallel=2)
    assert str(got.value) == str(want.value).replace(
        f"{len(jax.devices())} devices", "1 devices").replace(
        f"TP={2 * len(jax.devices())}", "TP=2")
    from domainrag_tpu_torch.parallel import mesh as tmesh
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in _batch(jflux.TINY_FLUX).items()}
    t, eps = torch.tensor([0.3, 0.6]), torch.randn(batch["x0"].shape)
    out = []
    for mesh in (None, tmesh.create_mesh()):
        tree = _port(jflux.init(jax.random.PRNGKey(9), jflux.TINY_FLUX))
        step, tree, opt = (tflow.make_train_step(
            cfg, tflow.TrainConfig(), tree) if mesh is None else
            tflow.make_sharded_train_step(mesh, cfg, tflow.TrainConfig(),
                                          tree)[:3])
        _, _, loss = step(tree, opt, batch, None, t=t, eps=eps)
        out.append((loss, tflow.leaves(tree)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# ---------------------------------------------------------------------------
# fit and checkpoints
# ---------------------------------------------------------------------------

def _batches(cfg, n):
    for i in range(n):
        yield {k: np.asarray(v) for k, v in _batch(cfg, seed=10 + i).items()}


def test_fit_checkpoints_and_restores(tmp_path):
    jcfg = jflux.TINY_FLUX
    cfg = bridge.config(jcfg, tflux.FluxConfig)
    params = _port(jflux.init(jax.random.PRNGKey(11), jcfg))
    start = [p.clone() for p in tflow.leaves(params)]
    out, losses = tloop.fit(
        params, cfg, _batches(jcfg, 5), 3,
        tflow.TrainConfig(learning_rate=1e-3, remat=True),
        checkpoint_dir=str(tmp_path), checkpoint_every=2, seed=3)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]
    assert tckpt.latest_step(str(tmp_path)) == 3
    restored = tckpt.restore_checkpoint(str(tmp_path))
    assert set(restored) == {"params"}
    for a, b, c in zip(tflow.leaves(restored["params"]), tflow.leaves(out),
                       start):
        assert torch.equal(a, b.detach()) and not torch.equal(b, c)
    early = tckpt.restore_checkpoint(str(tmp_path), step=2)
    assert not all(torch.equal(a, b.detach()) for a, b in zip(
        tflow.leaves(early["params"]), tflow.leaves(out)))
    # the same seed and data give the same run
    again, losses2 = tloop.fit(
        _port(jflux.init(jax.random.PRNGKey(11), jcfg)), cfg,
        _batches(jcfg, 5), 3,
        tflow.TrainConfig(learning_rate=1e-3, remat=True), seed=3)
    assert losses2 == losses


def test_checkpoint_payload_and_latest_step(tmp_path):
    """latest_step behaves as the JAX one; the optimizer state round-trips
    and a template places the tensors."""
    assert tckpt.latest_step(str(tmp_path / "missing")) is None
    assert jloop.ckpt_mod.latest_step(str(tmp_path / "missing")) is None
    for name in ("step_2", "step_10", "step_x", "other"):
        (tmp_path / name).mkdir()
    assert tckpt.latest_step(str(tmp_path)) == 10
    assert jloop.ckpt_mod.latest_step(str(tmp_path)) == 10
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "missing"))
    w = torch.ones(3, requires_grad=True)
    opt = torch.optim.AdamW([w], lr=0.1)
    w.grad = torch.full((3,), 2.0)
    opt.step()
    path = tckpt.save_checkpoint(str(tmp_path / "run"), 4, {"w": w},
                                 opt_state=opt)
    assert path.endswith("step_4")
    got = tckpt.restore_checkpoint(str(tmp_path / "run"),
                                   template={"params": {"w": torch.zeros(
                                       3, dtype=torch.float64)}})
    assert got["params"]["w"].dtype == torch.float64
    np.testing.assert_allclose(got["params"]["w"].numpy(),
                               w.detach().numpy())
    opt2 = torch.optim.AdamW([torch.zeros(3, requires_grad=True)], lr=0.1)
    opt2.load_state_dict(got["opt_state"])
    assert torch.equal(opt2.state_dict()["state"][0]["exp_avg"],
                       opt.state_dict()["state"][0]["exp_avg"])


def test_fit_stops_gracefully_and_on_exhausted_data(tmp_path):
    jcfg = jflux.TINY_FLUX
    cfg = bridge.config(jcfg, tflux.FluxConfig)
    params = _port(jflux.init(jax.random.PRNGKey(12), jcfg))
    _, losses = tloop.fit(params, cfg, _batches(jcfg, 1), 3,
                          checkpoint_dir=str(tmp_path))
    assert len(losses) == 1
    assert tckpt.latest_step(str(tmp_path)) == 3       # the final save
    interrupt.request_stop()
    try:
        _, losses = tloop.fit(params, cfg, _batches(jcfg, 3), 3)
    finally:
        interrupt.reset()
    assert losses == []
