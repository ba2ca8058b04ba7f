"""Pins of three gaps in the port's API against the JAX package:

- the scheduler's ``FlowSchedule.timesteps`` / ``start_sigma`` and the
  Euler loop ``denoise`` (``domainrag_tpu/models/flux/scheduler.py:61,
  67, 117``): the sigma tables bitwise (both are the same f32 numpy
  arrays) and ``denoise`` within 1e-6 (f32 Euler steps in the same order);
- ``StepTimer.summary()`` (``domainrag_tpu/core/log.py:56``): the same
  keys, counts and structure for the same spans;
- ``tp_attention`` / ``sp_attention`` (``domainrag_tpu/ops/attention.py:
  527, 541``): the port's context managers take the JAX arguments and, on
  an axis of one rank, leave ``attention`` JAX's dense attention (within
  2e-5, as ``tests/test_tp_attention.py``); the multi-rank paths are
  ``tests/test_torch_scaleout_ops.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.core import log as jlog
from domainrag_tpu.models.flux import scheduler as jsch
from domainrag_tpu_torch.core import log as tlog
from domainrag_tpu_torch.models.flux import scheduler as tsch
from domainrag_tpu_torch.ops import attention as tattn

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

SCHEDULES = [
    dict(num_steps=50, image_seq_len=4096),
    dict(num_steps=50, image_seq_len=4096, strength=0.3),
    dict(num_steps=10, image_seq_len=256, strength=0.75),
    dict(num_steps=8, use_dynamic_shifting=False, shift=1.0),
    dict(num_steps=28, use_dynamic_shifting=False, strength=0.4),
    dict(num_steps=10, image_seq_len=256, strength=0.0),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=str)
def test_timesteps_and_start_sigma_match_jax(kw):
    want = jsch.make_schedule(**kw)
    got = tsch.make_schedule(**kw)
    assert got.start_index == want.start_index
    assert got.num_steps == want.num_steps
    np.testing.assert_array_equal(got.timesteps, want.timesteps)
    assert got.timesteps.dtype == np.float32
    assert got.start_sigma == want.start_sigma
    assert isinstance(got.start_sigma, float)


def test_strength_trim_timesteps():
    full = tsch.make_schedule(50, image_seq_len=4096)
    trimmed = tsch.make_schedule(50, image_seq_len=4096, strength=0.3)
    np.testing.assert_array_equal(trimmed.timesteps, full.timesteps[35:])
    assert trimmed.start_sigma == full.sigmas[35]


def test_denoise_linear_model_matches_jax():
    """The linear model of the JAX package's scheduler tests: v = x /
    sigma, an exact rectified flow to 0."""
    sched_j = jsch.make_schedule(8, use_dynamic_shifting=False, shift=1.0)
    sched_t = tsch.make_schedule(8, use_dynamic_shifting=False, shift=1.0)
    x0 = np.random.default_rng(0).uniform(1, 5, (4, 3)).astype(np.float32)
    want = jsch.denoise(lambda x, s: x / jnp.maximum(s, 1e-6),
                        jnp.asarray(x0), sched_j)
    got = tsch.denoise(lambda x, s: x / torch.clamp(s, min=1e-6),
                       torch.from_numpy(x0), sched_t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), 0.0, atol=1e-4)


def test_denoise_nonlinear_bf16_matches_jax():
    """A model that reads sigma nonlinearly, on a trimmed dynamic-shift
    schedule, with bf16 latents: the f32 Euler update cast back each
    step, in both."""
    kw = dict(num_steps=12, image_seq_len=1024, strength=0.6)
    x0 = np.random.default_rng(1).standard_normal((2, 5)).astype(np.float32)

    def jmodel(x, s):
        return (jnp.sin(x.astype(jnp.float32)) * s + s * s).astype(x.dtype)

    def tmodel(x, s):
        return (torch.sin(x.float()) * s + s * s).to(x.dtype)

    want = jsch.denoise(jmodel, jnp.asarray(x0, jnp.bfloat16),
                        jsch.make_schedule(**kw))
    got = tsch.denoise(tmodel, torch.from_numpy(x0).to(torch.bfloat16),
                       tsch.make_schedule(**kw))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_denoise_zero_steps_returns_input():
    s0 = tsch.make_schedule(10, image_seq_len=256, strength=0.0)
    x = torch.ones(3)
    out = tsch.denoise(lambda x, s: x * 0 + 99, x, s0)
    assert torch.equal(out, x)


def _spans(timer):
    for name in ["prior", "step", "step", "decode", "step", "save"]:
        with timer.span(name):
            pass


def test_step_timer_summary_matches_jax():
    jt, tt = jlog.StepTimer(), tlog.StepTimer()
    _spans(jt)
    _spans(tt)
    want, got = jt.summary(), tt.summary()
    assert list(got) == list(want)
    for name in want:
        assert list(got[name]) == list(want[name]) == ["total_s", "count",
                                                       "mean_s"]
        assert got[name]["count"] == want[name]["count"]
        assert got[name]["mean_s"] == pytest.approx(
            got[name]["total_s"] / got[name]["count"])
    assert got["step"]["count"] == 3


def test_step_timer_summary_keeps_sync():
    calls = []
    timer = tlog.StepTimer(sync=lambda: calls.append(1))
    _spans(timer)
    assert timer.summary()["step"]["count"] == 3
    assert len(calls) == 2 * 6
    assert tlog.StepTimer().summary() == {}


@pytest.mark.parametrize("name,axis", [("tp_attention", "model"),
                                       ("sp_attention", "data")])
def test_parallel_attention_contexts_raise(name, axis):
    """Each context, by position and by keyword, on one-rank and
    one-device meshes: the port's attention inside it is JAX's inside its
    own, and the context is gone after."""
    from domainrag_tpu.ops import attention as jattn
    from domainrag_tpu.parallel import mesh as jmesh
    from domainrag_tpu_torch.parallel import mesh as tmesh
    q = np.random.default_rng(0).standard_normal((1, 2, 16, 8)).astype(
        np.float32)
    jmesh1 = jmesh.create_mesh(devices=jax.devices()[:1])
    for kw in ({}, {"axis": axis}):
        with getattr(jattn, name)(jmesh1, **kw):
            want = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(q),
                                              jnp.asarray(q)))
        with getattr(tattn, name)(tmesh.create_mesh(), **kw):
            assert (tattn.tp_context() if name == "tp_attention"
                    else tattn.sp_context())[1] == axis
            got = tattn.attention(*(torch.from_numpy(q),) * 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
        assert tattn.tp_context() is None and tattn.sp_context() is None
