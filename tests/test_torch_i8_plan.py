"""The int8 attention kernels' scratch plan (``ops.mmdit_attention._i8_plan``).

The plan is pure Python, so its promises are checked here over the whole
range of stream lengths the kernels take: whole 128-row tiles (the q block
and the key tile of ``csrc/int8_attention.cu``), no key tile mixing two
streams' scales in one pass, stream b on a tile boundary wherever bf16 V
is read in place, and, for the int8 P.V multi-pass, a contiguous joint
sequence so that its 1024-key max windows start at multiples of 1024
joint rows, as the plain version's do. The plain int8 versions
themselves are held to the JAX package in ``tests/test_torch_int8.py``.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from domainrag_tpu_torch.ops import mmdit_attention as tmma

TILE = 128          # the kernels' q block and key tile
WINDOW = 1024       # the int8 P.V multi-pass max window


def _tile_streams(plan, s_a, s_b):
    """For each key tile of the padded space, the streams of its real
    rows."""
    out = []
    for t0 in range(0, plan.n_pad, TILE):
        streams = set()
        if t0 < s_a:
            streams.add("a")
        if s_b and t0 < plan.b0 + s_b and t0 + TILE > plan.b0:
            streams.add("b")
        out.append(streams)
    return out


def _check_plan(s_a, s_b, multipass, pv):
    plan = tmma._i8_plan(s_a, s_b, multipass, pv)
    assert tmma._I8_TILE == TILE
    assert plan.n_pad % TILE == 0
    assert plan.b0 >= s_a and plan.b0 + s_b <= plan.n_pad
    assert plan.n_pad - (plan.b0 + s_b) < TILE          # no idle tile
    if not multipass:
        # one K or V scale per tile: no tile holds rows of both streams
        assert all(len(s) <= 1 for s in _tile_streams(plan, s_a, s_b))
    if multipass and pv:
        # the joint sequence unbroken: padded row r is joint row r, so the
        # kernel's max windows of 8 tiles, counted from row 0, start at
        # multiples of 1024 joint rows, as the plain version's do
        assert plan.b0 == s_a and tmma._BKV_I8 == WINDOW == 8 * TILE
        joint = [r if r < s_a else s_a + r - plan.b0
                 for r in range(0, plan.n_pad, WINDOW) if r < s_a + s_b]
        assert all(j % WINDOW == 0 for j in joint)
    else:
        # bf16 V is read in place per stream: stream b starts a tile
        assert plan.b0 % TILE == 0
        assert plan.b0 - s_a < TILE
    return plan


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(s_a=st.integers(1, 40000), s_b=st.integers(0, 40000),
       multipass=st.booleans(), pv=st.booleans())
def test_i8_plan_promises(s_a, s_b, multipass, pv):
    _check_plan(s_a, s_b, multipass, pv)


@pytest.mark.parametrize("pv", [False, True], ids=["qk", "qk_pv"])
@pytest.mark.parametrize("multipass", [False, True], ids=["onepass", "mp"])
@pytest.mark.parametrize("s_a,s_b", [
    (1, 0), (127, 0), (128, 0), (129, 0), (5337, 0), (40000, 0),
    (1, 1), (127, 129), (128, 256), (200, 300), (1241, 4096),
    (1241, 16384), (1241, 30625), (40000, 40000)])
def test_i8_plan_edges(s_a, s_b, multipass, pv):
    plan = _check_plan(s_a, s_b, multipass, pv)
    if multipass and pv:
        assert plan.n_pad == -(-(s_a + s_b) // TILE) * TILE
    else:
        assert plan.b0 == -(-s_a // TILE) * TILE


def test_i8_plan_main_path_shapes():
    """The stage-3 and stage-4 shapes: 1241 text + Redux tokens, 4096 or
    16384 image tokens."""
    assert tmma._i8_plan(1241, 4096, False, False) == (1280, 5376)
    assert tmma._i8_plan(1241, 4096, False, True) == (1280, 5376)
    assert tmma._i8_plan(1241, 16384, True, True) == (1241, 17664)
    assert tmma._i8_plan(1241, 16384, True, False) == (1280, 17664)
    assert tmma._i8_plan(5337, 0, False, False) == (5376, 5376)

