"""The benchmark's frozen arithmetic against the port's own, at tiny and
full widths: the FLOPs of a forward, and the GEMM list that prices the
roofline (its operations equal the FLOPs' linear parts)."""

import dataclasses

import pytest

from domainrag_tpu_torch.eval import flops as port_flops
from domainrag_tpu_torch.models.flux import model as fm
from gpubench.counts import flops
from gpubench.families import flux

CASES = [(fm.TINY_FLUX, 64, 32, 1), (fm.TINY_FLUX, 256, 32, 5),
         (fm.FLUX_DEV, 4096, 1241, 1), (fm.FLUX_DEV, 4096, 1241, 5),
         (fm.FLUX_FILL_DEV, 16384, 1241, 5)]


@pytest.mark.parametrize("cfg,s_img,s_txt,batch", CASES)
def test_flops_copy_matches_port(cfg, s_img, s_txt, batch):
    want = port_flops.flux_forward_flops(cfg, s_img, s_txt, batch)
    got = flux.forward_flops(dataclasses.asdict(cfg), s_img, s_txt, batch)
    for field in dataclasses.fields(want):
        assert got[field.name] == getattr(want, field.name)
    assert got["total"] == want.total


@pytest.mark.parametrize("cfg,s_img,s_txt,batch", CASES)
def test_gemm_list_prices_the_linear_flops(cfg, s_img, s_txt, batch):
    d = dataclasses.asdict(cfg)
    f = flux.forward_flops(d, s_img, s_txt, batch)
    linear = f["total"] - f["double_attn"] - f["single_attn"]
    got = sum(2 * m * k * n * calls
              for m, k, n, calls in flux.forward_gemms(d, s_img, s_txt,
                                                       batch))
    assert got == linear


def test_bounds_at_stage_sizes():
    # one-pass B1/B2 at stage 3's 5337 tokens is bound by its products;
    # a GEMV (M = 1) by its bytes
    s = 5337
    assert flops.attention_bound_s(1, s, 24, 128) == pytest.approx(
        4.0 * 24 * s * s * 128 / flops.PEAK_BF16)
    assert flops.gemm_bound_s([(1, 3072, 18432, 1)]) == pytest.approx(
        (3072 + 3072 * 18432 + 18432) * 2 / flops.PEAK_BYTES)
    assert flops.i8_attention_bound_s(1, s, True, 24, 128) < \
        flops.attention_bound_s(1, s, 24, 128)
