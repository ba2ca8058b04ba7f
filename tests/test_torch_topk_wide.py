"""B8 above k = 256: ``topk_ip_fused`` takes any k >= 1, as the JAX
``topk_ip_pallas`` does (it pads k to a multiple of 128). Wider lists
take blocks of fewer query rows (and above k 1024 the scratch instead of
shared memory); on the card that is still one launch of B8, never another
route."""

import numpy as np
import pytest
import torch

from domainrag_tpu.ops import topk as jtopk
from domainrag_tpu_torch.ops import topk as ttopk


def test_wide_k_goes_to_b8_off_cpu(monkeypatch):
    """With B8's loader failing, k = 257, 500 and 1000 on a tensor off the
    CPU raise from the loader: no other route runs, nothing is counted."""
    def no_kernel():
        raise RuntimeError("no B8 kernel here")

    calls = []
    monkeypatch.setattr(ttopk, "_lib", no_kernel)
    monkeypatch.setattr(ttopk, "topk_ip", lambda *a: calls.append(a))
    monkeypatch.setattr(ttopk, "reference_topk_ip_fused",
                        lambda *a: calls.append(a))
    q = torch.empty(3, 16, device="meta")
    bank = torch.empty(520, 16, device="meta")
    launches = ttopk.topk_ip_fused.launches
    for k in (257, 500, 1000):
        with pytest.raises(RuntimeError, match="no B8 kernel"):
            ttopk.topk_ip_fused(q, bank, k)
    assert calls == []
    assert ttopk.topk_ip_fused.launches == launches


@pytest.mark.parametrize("k", [500, 1000])
def test_wide_k_matches_jax_pallas(k):
    """3 x 1500 x 32 integer-valued bank with a third of its rows
    duplicated (ties): on the CPU (B8's plain version) indices and scores
    equal to the JAX kernel in interpret mode, indices to ``topk_ip``."""
    rng = np.random.default_rng(k)
    bank = rng.integers(-3, 4, (1500, 32)).astype(np.float32)
    bank[500:1000] = bank[:500]
    q = rng.integers(-3, 4, (3, 32)).astype(np.float32)
    want_s, want_i = jtopk.topk_ip_pallas(q, bank, k, interpret=True)
    tq, tb = torch.from_numpy(q), torch.from_numpy(bank)
    got_s, got_i = ttopk.topk_ip_fused(tq, tb, k)
    assert got_s.shape == (3, k) and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_i.numpy(),
                                  ttopk.topk_ip(tq, tb, k)[1].numpy())
