"""The plain reference agrees with the port's einsum path at small m on
the CPU, on both eigensolvers: the same sweeps and clusters, λ and d
within fp32 rounding."""
import numpy as np
import pytest
import torch

from harness import generate
from reference import msc as reference


def port_answers(tensor, settings):
    from repro_torch.core import MSCConfig, msc_sequential

    cfg = MSCConfig(**dict(settings, use_kernels=False))
    return msc_sequential(tensor, cfg, device="cpu").modes


@pytest.mark.parametrize("matrix_free", [True, False])
@pytest.mark.parametrize("m,gamma", [(24, 24.0), (30, 12.0), (40, 80.0)])
def test_reference_matches_port(m, gamma, matrix_free):
    l = max(1, m // 10)
    settings = dict(epsilon=0.5 / (m - l) ** 2, power_iters=60,
                    power_tol=1e-2, power_check_every=6, precision="fp32",
                    matrix_free=matrix_free, epilogue="allgather",
                    max_extraction_iters=m)
    for seed in (1, 2):
        t = generate.planted_pool(seed, {"pool": 1, "gamma": gamma}, m, l,
                                  "cpu")[0]
        want = port_answers(t, settings)
        got = reference.solve(t, settings)
        for g, w in zip(got, want):
            assert g.sweeps == int(w.power_iters_run)
            np.testing.assert_array_equal(g.mask, w.mask.numpy())
            np.testing.assert_allclose(g.lam, w.lambdas.numpy(), rtol=1e-5)
            np.testing.assert_allclose(g.d, w.d.numpy(), rtol=1e-5,
                                       atol=1e-5 * float(np.abs(g.d).max()))


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -12,
                      -1.0 - 2.0 ** -11])
    got = reference.tf32(x)
    # nearest, a tie away from zero
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -10,
                         -1.0 - 2.0 ** -10])
    assert torch.equal(got, want)


def test_extraction_trims_to_the_theorem():
    # the largest gap leaves {9, 8, 7}; their spread 2 exceeds
    # sqrt(log(5 - 3)) at ε = 0, so 7 goes; 1 is under sqrt(log(3))
    d = np.array([9.0, 8.0, 7.0, 1.0, 0.9], np.float32)
    assert reference.extract(d, epsilon=0.0).tolist() == [
        True, True, False, False, False]
