"""Random-matrix statistics underlying MSC (paper §II, Eq. 3–4).

Counterpart of `repro/core/stats.py`, in fp32 torch arithmetic.
"""
from __future__ import annotations

import torch

_F32 = torch.float32


def _f32(x, like=None):
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=_F32, device=dev)


def wishart_mu_sigma(m2, m3):
    """Centering μ and scale σ of the top Wishart eigenvalue (Eq. 4)."""
    a = torch.sqrt(_f32(m2) - 1.0)
    b = torch.sqrt(_f32(m3))
    mu = (a + b) ** 2
    sigma = torch.sqrt(mu) * (1.0 / a + 1.0 / b) ** (1.0 / 3.0)
    return mu, sigma


# Tracy–Widom F1 quantiles (beta=1), Bejan (2005).
_TW1_QUANTILES = {
    0.90: 0.4501,
    0.95: 0.9793,
    0.99: 2.0234,
    0.995: 2.4224,
    0.999: 3.2724,
}


def tw_threshold(m2, m3, quantile: float = 0.99):
    """λ above this value is significant at `quantile` under the noise law."""
    if quantile not in _TW1_QUANTILES:
        raise ValueError(
            f"quantile must be one of {sorted(_TW1_QUANTILES)}, got {quantile}")
    mu, sigma = wishart_mu_sigma(m2, m3)
    return mu + _TW1_QUANTILES[quantile] * sigma


def standardize_top_eig(lam, m2, m3):
    """(λ − μ)/σ → F1 in distribution (Eq. 3)."""
    mu, sigma = wishart_mu_sigma(m2, m3)
    return (lam - mu) / sigma


def theorem_threshold(l, m, epsilon):
    """RHS of Theorem II.1: l·ε/2 + sqrt(log(m − l)), with m − l ≥ 2.

    ε enters as a 0-d fp32 tensor on the host, which a device op reads as
    a scalar: no copy to the device, so the trim can be captured."""
    l = _f32(l, like=l)
    gap = torch.clamp(_f32(m, like=l) - l, min=2.0)
    return l * _f32(epsilon) / 2.0 + torch.sqrt(torch.log(gap))


def epsilon_ok(epsilon, m, l):
    """Whether ε satisfies sqrt(ε) ≤ 1/(m − l)."""
    return bool(torch.sqrt(_f32(epsilon))
                <= 1.0 / torch.clamp(_f32(m) - _f32(l), min=1.0))
