"""Seeded rows at the shape of UCI HIGGS: 28 dense float features (21
low-level kinematics, 7 derived invariant masses) and a binary label.

The distributions are assumed (the configuration lists them): transverse
momenta and masses log-normal, pseudo-rapidities normal within +-2.5,
azimuths uniform, b-tags on three values.  The label is drawn from a
logistic model of a few masses, b-tags and momenta, so trees have signal
to find.  Every seed draws the same sizes from the same distributions;
only the values differ.  Everything is drawn on ``device`` from one
``torch.Generator`` in a few large calls.
"""
from __future__ import annotations

import torch

#: column kinds in the UCI order: lepton (pt, eta, phi), missing energy
#: (pt, phi), four jets (pt, eta, phi, b-tag), seven masses
KINDS = (["pt", "eta", "phi", "pt", "phi"]
         + ["pt", "eta", "phi", "btag"] * 4 + ["mass"] * 7)
BTAG_VALUES = (0.0, 1.0868, 2.1735)
BTAG_SHARES = (0.5, 0.3, 0.2)


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def features(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """``(n, 28)`` float32 features."""
    F = len(KINDS)
    z = torch.randn((n, F), generator=gen, device=device)
    u = torch.rand((n, F), generator=gen, device=device)
    x = torch.empty((n, F), dtype=torch.float32, device=device)
    for f, kind in enumerate(KINDS):
        if kind == "pt":
            x[:, f] = torch.exp(0.55 * z[:, f])
        elif kind == "eta":
            x[:, f] = torch.clamp(z[:, f], -2.5, 2.5)
        elif kind == "phi":
            x[:, f] = (u[:, f] * 2.0 - 1.0) * 1.74
        elif kind == "btag":
            lo, hi = BTAG_SHARES[0], BTAG_SHARES[0] + BTAG_SHARES[1]
            x[:, f] = torch.where(
                u[:, f] < lo, BTAG_VALUES[0],
                torch.where(u[:, f] < hi, BTAG_VALUES[1], BTAG_VALUES[2]))
        else:
            x[:, f] = torch.exp(0.35 * z[:, f])
    return x


def label(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """``(n,)`` float32 0/1 labels from the planted logistic model."""
    m_bb, m_wbb, m_wwbb = x[:, 25], x[:, 26], x[:, 27]
    btags = x[:, 8] + x[:, 12]
    s = (0.9 - 3.0 * torch.log(m_bb).abs() + 0.8 * torch.log(m_wwbb)
         - 0.6 * torch.log(m_wbb).abs() + 0.35 * btags
         + 0.25 * torch.log(x[:, 5]) - 0.3 * x[:, 1].abs())
    u = torch.rand(s.shape, generator=gen, device=x.device)
    return (u < torch.sigmoid(s)).to(torch.float32)


def make(config: dict, seed: int, device) -> dict:
    """The configuration's training rows: ``X`` ``(n, 28)`` and ``y``."""
    gen = generator(seed, device)
    x = features(int(config["num_data"]), gen, device)
    return {"X": x, "y": label(x, gen)}


def rows(config: dict, seed: int, device, n: int) -> torch.Tensor:
    """``n`` fresh feature rows (scoring traffic), independent of
    ``make``'s rows for the same seed."""
    return features(n, generator(seed * 7919 + 17, device), device)


def quantile_table(config: dict, seed: int, device,
                   n: int = 1 << 16) -> torch.Tensor:
    """``(28, n)`` sorted feature values of a seeded sample: the empirical
    quantile function a generated model draws its thresholds from."""
    x = features(n, generator(seed * 104729 + 3, device), device)
    return torch.sort(x.t().contiguous(), dim=1).values

