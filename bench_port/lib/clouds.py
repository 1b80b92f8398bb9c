"""Traffic generators: the inputs of every cell, made from the seed.

Frozen copies of the generators the port's smoke run uses
(``chip_smoke._cloud``, ``chip_smoke._certified_cloud``), generalised
over dimension and parameters, and the heat IBVP's cloud, which follows the
recipe of ``wlsqm_tpu_torch/examples/ibvp_heat.py`` grown to n points.
Everything is drawn with one ``torch.Generator`` on the target device in a
few large calls, so the same seed gives the same inputs and every seed
gives the same sizes.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def field(xk: torch.Tensor, xy: float) -> torch.Tensor:
    """sin 3x cos 2y + ``xy``·x y (y the last axis; in 1D y = x)."""
    x, y = xk[..., 0], xk[..., -1]
    return torch.sin(3.0 * x) * torch.cos(2.0 * y) + xy * x * y


def fit_batch(B: int, K: int, dim: int, traffic: dict, gen: torch.Generator, device):
    """One batch of fit cases: (xk (B, K, dim), fk (B, K), xi (B, dim)).

    ``traffic["geometry"]``:

    * ``"uniform"``: xi uniform in ``offset``·[-1, 1]^dim, the neighbours
      uniform in xi + ``radius``·[-1, 1]^dim (the headline cloud of the
      port's smoke run), fk = sin 3x cos 2y plus ``noise`` times a normal
      draw;
    * ``"log_radius"``: xi uniform in [-1, 1]^dim, each case's radius
      log-uniform in ``radii``, the neighbours uniform in xi + radius·[-1,
      1]^dim; a ``squeezed_share`` of the 2D cases squeezed to ``squeeze``
      of their extent across a random direction (the certified route's
      cloud); fk = sin 3x cos 2y + 0.3 x y, no noise.
    """
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device, dtype=F64)

    geometry = traffic["geometry"]
    if geometry == "uniform":
        radius, offset = traffic.get("radius", 1.0), traffic.get("offset", 0.0)
        xk = (rand(B, K, dim) * 2 - 1) * radius
        xi = (rand(B, dim) * 2 - 1) * offset
        xk += xi[:, None, :]
        fk = field(xk, 0.0)
        noise = traffic.get("noise", 0.0)
        if noise:
            fk += noise * torch.randn((B, K), generator=gen, device=device, dtype=F64)
        return xk, fk, xi
    if geometry == "log_radius":
        lo, hi = traffic["radii"]
        xi = rand(B, dim) * 2 - 1
        radius = torch.exp(math.log(lo) + rand(B) * math.log(hi / lo))
        d = (rand(B, K, dim) * 2 - 1) * radius[:, None, None]
        share = traffic.get("squeezed_share", 0.0)
        if share:
            if dim != 2:
                raise ValueError("squeezed cases are 2D only")
            squeezed = rand(B) < share
            angle = rand(B) * math.pi
            n = torch.stack([torch.cos(angle), torch.sin(angle)], dim=1)
            across = (d * n[:, None, :]).sum(-1, keepdim=True) * n[:, None, :]
            d = torch.where(squeezed[:, None, None],
                            d - (1.0 - traffic["squeeze"]) * across, d)
        xk = xi[:, None, :] + d
        return xk, field(xk, 0.3), xi
    raise ValueError("unknown geometry %r" % (geometry,))


def heat_cloud(n: int, traffic: dict, gen: torch.Generator, device):
    """The heat IBVP's cloud in the unit square, ``n`` points in all.

    As in the heat example: ``side`` = round(``side_factor``·√n) points on
    each edge (the four edges' end points repeated, as the example's
    ``linspace`` gives them), and the rest uniform in [m, 1 - m]^2, with m
    the example's margin of 0.02 at its 39 edge gaps kept as the same share
    of one edge gap.  Returns (points (n, 2) f64 on ``device``, interior
    (n,) bool).
    """
    side = int(round(traffic["side_factor"] * math.sqrt(n)))
    m = traffic["margin_gaps"] / (side - 1)
    n_int = n - 4 * side
    interior = m + (1 - 2 * m) * torch.rand((n_int, 2), generator=gen, device=device,
                                            dtype=F64)
    t = torch.linspace(0, 1, side, device=device, dtype=F64)
    zero, one = torch.zeros_like(t), torch.ones_like(t)
    boundary = torch.cat([torch.stack([t, zero], -1), torch.stack([t, one], -1),
                          torch.stack([zero, t], -1), torch.stack([one, t], -1)])
    pts = torch.cat([interior, boundary])
    is_int = torch.arange(n, device=device) < n_int
    return pts, is_int

