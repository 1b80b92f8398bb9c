"""The frozen yardstick: traffic generators and bound arithmetic."""

import pytest
import torch

import bench_port_cases  # noqa: F401  (puts the repository on the path)
from bench_port.lib import bounds, clouds

FIT_MIXES = [
    {"geometry": "uniform", "radius": 1.0, "offset": 0.1, "noise": 0.01},
    {"geometry": "log_radius", "radii": [0.1, 1.0]},
    {"geometry": "log_radius", "radii": [0.1, 1.0], "squeezed_share": 0.05, "squeeze": 1e-3},
]


@pytest.mark.parametrize("mix", FIT_MIXES, ids=lambda m: m["geometry"] + str(len(m)))
def test_fit_batches_follow_the_seed(mix):
    def draw(seed):
        return clouds.fit_batch(512, 30, 2, mix, clouds.generator(seed, "cpu"), "cpu")

    a, b, c = draw(2**31 + 5), draw(2**31 + 5), draw(2**31 + 6)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y)
        assert x.shape == z.shape and not torch.equal(x, z)
    xk, fk, xi = a
    assert xk.shape == (512, 30, 2) and fk.shape == (512, 30) and xi.shape == (512, 2)
    assert torch.isfinite(fk).all()


def test_heat_cloud_follows_the_seed():
    mix = {"side_factor": 0.9, "margin_gaps": 0.78}

    def draw(seed):
        return clouds.heat_cloud(4096, mix, clouds.generator(seed, "cpu"), "cpu")

    (p1, i1), (p2, i2), (p3, i3) = draw(11), draw(11), draw(12)
    assert torch.equal(p1, p2) and torch.equal(i1, i2) and torch.equal(i1, i3)
    assert p1.shape == (4096, 2) and not torch.equal(p1, p3)
    side = round(0.9 * 64)
    assert int((~i1).sum()) == 4 * side
    assert float(p1.min()) == 0.0 and float(p1.max()) == 1.0


def test_bounds_reproduce_the_kernel_tables_bounds():
    """PERF.md's kernel table: the headline K1 launch at 2^23 (2.15 ms,
    bytes), the sens K2 launch at 2^21 (3.08 ms, operations), the heat
    gather at n = 2^22, K = 28 (0.431 ms, bytes)."""
    k1 = bounds.moment_launch(1 << 23, 30, 2, 4, True, 1)
    k2 = bounds.rows_launch(1 << 21, 30, 2, 4, True, 1, True)
    k4 = bounds.gather_launch(1 << 22, (1 << 22) * 28, 8)
    assert (round(k1["bound_ms"], 2), k1["bound_by"]) == (2.15, "bytes")
    assert (round(k2["bound_ms"], 2), k2["bound_by"]) == (3.08, "operations")
    assert (round(k4["bound_ms"], 3), k4["bound_by"]) == (0.431, "bytes")


def test_moment_count_is_the_lattice_size():
    assert bounds.moment_count(2, 8) == 45
    assert bounds.moment_count(1, 8) == 9
