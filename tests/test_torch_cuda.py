"""The CUDA kernels on the card: against their plain versions, and on the route.

These tests need an NVIDIA card, nvcc and no JAX; here they skip.  On the
card run them without the JAX test fixtures:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerance 1e-10 relative to max(|ref|, 1) per case: each kernel and its
plain version compute the same sums in another order (and with FMA
contraction), which differs by ~cond * eps; nk >= 1.5 NO keeps cond modest.
ALGO_ITERATIVE counts are decided by exact-stagnation ties, so they are held
pooled over the grid: >= 50% equal, >= 80% within one, and per-configuration
count histograms at most 0.1 apart (summed |difference| / 2 over all cases;
chip_smoke.py checks that no constant count passes this bar).  The rows kernel against its
plain version measured 57% and 88% over the 2D grid on an H100: FMA
contraction and the summation order move the last bit of the residual
norms, and with it the tie.  Data fk = 0 has no tie: both stop after one
trip.  The gather kernel copies words, so it is held to ``u[idx]`` bit for
bit (``torch.equal`` on integer views).  With ``emit_cond`` both fit kernels
also write the conditioning key: held to the plain version's key at 1e-6
relative (its own sensitivity is ~cond * 2^-53), and every other output to the
bits of the launch without the key.
"""

import numpy as np
import pytest
import torch

import wlsqm_tpu_torch as wtt
from wlsqm_tpu_torch.examples import ibvp_heat
from wlsqm_tpu_torch.ops import fit_kernel, fit_rows, gather

pytestmark = pytest.mark.cuda

PARITY = 1e-10


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _cloud(dev, B, K, order, seed, dim=2, lo=None, ragged=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    xk = torch.rand((B, K, dim), generator=g, device=dev, dtype=torch.float64) * 2 - 1
    xi = (torch.rand((B, dim), generator=g, device=dev, dtype=torch.float64) - 0.5) * 0.2
    xk = xk + xi[:, None, :]
    fk = torch.sin(3 * xk[..., 0]) * torch.cos(2 * xk[..., -1])
    if lo is None:
        lo = (3 * wtt.number_of_dofs(dim, order)) // 2
    nk = torch.randint(min(lo, K), K + 1, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    nk[::2] = K
    if not ragged:
        nk[:] = K
    pad = torch.arange(K, device=dev)[None, :] >= nk[:, None]
    xk[pad] = torch.nan
    fk = fk.masked_fill(pad, torch.nan)
    return xk, fk, nk, xi


def _rel_cases(a, b):
    """Per-case L-inf error relative to max(|ref|, 1)."""
    return (a - b).abs().amax(1) / b.abs().amax(1).clamp_min(1.0)


def _rel(a, b):
    return _rel_cases(a, b).max().item()


#: past the certified key edge a kernel and its plain version differ by
#: roundoff times the conditioning: held to KEY_EPS * key (2^-50 a unit of key),
#: at most KEY_CAP, and the kernel within PARITY of the long-double-refined
#: oracle or at most ORACLE_FACTOR times the plain version's own error there
KEY_EPS = 2.0 ** -50
KEY_CAP = 1e-9
ORACLE_FACTOR = 4.0


@pytest.mark.parametrize("weighting", [wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER])
@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
def test_kernel_matches_plain(dev, order, weighting):
    xk, fk, nk, xi = _cloud(dev, 4096, 30, order, seed=order)
    before = fit_kernel.LAUNCHES
    got = fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=2, order=order,
                                weighting=weighting)
    torch.cuda.synchronize()
    assert fit_kernel.LAUNCHES == before + 1
    ref = fit_kernel.fit_moments_plain(xk, fk, nk, xi, dimension=2, order=order,
                                       weighting=weighting)
    assert torch.isfinite(got).all()
    assert _rel(got, ref) <= PARITY


def test_cuda_call_never_runs_the_plain_version(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(fit_kernel, "fit_moments_plain", boom)
    monkeypatch.setattr(fit_kernel, "_solve_moments", boom)
    xk, fk, nk, xi = _cloud(dev, 1000, 30, 4, seed=9)
    before = fit_kernel.LAUNCHES
    fi = fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=2, order=4,
                               weighting=wtt.WEIGHT_CENTER)
    torch.cuda.synchronize()
    assert fit_kernel.LAUNCHES == before + 1
    assert torch.isfinite(fi).all()


def test_kernel_rejects_what_it_does_not_cover(dev):
    xk, fk, nk, xi = _cloud(dev, 256, 30, 4, seed=1)
    with pytest.raises(ValueError):
        fit_kernel._launch(xk, fk, nk, xi, torch.empty(
            (256, 15), dtype=torch.float64, device=dev), order=4, weighting=3,
            refine_steps=1)
    with pytest.raises(ValueError):
        fit_kernel.fit_kernel(xk.float(), fk, nk, xi, dimension=2, order=4,
                              weighting=wtt.WEIGHT_CENTER)


def _adversarial_scale_cloud(dev, B, K):
    """Clouds whose h² is an exact power of four, one ulp either side of it
    (where ceil(0.5 log2) and an exact frexp rule part), nk = 0, and NaN in
    the padded slots."""
    g = torch.Generator(device=dev).manual_seed(11)
    xk = torch.rand((B, K, 2), generator=g, device=dev, dtype=torch.float64) * 2 - 1
    xi = torch.rand((B, 2), generator=g, device=dev, dtype=torch.float64) * 0.1
    nk = torch.randint(1, K + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    xk = xk + xi[:, None, :]
    m = min(B, 3 * 64)
    xi[:m] = 0.0                          # offsets exact: xk - xi == xk
    h = torch.ldexp(torch.ones(m, dtype=torch.float64, device=dev),
                    torch.arange(m, device=dev) % 64 - 32)
    step = torch.tensor([-1, 0, 1], device=dev).repeat_interleave(64)[:m]
    # xk[:, 0] - xi at h along x: h² = 4^e exactly; then one ulp below and above
    xk[:m, 0, 0] = torch.nextafter(h, h + step.to(torch.float64))
    xk[:m, 0, 1] = 0.0
    xk[:m, 1:] = (xk[:m, 1:] - xi[m:2 * m, None, :]) * 1e-3 * h[:, None, None]
    nk[m:m + 64] = 0
    pad = torch.arange(K, device=dev)[None, :] >= nk[:, None]
    xk[pad] = torch.nan
    return xk, nk, xi


def test_kernel_scale_is_prescale_bit_for_bit(dev):
    """The kernel's own e_s and inv_s (wlsqm_moment_scale runs the fit's
    device functions alone) equal _prescale's bit for bit on 2^23 cases and
    on the adversarial ones (powers of four and an ulp either side, nk = 0,
    NaN padding)."""
    for B, K, adversarial, dim in ((1 << 23, 30, False, 2), (8192, 30, True, 2),
                                   (4096, 53, True, 2), (1 << 20, 16, False, 1),
                                   (1 << 20, 48, False, 3)):
        if adversarial:
            xk, nk, xi = _adversarial_scale_cloud(dev, B, K)
        else:
            xk, _, nk, xi = _cloud(dev, B, K, 4, seed=12 + dim, dim=dim)
        e, inv_s = fit_kernel.moment_scale(xk, nk, xi)
        _, _, e_ref, inv_ref = fit_kernel._prescale(xk, nk, xi)
        torch.cuda.synchronize()
        assert torch.equal(_bits(e), _bits(e_ref)), (B, K)
        assert torch.equal(_bits(inv_s), _bits(inv_ref)), (B, K)
        del xk, nk, xi, e, inv_s, e_ref, inv_ref


@pytest.mark.parametrize("K", [30, 53, 151, 160])
@pytest.mark.parametrize("weighting", [wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER])
def test_kernel_scales_and_descales_itself(dev, K, weighting):
    """fit_kernel on the card at orders 0-4, ragged nk with NaN padding, K =
    30 and 53 (the slab staging takes any K), 151 (the slabs fill a block's
    227 KB of shared memory) and 160 (past it: the walks read global
    memory): within PARITY of the plain version, fi the same bits with and
    without the key, a replay the same bits, and the input slices of an odd
    offset (8-byte aligned slabs) too."""
    for order in range(5):
        xk, fk, nk, xi = _cloud(dev, 4099, K, order, seed=20 + order + K)
        kw = dict(dimension=2, order=order, weighting=weighting)
        fi0 = fit_kernel.fit_kernel(xk, fk, nk, xi, **kw)
        fi1, _ = fit_kernel.fit_kernel(xk, fk, nk, xi, emit_cond=True, **kw)
        fi2 = fit_kernel.fit_kernel(xk, fk, nk, xi, **kw)
        odd = fit_kernel.fit_kernel(xk[1:], fk[1:], nk[1:], xi[1:], **kw)
        torch.cuda.synchronize()
        ref = fit_kernel.fit_moments_plain(xk, fk, nk, xi, **kw)
        assert torch.isfinite(fi0).all()
        assert _rel(fi0, ref) <= PARITY, (order, weighting, K)
        assert torch.equal(_bits(fi0), _bits(fi1)) and torch.equal(_bits(fi0), _bits(fi2))
        assert torch.equal(_bits(odd), _bits(fi0[1:]))


def test_planned_route_launches_the_kernel(dev):
    xk, fk, nk, xi = _cloud(dev, 8192, 30, 4, seed=2, ragged=False)   # certified whole
    plan = wtt.plan_fit_many(xk, xi, order=4, weighting=wtt.WEIGHT_CENTER)
    assert plan.route.path == "kernel"
    before = fit_kernel.LAUNCHES
    res = wtt.fit_many(xk, fk, xi, nk=nk, order=4, weighting=wtt.WEIGHT_CENTER,
                       plan=plan)
    eng = wtt.fit_many(xk, fk, xi, nk=nk, order=4, weighting=wtt.WEIGHT_CENTER,
                       backend="engine")
    torch.cuda.synchronize()
    assert fit_kernel.LAUNCHES == before + 1
    assert res.fi.device.type == "cuda"
    assert _rel(res.fi, eng.fi) <= PARITY


# ---------------------------------------------------------------------------
# The rows kernel (csrc/fit_rows.cu)
# ---------------------------------------------------------------------------

K_BY_DIM = {1: 16, 2: 30, 3: 56}


def _bits(t):
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def _rel_nan(a, b):
    """_rel with NaN required at the same places in both (known sens columns)."""
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    a, b = (torch.nan_to_num(x).reshape(len(x), -1) for x in (a, b))
    return _rel(a, b)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_rows_kernel_matches_plain(dev, dim):
    """Every order and weighting, with sens, a random knowns mask and
    max_iter 3; counts pooled over the dimension's grid.  1D keeps nk >= 2 NO
    (chip_smoke.py's phase_rows_vs_plain says why)."""
    g = torch.Generator().manual_seed(dim)
    equal = within = apart = total = 0
    for order in range(5):
        NO = wtt.number_of_dofs(dim, order)
        for w in (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER):
            xk, fk, nk, xi = _cloud(dev, 2048, K_BY_DIM[dim], order, 10 * order + w, dim,
                                    lo=2 * NO if dim == 1 else None)
            fi0 = torch.randn((2048, NO), dtype=torch.float64, device=dev)
            kn = int(torch.randint(0, 1 << NO, (1,), generator=g))
            for knowns, sens, max_iter in ((0, True, 0), (kn, True, 0), (kn, False, 3)):
                kw = dict(dimension=dim, order=order, weighting=w, knowns=knowns,
                          do_sens=sens, max_iter=max_iter)
                before = fit_rows.LAUNCHES
                got = fit_rows.fit_rows(xk, fk, nk, xi, fi0, **kw)
                torch.cuda.synchronize()
                assert fit_rows.LAUNCHES == before + 1
                ref = fit_rows.fit_rows_plain(xk, fk, nk, xi, fi0, **kw)
                assert torch.isfinite(got[0]).all()
                assert _rel(got[0], ref[0]) <= PARITY, (order, w, knowns, sens, max_iter)
                if sens:
                    assert _rel_nan(got[2], ref[2]) <= PARITY
                KN = fit_rows.known_dofs(knowns, dim, order)
                assert torch.equal(got[0][:, KN], fi0[:, KN])
                if max_iter:
                    assert 1 <= int(got[1].min()) and int(got[1].max()) <= max_iter
                    equal += int((got[1] == ref[1]).sum())
                    within += int(((got[1] - ref[1]).abs() <= 1).sum())
                    apart += int((torch.bincount(got[1], minlength=4)
                                  - torch.bincount(ref[1], minlength=4)).abs().sum()) // 2
                    total += got[1].numel()
                    zero = dict(kw, knowns=0)
                    fi_z, it_z, _ = fit_rows.fit_rows(xk, fk * 0.0, nk, xi, **zero)
                    assert (it_z == 1).all() and (fi_z == 0).all()
    assert equal / total >= 0.5 and within / total >= 0.8 and apart / total <= 0.1


def _rows_layout(dim, K):
    """The rows library's thread-body layout for (dim, K): the doubles a
    case stages (0: nothing staged), cases a block, shared memory a block."""
    import ctypes

    out = (ctypes.c_int * 3)()
    assert fit_rows.load().lib.wlsqm_rows_thread_layout(dim, K, out) == 0
    return tuple(out)


def _count_tally(got, ref):
    """ALGO_ITERATIVE counts against a reference's: (equal, within one,
    histogram distance), each a count of cases."""
    apart = (torch.bincount(got, minlength=4) - torch.bincount(ref, minlength=4)).abs()
    return (int((got == ref).sum()), int(((got - ref).abs() <= 1).sum()),
            int(apart.sum()) // 2)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_rows_thread_body_layouts_match_plain(dev, dim):
    """Every thread-body (dim, order) at the largest K whose offsets are
    staged (the library's thread layout) and one past it (nothing staged),
    ragged nk with NaN padding, both weightings, a random knowns mask and
    max_iter 3: with sens (the staged instance where the layout stages) fi
    and sens against the plain version (1e-10), and fi and the counts bit
    for bit those of the same launch without sens (the instance that stages
    nothing; the sens loop runs after both are written).

    Counts against the plain version, pooled over orders and weightings at
    each K: >= 50% equal and >= 80% within one, and a histogram distance no
    larger than the launch without sens reads against the same plain counts.
    That launch is the design before the staged one; at these K its distance
    reads 0.12-0.13 on an H100 against these clouds' plain counts, above the
    0.1 bar of test_rows_kernel_matches_plain, so it is the reading here.
    ROADMAP C7 (a held bar): chip_smoke.measure_count_ties found 95-99.9% of
    the count disagreements to be exact-stagnation ties (one side's norm
    repeats, the other's moves by at most 4 ulps; the rest by 5-16), and the
    histogram distance growing with K (2D 0.050 / 0.086 / 0.101 at K = 30 /
    63 / 130)."""
    g = torch.Generator().manual_seed(100 + dim)
    edge = max(K for K in range(1, 200) if _rows_layout(dim, K)[0])
    for K in (edge, edge + 1):
        staged_tally, unstaged_tally, total = [0, 0, 0], [0, 0, 0], 0
        for order in range(5):
            if fit_rows.warp_body(dim, order):
                continue
            NO = wtt.number_of_dofs(dim, order)
            for w in (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER):
                xk, fk, nk, xi = _cloud(dev, 1031, K, order, K + w, dim,
                                        lo=2 * NO if dim == 1 else None)
                fi0 = torch.randn((1031, NO), dtype=torch.float64, device=dev)
                kn = int(torch.randint(0, 1 << NO, (1,), generator=g))
                kw = dict(dimension=dim, order=order, weighting=w, knowns=kn, max_iter=3)
                staged = fit_rows.fit_rows(xk, fk, nk, xi, fi0, do_sens=True, **kw)
                unstaged = fit_rows.fit_rows(xk, fk, nk, xi, fi0, **kw)
                ref = fit_rows.fit_rows_plain(xk, fk, nk, xi, fi0, do_sens=True, **kw)
                torch.cuda.synchronize()
                assert _rel(staged[0], ref[0]) <= PARITY, (order, K, w)
                assert _rel_nan(staged[2], ref[2]) <= PARITY, (order, K, w)
                assert 1 <= int(staged[1].min()) and int(staged[1].max()) <= 3
                assert torch.equal(_bits(staged[0]), _bits(unstaged[0])), (order, K, w)
                assert torch.equal(staged[1], unstaged[1]), (order, K, w)
                for tally, got in ((staged_tally, staged[1]), (unstaged_tally, unstaged[1])):
                    for i, v in enumerate(_count_tally(got, ref[1])):
                        tally[i] += v
                total += ref[1].numel()
        equal, within, apart = staged_tally
        assert equal / total >= 0.5 and within / total >= 0.8, (K, staged_tally, total)
        assert apart <= unstaged_tally[2], (K, staged_tally, unstaged_tally, total)


def test_rows_thread_layout_stages_the_measured_configurations(dev):
    """The library's thread layout: a case's offsets, fk and weights
    (K (dim + 2) doubles) in an odd number of doubles while 64 cases of
    them fit 128 KB, else nothing staged.  The adjoint step's launch (2D,
    K = 12) and the rows cut's NO = 10 ones (2D at K = 30, 3D at K = 48)
    stage; the wide K and 3D's grid K do not; the staging edges are K = 85,
    63 and 51 in 1D, 2D and 3D."""
    for dim in (1, 2, 3):
        for K in (*range(0, 90), 130, 152, 400):
            ld, cases, budget = _rows_layout(dim, K)
            assert (cases, budget) == (64, 128 * 1024)
            assert ld == (0 if K * (dim + 2) > budget // (8 * cases) - 1 else (K * (dim + 2)) | 1)
            assert 8 * cases * ld <= budget
    assert [_rows_layout(*c)[0] for c in ((2, 12), (2, 30), (3, 48))] == [49, 121, 241]
    assert _rows_layout(2, 130)[0] == _rows_layout(3, 56)[0] == 0
    for dim, edge in ((1, 85), (2, 63), (3, 51)):
        assert _rows_layout(dim, edge)[0] and not _rows_layout(dim, edge + 1)[0]


def test_rows_cuda_call_never_runs_the_plain_version(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(fit_rows, "fit_rows_plain", boom)
    monkeypatch.setattr(fit_rows, "_solve_rows", boom)
    xk, fk, nk, xi = _cloud(dev, 1000, 30, 4, seed=9)
    before = fit_rows.LAUNCHES
    fi, _, sens = fit_rows.fit_rows(xk, fk, nk, xi, dimension=2, order=4,
                                    weighting=wtt.WEIGHT_CENTER, do_sens=True)
    torch.cuda.synchronize()
    assert fit_rows.LAUNCHES == before + 1
    assert torch.isfinite(fi).all() and torch.isfinite(sens).all()


def test_rows_kernel_rejects_what_it_does_not_cover(dev):
    """A CUDA tensor with a configuration no kernel covers raises; nothing
    falls back to the plain version or the engine."""
    xk, fk, nk, xi = _cloud(dev, 256, 30, 4, seed=1)
    before = fit_rows.LAUNCHES
    with pytest.raises(ValueError):
        fit_rows.fit_rows(xk, fk, nk, xi, dimension=2, order=5, weighting=1)
    with pytest.raises(ValueError):
        fit_rows.fit_rows(xk, fk, nk, xi, dimension=2, order=4, weighting=3)
    with pytest.raises(ValueError):
        fit_rows.fit_rows(xk.float(), fk, nk, xi, dimension=2, order=4, weighting=1)
    with pytest.raises(ValueError):
        wtt.fit_many(xk, fk, xi, nk=nk, order=torch.tensor([4, 3] * 128, device=dev),
                     backend="kernel")
    assert fit_rows.LAUNCHES == before


def test_sens_route_launches_the_rows_kernel(dev):
    xk, fk, nk, xi = _cloud(dev, 8192, 30, 4, seed=3, ragged=False)   # certified whole
    kw = dict(order=4, weighting=wtt.WEIGHT_CENTER, do_sens=True)
    plan = wtt.plan_fit_many(xk, xi, **kw)
    assert (plan.route.path, plan.route.assembly) == ("kernel", "rows")
    before = fit_kernel.LAUNCHES, fit_rows.LAUNCHES
    res = wtt.fit_many(xk, fk, xi, nk=nk, plan=plan, **kw)
    torch.cuda.synchronize()
    assert (fit_kernel.LAUNCHES, fit_rows.LAUNCHES) == (before[0], before[1] + 1)
    eng = wtt.fit_many(xk, fk, xi, nk=nk, backend="engine", **kw)
    assert res.fi.device.type == "cuda" and res.sens.shape == (8192, 30, 15)
    assert _rel(res.fi, eng.fi) <= PARITY
    assert _rel(res.sens.reshape(8192, -1), eng.sens.reshape(8192, -1)) <= PARITY


def test_auto_routes_knowns_dim3_and_iterative_to_the_rows_kernel(dev):
    xk, fk, nk, xi = _cloud(dev, 4096, 56, 4, seed=4, dim=3)
    before = fit_rows.LAUNCHES
    res = wtt.fit_many(xk, fk, xi, nk=nk, order=4, weighting=wtt.WEIGHT_CENTER)
    it = wtt.fit_many(xk, fk, xi, nk=nk, order=3, knowns=1, iterative=True,
                      max_iter=3, fi_init=torch.ones((4096, 20), dtype=torch.float64,
                                                     device=dev))
    torch.cuda.synchronize()
    assert fit_rows.LAUNCHES == before + 2
    eng = wtt.fit_many(xk, fk, xi, nk=nk, order=4, weighting=wtt.WEIGHT_CENTER,
                       backend="engine")
    assert _rel(res.fi, eng.fi) <= PARITY
    assert (it.fi[:, 0] == 1).all() and int(it.iterations.min()) >= 1


def test_diffable_on_the_card(dev):
    xk, fk, nk, xi = _cloud(dev, 512, 30, 3, seed=5)
    fk = fk.nan_to_num().requires_grad_(True)
    fi = fit_rows.fit_rows_diffable(xk, fk, nk, xi, dimension=2, order=3,
                                    weighting=wtt.WEIGHT_CENTER)
    g = torch.randn_like(fi)
    (fi * g).sum().backward()
    _, _, sens = fit_rows.fit_rows_plain(xk, fk.detach(), nk, xi, dimension=2,
                                         order=3, weighting=wtt.WEIGHT_CENTER,
                                         do_sens=True)
    ref = torch.einsum("bkj,bj->bk", sens, g)
    assert _rel(fk.grad, ref) <= PARITY


def _warp_configs():
    """Every (dim, order) that the cut sends to the warp body."""
    return [(d, o) for d in (1, 2, 3) for o in range(5) if fit_rows.warp_body(d, o)]


@pytest.mark.parametrize("K", [53, 56, 130])
def test_warp_body_matches_plain(dev, K):
    """The warp body at every (dim, order) it takes (3D orders 3 and 4
    among them), both weightings: with sens, with a random knowns mask (and
    sens), with max_iter 3 (and the mask); ragged nk >= 1.5 NO with NaN in
    the padded slots; K = 53 (no multiple of 4), 56, 130 (above one chunk).
    Counts: in [1, max_iter], within one of the plain count on >= 80% of
    the cases pooled over these configurations, and exactly 1 (fi exactly
    0) on fk = 0.  The equal share and the histogram distance are held
    pooled over the whole grid, where these configurations sit beside the
    thread body's (test_rows_kernel_matches_plain, chip_smoke's
    phase_rows_vs_plain): the kernel takes more trips than its plain
    version on every configuration of either body, by 0.03-0.16 of the
    cases per configuration on an H100 (chip_smoke's per-configuration
    histograms), and the warp body's configurations sit inside that spread."""
    g = torch.Generator().manual_seed(K)
    within = total = 0
    for dim, order in _warp_configs():
        NO = wtt.number_of_dofs(dim, order)
        for w in (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER):
            xk, fk, nk, xi = _cloud(dev, 1024, K, order, 7 * K + 10 * order + w, dim)
            assert bool(torch.isnan(xk).any())
            fi0 = torch.randn((1024, NO), dtype=torch.float64, device=dev)
            kn = int(torch.randint(0, 1 << NO, (1,), generator=g))
            for knowns, sens, max_iter in ((0, True, 0), (kn, True, 0), (kn, False, 3)):
                kw = dict(dimension=dim, order=order, weighting=w, knowns=knowns,
                          do_sens=sens, max_iter=max_iter)
                before = fit_rows.LAUNCHES
                got = fit_rows.fit_rows(xk, fk, nk, xi, fi0, **kw)
                torch.cuda.synchronize()
                assert fit_rows.LAUNCHES == before + 1
                ref = fit_rows.fit_rows_plain(xk, fk, nk, xi, fi0, **kw)
                assert torch.isfinite(got[0]).all()
                assert _rel(got[0], ref[0]) <= PARITY, (dim, order, w, knowns, sens, max_iter)
                if sens:
                    assert _rel_nan(got[2], ref[2]) <= PARITY
                    pad = torch.arange(K, device=dev)[None, :] >= nk[:, None]
                    assert (torch.nan_to_num(got[2])[pad] == 0).all()   # NaN: known DOFs
                KN = fit_rows.known_dofs(knowns, dim, order)
                assert torch.equal(got[0][:, KN], fi0[:, KN])
                if max_iter:
                    assert 1 <= int(got[1].min()) and int(got[1].max()) <= max_iter
                    within += int(((got[1] - ref[1]).abs() <= 1).sum())
                    total += got[1].numel()
                    zero = dict(kw, knowns=0)
                    fi_z, it_z, _ = fit_rows.fit_rows(xk, fk * 0.0, nk, xi, **zero)
                    assert (it_z == 1).all() and (fi_z == 0).all()
    assert within / total >= 0.8


COUNT_SLACK = 0.01   # kernel vs plain, each against the JAX engine's counts


def test_iterative_counts_against_the_jax_engine(dev, capsys):
    """ROADMAP C2: on the seeded clouds of tests/iterative_counts.py (the
    rows grid's and the warp configurations' sizes) the kernel's
    ALGO_ITERATIVE counts are no farther from the JAX f64 engine's stored
    counts than the plain version's: pooled histogram distance and equal
    share within COUNT_SLACK of the plain version's; DOFs within PARITY."""
    import iterative_counts

    stored = iterative_counts.load()
    got = {"kernel": [], "plain": []}
    ref = []
    for key, dim, order, w, B, K, seed in iterative_counts.configs():
        xk, fk, nk, xi, fi0, kn = (torch.as_tensor(a, device=dev) if isinstance(a, np.ndarray)
                                   else a for a in iterative_counts.cloud(dim, order, B, K, seed))
        kw = dict(dimension=dim, order=order, weighting=w, knowns=kn,
                  max_iter=iterative_counts.MAX_ITER)
        fi_k, it_k, _ = fit_rows.fit_rows(xk, fk, nk, xi, fi0, **kw)
        fi_p, it_p, _ = fit_rows.fit_rows_plain(xk, fk, nk, xi, fi0, **kw)
        assert _rel(fi_k, fi_p) <= PARITY, key
        got["kernel"].append(it_k.cpu().numpy())
        got["plain"].append(it_p.cpu().numpy())
        ref.append(stored[key])
    k = iterative_counts.shares(got["kernel"], ref)
    p = iterative_counts.shares(got["plain"], ref)
    with capsys.disabled():
        print("\ncounts vs JAX (equal, within one, histogram distance): kernel %s, plain %s"
              % (k, p))
    assert k[2] <= p[2] + COUNT_SLACK and k[0] >= p[0] - COUNT_SLACK


@pytest.mark.parametrize("K", [53, 130])
def test_warp_body_key_and_bits(dev, K):
    """The warp body with emit_cond: the key against the plain key; fi, sens
    and the counts the same bits with and without it; two launches equal bit
    for bit."""
    g = torch.Generator().manual_seed(100 + K)
    for dim, order in _warp_configs():
        NO = wtt.number_of_dofs(dim, order)
        xk, fk, nk, xi = _cloud(dev, 1024, K, order, 3 * K + order, dim)
        fi0 = torch.randn((1024, NO), dtype=torch.float64, device=dev)
        kw = dict(dimension=dim, order=order, weighting=wtt.WEIGHT_CENTER,
                  knowns=int(torch.randint(0, 1 << NO, (1,), generator=g)))
        for extra in ({}, dict(do_sens=True), dict(max_iter=3)):
            a = fit_rows.fit_rows(xk, fk, nk, xi, fi0, **kw, **extra)
            b = fit_rows.fit_rows(xk, fk, nk, xi, fi0, emit_cond=True, **kw, **extra)
            c = fit_rows.fit_rows(xk, fk, nk, xi, fi0, emit_cond=True, **kw, **extra)
            torch.cuda.synchronize()
            for x, y, z in zip(a, b, c):
                assert (x is None) == (y is None) == (z is None)
                if x is not None:
                    bits = [_bits(v) if v.dtype.is_floating_point else v for v in (x, y, z)]
                    assert torch.equal(bits[0], bits[1]) and torch.equal(bits[1], bits[2])
            assert torch.equal(_bits(b[3]), _bits(c[3]))
            _key_agrees(b[3], fit_rows.fit_rows_plain(xk, fk, nk, xi, fi0, emit_cond=True,
                                                      **kw)[3])


# ---------------------------------------------------------------------------
# The conditioning key (emit_cond, in both fit kernels)
# ---------------------------------------------------------------------------

KEY_TOL = 1e-6      # kernel key vs plain key, relative: its own sensitivity is ~cond * 2^-53


def _key_agrees(key, ref):
    fin = torch.isfinite(ref)
    assert torch.equal(fin, torch.isfinite(key))
    assert ((key[fin] - ref[fin]).abs() / ref[fin]).max().item() <= KEY_TOL


@pytest.mark.parametrize("weighting", [wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER])
@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
def test_kernel_key_matches_plain(dev, order, weighting):
    """The moment kernel with emit_cond: the key against the plain version's,
    and fi the same bits as without the key."""
    xk, fk, nk, xi = _cloud(dev, 4096, 30, order, seed=50 + order)
    kw = dict(dimension=2, order=order, weighting=weighting)
    before = fit_kernel.LAUNCHES, fit_kernel.COND_LAUNCHES
    fi0 = fit_kernel.fit_kernel(xk, fk, nk, xi, **kw)
    fi1, key = fit_kernel.fit_kernel(xk, fk, nk, xi, emit_cond=True, **kw)
    torch.cuda.synchronize()
    assert (fit_kernel.LAUNCHES, fit_kernel.COND_LAUNCHES) == (before[0] + 2, before[1] + 1)
    assert torch.equal(fi0, fi1)
    _key_agrees(key, fit_kernel.fit_moments_plain(xk, fk, nk, xi, emit_cond=True, **kw)[1])


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_rows_kernel_key_matches_plain(dev, dim):
    """The rows kernel with emit_cond over every order, with a random knowns
    mask: the key against the plain version's; the same key bits and the same
    other outputs for the basic fit, with sens and with ALGO_ITERATIVE."""
    g = torch.Generator().manual_seed(70 + dim)
    for order in range(5):
        NO = wtt.number_of_dofs(dim, order)
        w = wtt.WEIGHT_CENTER if (dim + order) % 2 else wtt.WEIGHT_UNIFORM
        xk, fk, nk, xi = _cloud(dev, 2048, K_BY_DIM[dim], order, 60 + order, dim,
                                lo=2 * NO if dim == 1 else None)
        fi0 = torch.randn((2048, NO), dtype=torch.float64, device=dev)
        kn = int(torch.randint(0, 1 << NO, (1,), generator=g))
        kw = dict(dimension=dim, order=order, weighting=w, knowns=kn)
        keys = []
        for extra in ({}, dict(do_sens=True), dict(max_iter=3)):
            before = fit_rows.COND_LAUNCHES
            a = fit_rows.fit_rows(xk, fk, nk, xi, fi0, **kw, **extra)
            b = fit_rows.fit_rows(xk, fk, nk, xi, fi0, emit_cond=True, **kw, **extra)
            torch.cuda.synchronize()
            assert fit_rows.COND_LAUNCHES == before + 1
            for x, y in zip(a, b[:3]):
                assert (x is None) == (y is None)
                if x is not None:
                    assert torch.equal(_bits(x) if x.dtype.is_floating_point else x,
                                       _bits(y) if y.dtype.is_floating_point else y)
            keys.append(b[3])
        assert torch.equal(_bits(keys[0]), _bits(keys[1]))
        assert torch.equal(_bits(keys[0]), _bits(keys[2]))
        _key_agrees(keys[0], fit_rows.fit_rows_plain(xk, fk, nk, xi, fi0, emit_cond=True,
                                                     **kw)[3])


@pytest.mark.parametrize("dim, K", [(2, 30), (3, 56)])
def test_rows_blocked_key_matches_plain_at_order4(dev, dim, K):
    """The warp body's key by 8 x 8 blocks of L^-1 on the tensor cores (2D
    and 3D order 4, both weightings, ragged nk with NaN padding): within
    KEY_TOL of the plain key, a replay the same bits, fi the same bits as
    without the key."""
    for w in (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER):
        xk, fk, nk, xi = _cloud(dev, 4096, K, 4, seed=90 + 10 * dim + w, dim=dim)
        kw = dict(dimension=dim, order=4, weighting=w)
        fi0 = fit_rows.fit_rows(xk, fk, nk, xi, **kw)[0]
        fi1, _, _, key = fit_rows.fit_rows(xk, fk, nk, xi, emit_cond=True, **kw)
        key2 = fit_rows.fit_rows(xk, fk, nk, xi, emit_cond=True, **kw)[3]
        torch.cuda.synchronize()
        assert torch.equal(_bits(fi0), _bits(fi1)) and torch.equal(_bits(key), _bits(key2))
        _key_agrees(key, fit_rows.fit_rows_plain(xk, fk, nk, xi, emit_cond=True, **kw)[3])


def test_key_bounds_cond2_and_degenerate_cases_never_certify(dev):
    from wlsqm_tpu_torch.fitter import condprobe

    top = max(e for e in condprobe.est_certified_edges().values() if e)
    for dim, K in ((2, 30), (3, 56)):
        xk, fk, nk, xi = _cloud(dev, 1024, K, 4, seed=80 + dim, dim=dim)
        nk[:] = K
        xk = torch.nan_to_num(xk) * 0.3 + xi[:, None, :] * 0.7
        xk[:16] = xi[:16, None, :]                              # collapsed onto xi
        xk[16:32] = xi[16:32, None, :] + (xk[16:32, :, :1] - xi[16:32, None, :1])   # a line
        kw = dict(dimension=dim, order=4, weighting=wtt.WEIGHT_CENTER, emit_cond=True)
        keys = [fit_rows.fit_rows(xk, fk, nk, xi, **kw)[3]]
        if dim == 2:
            keys.append(fit_kernel.fit_kernel(xk, fk, nk, xi, **kw)[1])
        cond, amp = condprobe.probe(xk[32:], nk[32:], xi[32:], 4, wtt.WEIGHT_CENTER,
                                    dimension=dim, sample=1024)
        ca = torch.as_tensor(cond * amp, device=dev)
        for key in keys:
            assert not bool((key[:32] <= top).any())
            assert bool((key[32:] >= 0.999 * ca).all())


def _sync_calls(fn):
    """fn()'s result and the number of synchronising CUDA calls it made
    (the warnings of ``torch.cuda.set_sync_debug_mode("warn")``)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message) for w in seen)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_probe_on_the_card_is_the_cpus(dev, seed, monkeypatch):
    """The irregular cloud's geometry (2D, order 4, K = 30, CENTER, radii
    log-uniform in [0.1, 1]): the probe of the card's tensors against the
    probe of the same arrays on the CPU, cond to 1e-8 relative and amp bit
    for bit; the same route and the same split decision.  After the screen
    the probe waits on the card once: its one read-back, beside the
    eigensolver's own check of its info flags."""
    from wlsqm_tpu_torch.fitter import condprobe, ladder

    B, K = 1 << 20, 30
    g = torch.Generator(device=dev).manual_seed(1000 + seed)
    xi = torch.rand((B, 2), generator=g, device=dev, dtype=torch.float64) * 2 - 1
    r = torch.exp(np.log(0.1) + torch.rand(B, generator=g, device=dev,
                                           dtype=torch.float64) * np.log(10.0))
    xk = xi[:, None, :] + (torch.rand((B, K, 2), generator=g, device=dev,
                                      dtype=torch.float64) * 2 - 1) * r[:, None, None]
    kw = dict(dimension=2, knowns=0)
    got = condprobe.probe(xk, None, xi, 4, wtt.WEIGHT_CENTER, **kw)
    ref = condprobe.probe(xk.cpu().numpy(), None, xi.cpu().numpy(), 4,
                          wtt.WEIGHT_CENTER, **kw)
    assert got[0].shape == ref[0].shape and len(got[0]) > condprobe.SAMPLE
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-8)
    np.testing.assert_array_equal(got[1], ref[1])
    assert ladder.choose(got, moments_ok=True) == ladder.choose(ref, moments_ok=True)
    edge = condprobe.split_partition_choice(assembly="moments")[1]

    def engages(ca):
        return float((ca[0] * ca[1] * ladder.EST_OVER_COND_MED <= edge).mean()
                     ) >= ladder.SPLIT_MIN_FRAC

    assert engages(got) == engages(ref)

    idx = condprobe._screened_idx(xk, torch.full((B,), K, dtype=torch.int32, device=dev),
                                  xi, 4, 2, condprobe.SAMPLE)
    monkeypatch.setattr(condprobe, "_screened_idx", lambda *a: idx)
    again, n_sync = _sync_calls(lambda: condprobe._cond_amp(
        xk, None, xi, 4, wtt.WEIGHT_CENTER, **kw))
    np.testing.assert_array_equal(again[0], got[0])
    As = torch.eye(15, dtype=torch.float64, device=dev).expand(len(idx), 15, 15)
    _, n_solver = _sync_calls(lambda: condprobe._cond2(As))
    assert n_solver <= 1 and n_sync <= 1 + n_solver


def test_certified_split_on_the_card(dev):
    """A batch whose keys straddle the card's edge: the plan is a moment-kernel
    split; its replay and the eager auto route equal their compositions bit for
    bit, and the certified cases agree with the engine to 1e-10."""
    from wlsqm_tpu_torch import api

    B, K = 32768, 30
    g = torch.Generator(device=dev).manual_seed(90)
    xi = torch.rand((B, 2), generator=g, device=dev, dtype=torch.float64) * 2 - 1
    r = torch.exp(torch.rand(B, generator=g, device=dev, dtype=torch.float64)
                  * np.log(1.0 / 0.15) + np.log(0.15))     # about four in five certify
    xk = xi[:, None, :] + (torch.rand((B, K, 2), generator=g, device=dev,
                                      dtype=torch.float64) * 2 - 1) * r[:, None, None]
    fk = torch.sin(3 * xk[..., 0]) * torch.cos(2 * xk[..., 1])
    nk = torch.full((B,), K, dtype=torch.int32, device=dev)
    kw = dict(order=4, weighting=wtt.WEIGHT_CENTER)
    plan = wtt.plan_fit_many(xk, xi, **kw)
    route = plan.route
    assert (route.path, route.assembly) == ("kernel-split", "moments")
    before = fit_kernel.COND_LAUNCHES
    res_plan = wtt.fit_many(xk, fk, xi, plan=plan, **kw)
    res_auto = wtt.fit_many(xk, fk, xi, **kw)
    torch.cuda.synchronize()
    assert fit_kernel.COND_LAUNCHES == before + 2
    fi_k, key = fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=2, emit_cond=True, **kw)
    over = (~(key <= route.split_edge)).nonzero().squeeze(1)
    assert 0.1 * B < len(over) < 0.5 * B
    gkw = dict(dim=2, order=4, knowns=0, weighting=wtt.WEIGHT_CENTER)
    exp = fi_k.clone()
    exp[over] = api._engine_group(xk[over], fk[over], nk[over], xi[over], None, **gkw)
    assert torch.equal(res_auto.fi, exp)
    k = int(np.ceil(route.tail_frac * B))
    assert len(over) <= k
    idx = api._first_over_edge(key, route.split_edge, k).clamp_max(B - 1)
    exp = fi_k.clone()
    exp[over] = api._engine_group(xk[idx], fk[idx], nk[idx], xi[idx], None,
                                  **gkw)[:len(over)]
    assert torch.equal(res_plan.fi, exp)
    sure = key <= route.split_edge
    eng = wtt.fit_many(xk, fk, xi, backend="engine", **kw).fi
    assert _rel(res_plan.fi[sure], eng[sure]) <= PARITY


def test_calibration_record_of_this_card_is_shipped(dev):
    from wlsqm_tpu_torch.fitter import calibration

    calibration._reset_cache()
    cal = calibration.active()
    assert cal.certified and cal.source in ("shipped", "measured")


# ---------------------------------------------------------------------------
# The gather kernel (csrc/gather.cu)
# ---------------------------------------------------------------------------

def _special(u):
    """NaN, -0, +inf and -inf planted in a float payload."""
    flat = u.view(-1)
    for i, v in enumerate((float("nan"), -0.0, float("inf"), float("-inf"))):
        flat[i::11] = v
    return u


def _gather_idx(dev, n, B, K, seed, three_clusters=False):
    g = np.random.default_rng(seed)
    base = np.sort(g.integers(0, n, B))
    idx = np.clip(base[:, None] + g.integers(-40, 40, (B, K)), 0, n - 1)
    if three_clusters:   # tests/test_gather.py:165-185, every 8th block
        three = (np.arange(B) // gather.BLOCK_T) % 8 == 0
        pick = g.integers(0, 3, (B, K))
        idx = np.where(three[:, None] & (pick == 1), n // 2 + g.integers(0, 30, (B, K)), idx)
        idx = np.where(three[:, None] & (pick == 2), n - 1 - g.integers(0, 30, (B, K)), idx)
    return torch.as_tensor(idx.astype(np.int32), device=dev)


@pytest.mark.parametrize("dtype,F", [(torch.float64, 1), (torch.float64, 3),
                                     (torch.float32, 1), (torch.float32, 2),
                                     (torch.int32, 1), (torch.int64, 2)])
@pytest.mark.parametrize("three_clusters", [False, True])
def test_gather_kernel_is_bit_exact(dev, dtype, F, three_clusters):
    n, B, K = 40000, 16 * 61 + 7, 28          # a ragged tail of 7 cases
    idx = _gather_idx(dev, n, B, K, seed=F, three_clusters=three_clusters)
    plan = gather.plan_window_gather(idx, n)
    assert plan is not None and bool(plan.bad_blocks) == three_clusters
    shape = (n, F) if F > 1 else (n,)
    if dtype.is_floating_point:
        u = _special(torch.randn(shape, dtype=dtype, device=dev))
    else:
        u = torch.randint(-2**31, 2**31 - 1, shape, dtype=dtype, device=dev)
    before = gather.LAUNCHES
    got = gather.gather_rows(u, idx, plan)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == before + 1
    ref = gather.gather_rows_plain(u, idx)
    assert got.dtype == u.dtype and got.shape == ref.shape
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("dtype,F", [(torch.float64, 1), (torch.float64, 2),
                                     (torch.float64, 3), (torch.float32, 1),
                                     (torch.float32, 3), (torch.int32, 1), (torch.int64, 1)])
@pytest.mark.parametrize("offset", [0, 1])
def test_gather_every_instance_is_bit_exact(dev, dtype, F, offset):
    """Every instance the vector plan picks, against u[idx] bit for bit: an
    odd number of output rows (a ragged last group), and u as a view offset
    by one element, so that it is not 16-byte aligned and the 16-byte loads
    must not be taken."""
    n, B, K = 30000, 3207, 7                   # 22,449 rows: odd
    idx = _gather_idx(dev, n, B, K, seed=F + offset)
    plan = gather.plan_window_gather(idx, n)
    numel = (n + 1) * F
    if dtype.is_floating_point:
        base = _special(torch.randn(numel, dtype=dtype, device=dev))
    else:
        base = torch.randint(-2**31, 2**31 - 1, (numel,), dtype=dtype, device=dev)
    u = base[offset:offset + n * F]
    u = u.view(n, F) if F > 1 else u
    assert (u.data_ptr() % 16 == 0) == (offset == 0)
    load = gather._vector_plan(u.element_size() * F, u.data_ptr(), 1 << 20)
    assert load is not None and (load < 16 or not offset)
    before = gather.LAUNCHES
    got = gather.gather_rows(u, idx, plan)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == before + 1
    ref = u[idx.long()]
    assert got.dtype == u.dtype and got.shape == ref.shape
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gather_every_width_is_bit_exact(dev, dtype):
    """Rows of 1-20 words (f32 F = 1-20, f64 F = 1-10), an odd number of
    output rows, u aligned and one element off, through gather_rows (the
    vector instances: a template of the width, or the run-time width), and
    the same rows into an output one word off its 16-byte alignment through
    the word instance: each against u[idx] bit for bit."""
    n, B, K = 5000, 613, 5                     # 3,065 rows: odd
    idx = _gather_idx(dev, n, B, K, seed=11)
    plan = gather.plan_window_gather(idx, n)
    flat = idx.reshape(-1)
    for F in range(1, (20 if dtype == torch.float32 else 10) + 1):
        base = _special(torch.randn((n + 1) * F, dtype=dtype, device=dev))
        for offset in (0, 1):
            u = base[offset:offset + n * F].view(n, F)
            load = gather._vector_plan(u.element_size() * F, u.data_ptr(), 1 << 20)
            assert load is not None and (load < 16 or not offset)
            before = gather.LAUNCHES
            got = gather.gather_rows(u, idx, plan)
            torch.cuda.synchronize()
            assert gather.LAUNCHES == before + 1
            ref = u[idx.long()]
            assert torch.equal(_bits(got), _bits(ref)), (F, offset)
            words = u.contiguous().view(torch.int32)
            W = words.shape[1]
            buf = torch.zeros(flat.numel() * W + 1, dtype=torch.int32, device=dev)
            out = buf[1:].view(-1, W)             # 4 bytes off 16-byte alignment
            assert gather._vector_plan(4 * W, words.data_ptr(), out.data_ptr()) is None
            gather._launch([words], flat, [out])
            torch.cuda.synchronize()
            assert torch.equal(out, ref.reshape(flat.numel(), -1).view(torch.int32)), (F,
                                                                                       offset)


def test_gather_pair_kernel_is_bit_exact(dev):
    n, B, K = 20000, 1000, 16
    idx = _gather_idx(dev, n, B, K, seed=7)
    plan = gather.plan_window_gather(idx, n)
    hi = _special(torch.randn((n, 2), dtype=torch.float32, device=dev))
    lo = torch.randn((n, 2), dtype=torch.float32, device=dev)
    before = gather.LAUNCHES
    ghi, glo = gather.gather_rows_pair((hi, lo), idx, plan)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == before + 1
    assert torch.equal(_bits(ghi), _bits(hi[idx.long()]))
    assert torch.equal(_bits(glo), _bits(lo[idx.long()]))


def test_gather_cuda_call_never_runs_the_plain_version(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(gather, "gather_rows_plain", boom)
    n = 5000
    idx = _gather_idx(dev, n, 512, 12, seed=3)
    plan = gather.plan_window_gather(idx, n)
    u = torch.randn(n, dtype=torch.float64, device=dev)
    out = gather.gather_rows(u, idx, plan)
    torch.cuda.synchronize()
    assert torch.equal(out, u[idx.long()])


def test_gather_kernel_clamps_bad_indices(dev):
    n = 3000
    idx = _gather_idx(dev, n, 64, 8, seed=4)
    plan = gather.plan_window_gather(idx, n)
    idx[0, 0], idx[0, 1] = -7, n + 5           # after planning: never read outside u
    u = torch.arange(n, dtype=torch.float64, device=dev)
    out = gather.gather_rows(u, idx, plan)
    torch.cuda.synchronize()
    assert out[0, 0].item() == 0 and out[0, 1].item() == n - 1
    assert torch.equal(out[1:], u[idx[1:].long()])


def test_ibvp_step_through_the_kernel_equals_the_plain_gather(dev):
    """One gate-row step (order 2, uniform, Jacobi, K = 28 with self) on a
    4,096-point Morton cloud: the kernel path and u[idx] give the same u."""
    import scipy.spatial

    g = np.random.default_rng(11)
    pts = g.uniform(-1, 1, (4096, 2))
    pts = pts[gather.morton_order(pts)]
    _, idx = scipy.spatial.cKDTree(pts).query(pts, k=28)
    idx = torch.as_tensor(idx.astype(np.int32), device=dev)
    plan = gather.plan_window_gather(idx, len(pts))
    pts_t = torch.as_tensor(pts, device=dev)
    prep = wtt.prepare(pts_t[idx.long()], pts_t, order=2, scaling="jacobi")
    u = torch.sin(3 * pts_t[:, 0]) * torch.cos(2 * pts_t[:, 1])
    out = []
    for fk in (gather.gather_rows(u, idx, plan), gather.gather_rows_plain(u, idx)):
        fi, _ = wtt.solve(prep, fk)
        out.append(u + 1e-5 * (fi[:, wtt.i2_X2] + fi[:, wtt.i2_Y2]))
    assert torch.equal(out[0], out[1])


def test_heat_example_on_the_card(dev):
    before = gather.LAUNCHES
    res = ibvp_heat.run()
    assert res["device"].startswith("cuda")
    assert res["gather_launches"] == 1000 and gather.LAUNCHES == before + 1000
    assert res["max_error"] < ibvp_heat.TOL and max(res["field_max_errors"]) < ibvp_heat.TOL


def test_euler_step_on_the_card_is_the_cpu_step(dev):
    """Three SSP-RK3 steps of the Euler example at nside 48: on the card
    (the gather kernel, 8 fields a stage, and the engine's multi-field
    solve) within 1e-10 of the same steps with device="cpu", relative to
    max(|U|, 1); nine gather launches."""
    from wlsqm_tpu_torch.examples import euler_flow as ef

    dt = ef.cfl_dt(ef.NSIDE)
    out = []
    for device in ("cpu", dev):
        flow = ef.setup(ef.NSIDE, ef.K, device=device)
        before = gather.LAUNCHES
        U = flow.initial()
        for _ in range(3):
            U = flow.step(U, dt)
        out.append(U.cpu())
    assert gather.LAUNCHES == before + 9
    assert _rel(out[1], out[0]) <= PARITY


def test_adjoint_gradient_on_the_card_is_the_cpus(dev):
    """The adjoint example's first loss gradient: through the rows kernel's
    do_sens launch on the card against its plain version on the CPU,
    within 1e-10 of its largest entry; one launch."""
    from wlsqm_tpu_torch.examples import adjoint_data_recovery as ad

    grads = []
    for device in ("cpu", dev):
        p = ad.problem(device=device)
        before = fit_rows.LAUNCHES
        grads.append(ad.loss_and_grad(p, p.u_obs)[1].cpu())
    assert fit_rows.LAUNCHES == before + 1
    assert (grads[1] - grads[0]).abs().max() <= PARITY * grads[0].abs().max()


# ---------------------------------------------------------------------------
# The compat surface on the card: ExpertSolver and the fit_* entries
# ---------------------------------------------------------------------------

def _expert_cloud(B, K=30, seed=5):
    """The regression gate's expert row (benchmarks/run_regression_gate.py
    l.202-225): xk = xi + U(-0.5, 0.5), 8 fields sin((1 + 0.1 i) x) cos y."""
    rng = np.random.default_rng(seed)
    xi = rng.uniform(-1, 1, (B, 2))
    xk = xi[:, None, :] + rng.uniform(-0.5, 0.5, (B, K, 2))
    fks = [np.sin((1 + 0.1 * i) * xk[..., 0]) * np.cos(xk[..., 1]) for i in range(8)]
    return xi, xk, fks


def test_expert_solver_solves_on_the_prepared_path(dev):
    """ExpertSolver at B = 8192 (order 4, CENTER) on the card: its state
    lives there, every solve back-substitutes the prepared factor (no kernel
    launch) and equals the precision="f64" twin bit for bit."""
    B, K = 8192, 30
    xi, xk, fks = _expert_cloud(B, K)
    kw = dict(dimension=2, nk=np.full(B, K, np.int32), order=np.full(B, 4, np.int32),
              knowns=np.zeros(B, np.int64),
              weighting_method=np.full(B, wtt.WEIGHT_CENTER, np.int32))
    s = wtt.ExpertSolver(**kw)
    s.prepare(xi, xk)
    twin = wtt.ExpertSolver(**kw, precision="f64")
    twin.prepare(xi, xk)
    assert s.prepared.c.device.type == "cuda"
    before = (fit_kernel.LAUNCHES, fit_rows.LAUNCHES)
    for fk in fks[:3]:
        fi, fi2 = np.zeros((B, 15)), np.zeros((B, 15))
        s.solve(fk, fi)
        twin.solve(fk, fi2)
        np.testing.assert_array_equal(fi, fi2)
    assert (fit_kernel.LAUNCHES, fit_rows.LAUNCHES) == before


def test_fit_2d_many_data_gate_on_a_low_frequency_field(dev):
    """ROADMAP C4 on the card: fit_2D_many on the expert cloud's field
    sin x cos y at B = 8192 is one moment launch with the key; every case the
    data gate keeps on the kernel holds 1e-10 of the long-double oracle and
    of the prepared f64 solve, every other case is the f64 engine's."""
    from wlsqm_tpu_torch.fitter import calibration, condprobe

    B, K = 8192, 30
    xi, xk, fks = _expert_cloud(B, K)
    fk = fks[0]
    cfg = (np.full(B, 4, np.int32), np.zeros(B, np.int64),
           np.full(B, wtt.WEIGHT_CENTER, np.int32))
    fi = np.zeros((B, 15))
    before = fit_kernel.LAUNCHES
    wtt.fit_2D_many(xk, fk, np.full(B, K, np.int32), xi, fi, None, False, *cfg)
    assert fit_kernel.LAUNCHES == before + 1
    xk_d, fk_d, xi_d = (torch.as_tensor(a, device=dev) for a in (xk, fk, xi))
    nk_d = torch.full((B,), K, dtype=torch.int32, device=dev)
    fi_k, key = fit_kernel.fit_kernel(xk_d, fk_d, nk_d, xi_d, dimension=2, order=4,
                                      weighting=wtt.WEIGHT_CENTER, emit_cond=True)
    sure = (key * calibration.data_ratio(fi_k, fk_d, nk_d)
            <= condprobe.data_edges()["moments"]).cpu().numpy()
    assert 0.05 < sure.mean() < 0.95
    np.testing.assert_array_equal(fi[sure], fi_k.cpu().numpy()[sure])
    orc = calibration._strong_oracle(xk[sure], xi[sure], fk[sure], wtt.WEIGHT_CENTER, 2)
    assert _rel(torch.as_tensor(fi[sure]), torch.as_tensor(orc)) <= PARITY
    s = wtt.ExpertSolver(2, np.full(B, K, np.int32), *cfg)
    s.prepare(xi, xk)
    fi2 = np.zeros((B, 15))
    s.solve(fk, fi2)
    assert _rel(torch.as_tensor(fi[sure]), torch.as_tensor(fi2[sure])) <= PARITY
    eng = wtt.fit_many(xk, fk, xi, order=4, weighting=wtt.WEIGHT_CENTER, backend="engine")
    assert _rel(torch.as_tensor(fi[~sure]), eng.fi[~sure].cpu()) <= 1e-13


def test_fit_3d_many_with_sens_launches_the_rows_kernel(dev):
    rng = np.random.default_rng(12)
    B, K = 4096, 48
    xi = rng.uniform(-1, 1, (B, 3))
    xk = xi[:, None, :] + rng.uniform(-0.5, 0.5, (B, K, 3))
    fk = np.sin(xk[..., 0]) * np.cos(xk[..., 2])
    NO = wtt.number_of_dofs(3, 2)
    args = (xk, fk, np.full(B, K, np.int32), xi)
    cfg = (True, np.full(B, 2, np.int32), np.full(B, wtt.b3_F, np.int64),
           np.full(B, wtt.WEIGHT_CENTER, np.int32))
    fi0 = np.zeros((B, NO))
    fi0[:, 0] = fk[:, 0]
    fi, sens = fi0.copy(), np.zeros((B, K, NO))
    before = fit_rows.LAUNCHES
    wtt.fit_3D_many(*args, fi, sens, *cfg)
    assert fit_rows.LAUNCHES == before + 1
    fi_e, sens_e = fi0.copy(), np.zeros((B, K, NO))
    wtt.fit_3D_many(*args, fi_e, sens_e, *cfg, debug=1)
    assert fit_rows.LAUNCHES == before + 1
    assert _rel_nan(torch.as_tensor(fi), torch.as_tensor(fi_e)) <= PARITY
    assert _rel_nan(torch.as_tensor(sens.reshape(B, -1)),
                    torch.as_tensor(sens_e.reshape(B, -1))) <= PARITY


def test_compat_entry_points_without_a_card_raise(monkeypatch):
    """A CPU test: without ``device=`` the compat surface computes on the
    card, and where there is none it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(1)
    xk = rng.uniform(-1, 1, (20, 2))
    s = wtt.ExpertSolver(dimension=2, nk=np.full(1, 20, np.int32),
                         order=np.full(1, 2, np.int32), knowns=np.zeros(1, np.int64),
                         weighting_method=np.full(1, wtt.WEIGHT_UNIFORM, np.int32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        s.prepare(np.zeros((1, 2)), xk[None])
    assert not s.ready
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wtt.fit_2D(xk, xk[:, 0], np.zeros(2), np.zeros(6))
    fi = np.zeros(6)
    wtt.fit_2D(xk, xk[:, 0], np.zeros(2), fi, device="cpu")
    np.testing.assert_allclose(fi[:3], [0.0, 1.0, 0.0], atol=1e-12)


# -- gradients, the stream, the sharded layer and warmup on the card ------------

def _headline(dev, B, seed):
    xk, fk, nk, xi = _cloud(dev, B, 30, 4, seed=seed, ragged=False)
    return xk, fk, xi


def test_grad_through_fit_many_is_the_engines(dev):
    """fit_many with fk (and then xk) requiring grad warns, never launches a
    kernel, and its gradient is the engine's; a kernel route raises; under
    no_grad the route launches the moment kernel again."""
    from wlsqm_tpu_torch.fitter import engine

    xk, fk, xi = _headline(dev, 4096, 61)
    kw = dict(order=4, weighting=wtt.WEIGHT_CENTER)
    plan = wtt.plan_fit_many(xk, xi, **kw)
    assert plan.route.path == "kernel"
    before = (fit_kernel.LAUNCHES, fit_rows.LAUNCHES)
    for name in ("fk", "xk"):
        t = dict(xk=xk.clone(), fk=fk.clone())
        t[name].requires_grad_(True)
        with pytest.warns(UserWarning, match="autograd"):
            fi = wtt.fit_many(t["xk"], t["fk"], xi, **kw).fi
        g = torch.randn_like(fi)
        got = torch.autograd.grad((fi * g).sum(), t[name])[0]
        e = dict(xk=xk.clone(), fk=fk.clone())
        e[name].requires_grad_(True)
        B = xk.shape[0]
        ref_fi = engine.fit_batch(e["xk"], e["fk"], torch.full((B,), 30, device=dev),
                                  xi, xk.new_zeros((B, 15)),
                                  torch.full((B,), 4, device=dev, dtype=torch.int32),
                                  torch.zeros(B, device=dev, dtype=torch.int64),
                                  torch.full((B,), wtt.WEIGHT_CENTER, device=dev,
                                             dtype=torch.int32), dimension=2, NO=15)[0]
        ref = torch.autograd.grad((ref_fi * g).sum(), e[name])[0]
        assert _rel(got.reshape(B, -1), ref.reshape(B, -1)) <= PARITY
        for bad in (dict(backend="kernel"), dict(plan=plan)):
            with pytest.raises(ValueError, match="fit_rows_diffable"):
                wtt.fit_many(t["xk"], t["fk"], xi, **kw, **bad)
    torch.cuda.synchronize()
    assert (fit_kernel.LAUNCHES, fit_rows.LAUNCHES) == before
    with torch.no_grad():
        wtt.fit_many(xk, fk.clone().requires_grad_(True), xi, plan=plan, **kw)
    assert fit_kernel.LAUNCHES == before[0] + 1
    with pytest.raises(ValueError, match="no backward"):
        fit_kernel.fit_kernel(xk, fk.clone().requires_grad_(True), torch.full(
            (xk.shape[0],), 30, device=dev), xi, dimension=2, order=4,
            weighting=wtt.WEIGHT_CENTER)


def test_fixed_trip_is_the_loop_form_on_the_card(dev):
    from wlsqm_tpu_torch.fitter import engine

    xk, fk, nk, xi = _cloud(dev, 4096, 30, 4, seed=62)
    fk = fk + 1e-3 * torch.randn_like(fk)
    B = xk.shape[0]
    args = (xk, fk, nk, xi, xk.new_zeros((B, 15)),
            torch.full((B,), 4, device=dev, dtype=torch.int32),
            torch.zeros(B, device=dev, dtype=torch.int64),
            torch.full((B,), wtt.WEIGHT_CENTER, device=dev, dtype=torch.int32))
    kw = dict(dimension=2, NO=15, iterative=True, max_iter=5)
    loop = engine.fit_batch(*args, **kw)
    fixed = engine.fit_batch(*args, fixed_trip=True, **kw)
    assert torch.equal(loop[0], fixed[0]) and torch.equal(loop[2], fixed[2])
    assert int(loop[2].max()) >= 1


def test_fit_stream_is_fit_many_per_chunk(dev):
    """fit_stream on a host cloud: every chunk bit-equal to fit_many(plan=)
    of that chunk, one moment launch a chunk; and over four logical shards
    of the card."""
    g = np.random.default_rng(63)
    B, chunk = 70_000, 16_384
    xk = g.uniform(-1, 1, (B, 30, 2))
    fk = np.sin(3 * xk[..., 0]) * np.cos(2 * xk[..., 1])
    kw = dict(order=4, weighting=wtt.WEIGHT_CENTER)
    before = fit_kernel.LAUNCHES
    res = wtt.fit_stream(xk, fk, chunk=chunk, **kw)
    n_chunks = -(-B // chunk)
    assert fit_kernel.LAUNCHES - before == n_chunks
    plan = wtt.plan_fit_many(xk[:chunk], **kw)
    for lo in range(0, B, chunk):
        hi = min(lo + chunk, B)
        ref = wtt.fit_many(xk[lo:hi], fk[lo:hi], plan=plan, **kw).fi.cpu().numpy()
        np.testing.assert_array_equal(res.fi[lo:hi], ref)
    mesh = [dev] * 4
    res4 = wtt.fit_stream(xk, fk, chunk=chunk, mesh=mesh, plan=plan, **kw)
    np.testing.assert_array_equal(res4.fi, res.fi)


def test_sharded_fit_pallas_and_gather_local_on_four_logical_shards(dev):
    from wlsqm_tpu_torch.parallel import sharding

    xk, fk, nk, xi = _cloud(dev, 65_536, 30, 4, seed=64)
    kw = dict(dimension=2, order=4, weighting=wtt.WEIGHT_CENTER)
    one = fit_kernel.fit_kernel(xk, fk, nk, xi, **kw)
    for D in (1, 4):
        mesh = sharding.make_mesh(devices=[dev] * D)
        before = fit_kernel.LAUNCHES
        got = sharding.join(sharding.sharded_fit_pallas(mesh, xk, fk, nk, xi, **kw))
        assert fit_kernel.LAUNCHES == before + D
        assert torch.equal(got, one)

    rng = np.random.default_rng(65)
    n, K = 1 << 14, 12
    pts = rng.uniform(-1, 1, (n, 2))
    pts = pts[gather.morton_order(pts)]
    from wlsqm_tpu_torch.utils import neighbors

    idx, _ = neighbors.knn(pts, pts, K, backend="host")
    plan = gather.plan_window_gather(idx, n)
    u = torch.randn((n, 3), dtype=torch.float64, device=dev)
    ref = gather.gather_rows(u, idx, plan)
    for D in (1, 3, 4):
        mesh = sharding.make_mesh(devices=[dev] * D)
        before = gather.LAUNCHES
        got = sharding.join(sharding.sharded_gather_values(mesh, u, idx, plan=plan))
        assert gather.LAUNCHES == before + D
        assert torch.equal(got.view(torch.int64), ref.view(torch.int64))
    # gather_local on each of four slices of the plan
    meta = np.asarray(plan.meta, np.int32).reshape(plan.nblk, 3)
    nb, Bs = plan.nblk // 4, n // 4
    kw = dict(window=plan.window, TKp=-(-plan.T * K // 128) * 128, n_pad=plan.n_pad,
              T=plan.T)
    before = gather.LAUNCHES
    got = torch.cat([gather.gather_local(u, idx[s * Bs:(s + 1) * Bs],
                                         meta[s * nb:(s + 1) * nb], np.zeros(1, np.int32), **kw)
                     for s in range(4)])
    assert gather.LAUNCHES == before + 4
    assert torch.equal(got.view(torch.int64), ref.view(torch.int64))


def test_warmup_builds_and_launches_every_instance(dev):
    reports = wtt.warmup()
    assert len(reports) == 5
    for rep in reports:
        n = rep["launches"]
        key = n["cond_estimate@fit_moment"] + n["cond_estimate@fit_rows"]
        assert n["fit_moment"] + n["fit_rows"] >= 2 and key >= 1, rep
    # the 3D moment configuration warms the moment kernel (its warp body)
    assert reports[-1]["assembly"] == "moments" and reports[-1]["launches"]["fit_moment"] >= 2
    assert {r["assembly"] for r in reports} == {"moments", "rows"}


# ---------------------------------------------------------------------------
# The moment kernel in dims 1 and 3, with knowns and ALGO_ITERATIVE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [1, 2, 3])
def test_moment_kernel_knowns_and_iterative_match_plain(dev, dim):
    """Every order and weighting, knowns {0, the value, the highest DOF},
    basic and max_iter = 3, ragged nk with NaN padding (1D at nk >= 2 NO):
    fi within PARITY of the plain version, in 1D on every case whose key is
    under the moment body's certified edge; past it (the kernel and the
    plain version sum the moments in other orders, a difference the
    conditioning amplifies: 1D order 4 clouds of 10-16 points reach keys of
    1e6-1e7) within min(KEY_EPS x key, KEY_CAP) of the plain version and,
    against the long-double-refined oracle, within PARITY or ORACLE_FACTOR
    times the plain version's error; the known DOFs fi_init's bits, fi and
    the counts the same bits with and without the key, the key within 1e-6
    of the plain version's."""
    from wlsqm_tpu_torch.fitter import calibration, condprobe

    edge = condprobe.est_certified_edges()["moments"]
    K = K_BY_DIM[dim]
    for order in range(5):
        NO = wtt.number_of_dofs(dim, order)
        lo = 2 * NO if dim == 1 else None
        for kn in sorted({0, 1, 1 << (NO - 1)}):
            for mi in (0, 3):
                for w in (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER):
                    xk, fk, nk, xi = _cloud(dev, 2048, K, order, seed=100 + order, dim=dim,
                                            lo=lo)
                    fi0 = torch.randn((2048, NO + 1), dtype=torch.float64, device=dev)
                    kw = dict(dimension=dim, order=order, weighting=w, knowns=kn, max_iter=mi)
                    before = fit_kernel.LAUNCHES
                    got = fit_kernel.fit_kernel(xk, fk, nk, xi, fi0, **kw)
                    key = fit_kernel.fit_kernel(xk, fk, nk, xi, fi0, emit_cond=True, **kw)
                    torch.cuda.synchronize()
                    assert fit_kernel.LAUNCHES == before + 2
                    ref = fit_kernel.fit_moments_plain(xk, fk, nk, xi, fi0, emit_cond=True, **kw)
                    fi = got[0] if mi else got
                    case = (dim, order, kn, mi, w)
                    assert torch.isfinite(fi).all(), case
                    err = _rel_cases(fi, ref[0])
                    KN = fit_kernel.known_dofs(kn, dim, order)
                    if dim == 1:
                        cap = (KEY_EPS * ref[-1]).clamp_max(KEY_CAP)
                        assert bool((err <= torch.where(ref[-1] <= edge, PARITY, cap)).all()), case
                        past = (ref[-1] > edge).nonzero().squeeze(1)
                        e = calibration.oracle_case_errors(
                            [fi[past], ref[0][past]], xk[past], fk[past], nk[past], xi[past],
                            fi0[past], KN, w, dim, order)
                        assert (e[0] <= np.maximum(ORACLE_FACTOR * e[1], PARITY)).all(), case
                    else:
                        assert err.max().item() <= PARITY, case
                    assert torch.equal(_bits(fi), _bits(key[0])), case
                    assert torch.equal(_bits(fi[:, KN]), _bits(fi0[:, KN])), case
                    if mi:
                        assert torch.equal(got[1], key[1]), case
                        assert int(got[1].min()) >= 1 and int(got[1].max()) <= mi
                    assert ((key[-1] - ref[-1]).abs() / ref[-1]).max().item() <= 1e-6, case


@pytest.mark.parametrize("dim", [2, 1, 3])
def test_moment_ext_instance_is_the_basic_instance(dev, dim):
    """In every dimension the thread body's instance compiled with knowns
    (and ALGO_ITERATIVE) and the one compiled with ALGO_ITERATIVE alone
    give, with neither asked, the bits of the basic instance (2D: the
    headline's; 1D and 3D orders 0-2, whose calls the one with knowns once
    ran alone), with and without the key, both weightings;
    with max_iter = 0 fit_kernel is the basic path.  1D and 3D also with
    max_iter = 3: the ALGO_ITERATIVE instance's fi and counts are those of
    the one with knowns."""
    K = {1: 15, 2: 30, 3: 48}[dim]
    for order in range(3 if dim == 3 else 5):
        NO = wtt.number_of_dofs(dim, order)
        xk, fk, nk, xi = _cloud(dev, 8192, K, order, seed=200 + order, dim=dim,
                                lo=2 * NO if dim == 1 else None)
        for w in (wtt.WEIGHT_CENTER,) if dim == 2 else (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER):
            outs = []
            for ext in (0, 1, 2):
                out = torch.empty((8192, NO), dtype=torch.float64, device=dev)
                est = torch.empty((8192,), dtype=torch.float64, device=dev)
                fit_kernel._launch(xk, fk, nk, xi, out, order=order, weighting=w,
                                   refine_steps=1, ext=ext)
                fit_kernel._launch(xk, fk, nk, xi, out.clone(), est, order=order,
                                   weighting=w, refine_steps=1, ext=ext)
                outs += [out, est]
            torch.cuda.synchronize()
            for other in (2, 4):
                assert torch.equal(_bits(outs[0]), _bits(outs[other])), (dim, order, w)
                assert torch.equal(_bits(outs[1]), _bits(outs[other + 1])), (dim, order, w)
            basic = fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=dim, order=order,
                                          weighting=w, max_iter=0)
            assert torch.equal(_bits(basic), _bits(outs[0]))
            if dim == 2:
                continue
            its = {}
            for ext in (2, 1):
                out = torch.empty((8192, NO), dtype=torch.float64, device=dev)
                it = torch.empty((8192,), dtype=torch.int32, device=dev)
                est = torch.empty((8192,), dtype=torch.float64, device=dev)
                it_k = torch.empty_like(it)
                fit_kernel._launch(xk, fk, nk, xi, out, iters=it, order=order, weighting=w,
                                   refine_steps=1, max_iter=3, ext=ext)
                fit_kernel._launch(xk, fk, nk, xi, out.clone(), est, iters=it_k, order=order,
                                   weighting=w, refine_steps=1, max_iter=3, ext=ext)
                its[ext] = (out, it, est, it_k)
            torch.cuda.synchronize()
            for a, b in zip(its[2], its[1]):
                assert torch.equal(_bits(a), _bits(b)), (dim, order, w)


@pytest.mark.parametrize("dim", [1, 3])
def test_moment_1d_3d_thread_instances_match_plain(dev, dim):
    """The 1D and 3D (orders 0-2) thread body's basic and ALGO_ITERATIVE
    instances against the plain version: ragged nk with NaN padding,
    both weightings, max_iter 0 and 3, at the smoke paths' K (1D K = 15, 3D
    K = 48) and at K = 16 and 56, batches that end inside a warp.  fi within
    PARITY of the plain version (1D: past the moment key edge within
    min(KEY_EPS x key, KEY_CAP), as test_moment_kernel_matches_plain holds
    it); the counts in [1, 3], >= 50% equal to the plain version's and >= 80%
    within one, pooled; fi, the counts and the key the same bits as the
    instance with knowns gives them."""
    from wlsqm_tpu_torch.fitter import condprobe

    edge = condprobe.est_certified_edges()["moments"]
    equal = within = total = 0
    for K in ((15, 16) if dim == 1 else (48, 56)):
        for order in range(5 if dim == 1 else 3):
            NO = wtt.number_of_dofs(dim, order)
            for w in (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER):
                for mi in (0, 3):
                    B = 2000 + 7 * order + mi + w   # the last warp holds fewer than 32 cases
                    xk, fk, nk, xi = _cloud(dev, B, K, order, seed=500 + 10 * order + mi + K,
                                            dim=dim, lo=2 * NO if dim == 1 else None)
                    kw = dict(dimension=dim, order=order, weighting=w, max_iter=mi)
                    got = fit_kernel.fit_kernel(xk, fk, nk, xi, emit_cond=True, **kw)
                    ref = fit_kernel.fit_moments_plain(xk, fk, nk, xi, emit_cond=True, **kw)
                    merged = [torch.empty_like(got[0]), torch.empty_like(got[-1])]
                    it = torch.empty_like(got[1]) if mi else None
                    fit_kernel._launch(xk, fk, nk, xi, merged[0], merged[1], iters=it,
                                       order=order, weighting=w, refine_steps=1, max_iter=mi,
                                       ext=1)
                    torch.cuda.synchronize()
                    case = (K, order, w, mi)
                    assert torch.isfinite(got[0]).all(), case
                    err = _rel_cases(got[0], ref[0])
                    tol = PARITY if dim == 3 else torch.where(
                        ref[-1] <= edge, PARITY, (KEY_EPS * ref[-1]).clamp_max(KEY_CAP))
                    assert bool((err <= tol).all()), case
                    assert torch.equal(_bits(got[0]), _bits(merged[0])), case
                    assert torch.equal(_bits(got[-1]), _bits(merged[1])), case
                    if mi:
                        assert torch.equal(got[1], it), case
                        assert 1 <= int(got[1].min()) and int(got[1].max()) <= mi, case
                        equal += int((got[1] == ref[1]).sum())
                        within += int(((got[1] - ref[1]).abs() <= 1).sum())
                        total += B
    assert equal / total >= 0.5 and within / total >= 0.8, (equal / total, within / total)


@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
def test_moment_iterative_instance_matches_plain(dev, order):
    """The 2D ALGO_ITERATIVE instance (the iterative path's; its residual
    pass goes by the warp, lanes over a case's neighbours), both weightings,
    max_iter 1 and 3, ragged nk with NaN padding and a batch that ends
    inside a warp: fi within PARITY of the plain version; the counts in
    [1, max_iter], >= 50% equal to the plain version's and >= 80% within one,
    pooled (the ties of exact stagnation, as the module docstring says); fi
    and the counts the same bits with the key, and the same bits as the
    instance with knowns computes them (which this call does not need)."""
    NO = wtt.number_of_dofs(2, order)
    equal = within = total = 0
    for w in (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER):
        for mi in (1, 3):
            B = 3000 + 7 * order + mi   # the last warp holds fewer than 32 cases
            xk, fk, nk, xi = _cloud(dev, B, 30, order, seed=400 + 10 * order + mi)
            kw = dict(order=order, weighting=w, refine_steps=1, max_iter=mi)
            outs = {}
            for ext, cond in ((2, False), (2, True), (1, False)):
                fi = torch.empty((B, NO), dtype=torch.float64, device=dev)
                its = torch.empty((B,), dtype=torch.int32, device=dev)
                est = torch.empty((B,), dtype=torch.float64, device=dev) if cond else None
                fit_kernel._launch(xk, fk, nk, xi, fi, est, iters=its, ext=ext, **kw)
                outs[(ext, cond)] = (fi, its)
            torch.cuda.synchronize()
            fi, its = outs[(2, False)]
            for other in ((2, True), (1, False)):
                assert torch.equal(_bits(fi), _bits(outs[other][0])), (order, w, mi, other)
                assert torch.equal(its, outs[other][1]), (order, w, mi, other)
            assert fit_kernel.fit_kernel(xk, fk, nk, xi, dimension=2, order=order, weighting=w,
                                         max_iter=mi)[1].equal(its)
            fi_p, it_p = fit_kernel.fit_moments_plain(xk, fk, nk, xi, dimension=2, order=order,
                                                      weighting=w, max_iter=mi)
            assert torch.isfinite(fi).all()
            assert _rel(fi, fi_p) <= PARITY, (order, w, mi)
            assert 1 <= int(its.min()) and int(its.max()) <= mi
            equal += int((its == it_p).sum())
            within += int(((its - it_p).abs() <= 1).sum())
            total += B
    assert equal / total >= 0.5 and within / total >= 0.8, (equal / total, within / total)


@pytest.mark.parametrize("order,K", [(3, 30), (3, 48), (3, 130), (4, 48), (4, 53), (4, 130),
                                     (4, 152), (4, 160)])
def test_moment_warp_body_matches_plain(dev, order, K):
    """The moment kernel's warp body (3D orders 3 and 4; chunks of 16
    neighbours, so K = 48 is three, K = 130 and up many, and 152 and 160 lie
    past the thread body's slab edge), both weightings, knowns {0, the
    value, the highest DOF}, basic and max_iter = 3, ragged nk >= 1.5 NO
    (or K) with NaN in the padded slots: fi within PARITY of the plain
    version; the known DOFs fi_init's bits; fi and the counts the same bits
    with and without the key, and twice; the key within 1e-6 of the plain
    version's."""
    NO = wtt.number_of_dofs(3, order)
    for w in (wtt.WEIGHT_UNIFORM, wtt.WEIGHT_CENTER):
        xk, fk, nk, xi = _cloud(dev, 2048, K, order, seed=500 + 3 * K + order, dim=3)
        assert bool(torch.isnan(xk).any()) or K <= (3 * NO) // 2
        fi0 = torch.randn((2048, NO), dtype=torch.float64, device=dev)
        for kn in (0, 1, 1 << (NO - 1)):
            for mi in (0, 3):
                kw = dict(dimension=3, order=order, weighting=w, knowns=kn, max_iter=mi)
                case = (order, K, w, kn, mi)
                got = fit_kernel.fit_kernel(xk, fk, nk, xi, fi0, **kw)
                again = fit_kernel.fit_kernel(xk, fk, nk, xi, fi0, **kw)
                key = fit_kernel.fit_kernel(xk, fk, nk, xi, fi0, emit_cond=True, **kw)
                ref = fit_kernel.fit_moments_plain(xk, fk, nk, xi, fi0, emit_cond=True, **kw)
                torch.cuda.synchronize()
                fi = got[0] if mi else got
                assert torch.isfinite(fi).all(), case
                assert _rel(fi, ref[0]) <= PARITY, case
                KN = fit_kernel.known_dofs(kn, 3, order)
                assert torch.equal(_bits(fi[:, KN]), _bits(fi0[:, KN])), case
                for other in (again[0] if mi else again, key[0]):
                    assert torch.equal(_bits(fi), _bits(other)), case
                if mi:
                    assert torch.equal(got[1], key[1]) and torch.equal(got[1], again[1]), case
                    assert 1 <= int(got[1].min()) and int(got[1].max()) <= mi, case
                assert ((key[-1] - ref[-1]).abs() / ref[-1]).max().item() <= 1e-6, case


def test_moment_iterative_counts_against_the_jax_engine(dev, capsys):
    """ROADMAP C2 for the moment kernel: on the seeded clouds of
    tests/iterative_counts.py its ALGO_ITERATIVE counts are no farther from
    the JAX f64 engine's stored counts than its plain version's (pooled
    histogram distance and equal share within COUNT_SLACK); DOFs within
    PARITY of the plain version."""
    import iterative_counts

    stored = iterative_counts.load()
    got = {"kernel": [], "plain": []}
    ref = []
    for key, dim, order, w, B, K, seed in iterative_counts.configs():
        xk, fk, nk, xi, fi0, kn = (torch.as_tensor(a, device=dev) if isinstance(a, np.ndarray)
                                   else a for a in iterative_counts.cloud(dim, order, B, K, seed))
        kw = dict(dimension=dim, order=order, weighting=w, knowns=kn,
                  max_iter=iterative_counts.MAX_ITER)
        fi_k, it_k = fit_kernel.fit_kernel(xk, fk, nk, xi, fi0, **kw)
        fi_p, it_p = fit_kernel.fit_moments_plain(xk, fk, nk, xi, fi0, **kw)
        assert _rel(fi_k, fi_p) <= PARITY, key
        got["kernel"].append(it_k.cpu().numpy())
        got["plain"].append(it_p.cpu().numpy())
        ref.append(stored[key])
    k = iterative_counts.shares(got["kernel"], ref)
    p = iterative_counts.shares(got["plain"], ref)
    with capsys.disabled():
        print("\nmoment counts vs JAX (equal, within one, histogram distance): kernel %s, "
              "plain %s" % (k, p))
    assert k[2] <= p[2] + COUNT_SLACK and k[0] >= p[0] - COUNT_SLACK


def test_routes_launch_the_moment_kernel_where_the_jax_package_does(dev):
    """The certified route sends 1D, 2D knowns and 2D ALGO_ITERATIVE to the
    moment kernel, sens and certified 3D to the rows kernel; a forced kernel
    sends 3D order 4 at K = 48 to the moment kernel; counts by launch."""
    def launches(fn):
        b = fit_kernel.LAUNCHES, fit_rows.LAUNCHES
        fn()
        torch.cuda.synchronize()
        return fit_kernel.LAUNCHES - b[0], fit_rows.LAUNCHES - b[1]

    xk, fk, nk, xi = _cloud(dev, 8192, 30, 4, seed=300, ragged=False)
    kw = dict(order=4, weighting=wtt.WEIGHT_CENTER)
    it_plan = wtt.plan_fit_many(xk, xi, iterative=True, **kw)
    assert it_plan.route.assembly == "moments"
    assert launches(lambda: wtt.fit_many(xk, fk, xi, iterative=True, max_iter=3,
                                         plan=it_plan, **kw)) == (1, 0)
    fi0 = torch.ones((8192, 15), dtype=torch.float64, device=dev)
    kn_plan = wtt.plan_fit_many(xk, xi, knowns=1, **kw)
    assert kn_plan.route.assembly == "moments"
    res = wtt.fit_many(xk, fk, xi, knowns=1, fi_init=fi0, plan=kn_plan, **kw)
    assert (res.fi[:, 0] == 1).all()
    assert launches(lambda: wtt.fit_many(xk, fk, xi, do_sens=True, backend="kernel",
                                         **kw)) == (0, 1)
    x1, f1, n1, i1 = _cloud(dev, 8192, 16, 2, seed=301, dim=1, ragged=False)
    r1 = wtt.plan_fit_many(x1, i1, order=2, weighting=wtt.WEIGHT_CENTER).route
    assert (r1.path, r1.assembly) == ("kernel", "moments")
    x3, f3, n3, i3 = _cloud(dev, 8192, 48, 4, seed=302, dim=3)
    assert launches(lambda: wtt.fit_many(x3, f3, i3, nk=n3, backend="kernel", **kw)) == (1, 0)
    res = wtt.fit_many(x3, f3, i3, nk=n3, backend="kernel", **kw)
    eng = wtt.fit_many(x3, f3, i3, nk=n3, backend="engine", **kw)
    assert _rel(res.fi, eng.fi) <= PARITY
    x3, f3, n3, i3 = _cloud(dev, 8192, 56, 4, seed=303, dim=3, ragged=False)
    assert wtt.plan_fit_many(x3, i3, **kw).route.assembly != "moments"
