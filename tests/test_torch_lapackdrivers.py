"""The port's lapackdrivers against the JAX package's module.

Both are the same host code over SciPy's LAPACK (the functions write into
the caller's Fortran-ordered NumPy arrays), so every public function is
held bit for bit: its return value and every array it writes in place,
on the inputs of tests/test_lapackdrivers.py.  The checks of that file's
own semantics (solutions against NumPy, equilibrated norms, the error
paths) run on the port's module.
"""

import copy
import enum

import numpy as np
import pytest

import wlsqm_tpu.utils.lapackdrivers as J
import wlsqm_tpu_torch.utils.lapackdrivers as T


def F(a):
    return np.asfortranarray(a)


def _sym(rng, n):
    M = rng.standard_normal((n, n))
    return (M + M.T) / 2 + n * np.eye(n)


def _gen(rng, n):
    return rng.standard_normal((n, n)) + n * np.eye(n)


def _sym_stack(rng, n, nb):
    M = rng.standard_normal((n, n, nb))
    return (M + np.swapaxes(M, 0, 1)) / 2 + n * np.eye(n)[:, :, None]


def _gen_stack(rng, n, nb):
    return rng.standard_normal((n, n, nb)) + n * np.eye(n)[:, :, None]


def _factored(rng, factor, build):
    A = F(build(rng))
    return A, factor(A)


def _mfactored(rng, mfactor, stack):
    A = F(stack)
    ipiv = np.zeros(A.shape[::2], np.int32, order="F")
    mfactor(A, ipiv)
    return A, ipiv


#: name -> inputs (made from the seeded generator; the JAX module factors
#: the inputs of the *factored functions, the same for both)
CASES = {
    "distribute_items": lambda r: (10, 3),
    "copygeneral": lambda r: (np.zeros((4, 4)), r.standard_normal((4, 4))),
    "copysymmu": lambda r: (np.full((4, 4), 99.0), r.standard_normal((4, 4))),
    "symmetrize": lambda r: (r.standard_normal((4, 4)),),
    "msymmetrize": lambda r: (F(r.standard_normal((5, 5, 9))),),
    "msymmetrizep": lambda r: (F(r.standard_normal((5, 5, 9))), 4),
    "rescale_columns": lambda r: (F(r.standard_normal((4, 4)) * 100.0),),
    "rescale_rows": lambda r: (F(r.standard_normal((6, 4))),),
    "rescale_twopass": lambda r: (F(r.standard_normal((4, 4)) * 100.0),),
    "rescale_dgeequ": lambda r: (F(np.array([[4.0, 1.0], [1.0, 3.0]])),),
    "rescale_ruiz2001": lambda r: (F(np.diag([1e8, 1.0, 1e-8]) + 0.1),),
    "rescale_scalgm": lambda r: (F(np.diag([1e6, 1.0, 1e-6]) + 0.05),),
    "do_rescale": lambda r: (F(r.standard_normal((4, 4)) * 100.0), 4),
    "init_scaling": lambda r: (3, 4),
    "apply_scaling": lambda r: (r.standard_normal((3, 4)), r.uniform(0.5, 2, 3),
                                r.uniform(0.5, 2, 4)),
    "tridiag": lambda r: (np.array([0.0, -1, -1, -1]), np.full(4, 2.0),
                          np.array([-1.0, -1, -1, 0]), np.array([1.0, 0, 0, 1])),
    "symmetric2x2": lambda r: (_sym(r, 2), r.standard_normal(2)),
    "symmetric": lambda r: (F(_sym(r, 5)), r.standard_normal(5)),
    "symmetricfactor": lambda r: (F(_sym(r, 5)),),
    "symmetricfactored": lambda r: _factored(r, J.symmetricfactor, lambda q: _sym(q, 5))
    + (r.standard_normal(5),),
    "symmetrics": lambda r: (F(_sym(r, 5)), F(r.standard_normal((5, 3)))),
    "symmetricsp": lambda r: (F(_sym(r, 5)), F(r.standard_normal((5, 3))), 4),
    "msymmetric": lambda r: (F(_sym_stack(r, 5, 11)), F(r.standard_normal((5, 11)))),
    "msymmetricp": lambda r: (F(_sym_stack(r, 5, 11)), F(r.standard_normal((5, 11))), 4),
    "msymmetricfactor": lambda r: (F(_sym_stack(r, 6, 8)), np.zeros((6, 8), np.int32, order="F")),
    "msymmetricfactorp": lambda r: (F(_sym_stack(r, 6, 8)),
                                    np.zeros((6, 8), np.int32, order="F"), 4),
    "msymmetricfactored": lambda r: _mfactored(r, J.msymmetricfactor, _sym_stack(r, 6, 8))
    + (F(r.standard_normal((6, 8))),),
    "msymmetricfactoredp": lambda r: _mfactored(r, J.msymmetricfactor, _sym_stack(r, 6, 8))
    + (F(r.standard_normal((6, 8))), 4),
    "general2x2": lambda r: (_gen(r, 2), r.standard_normal(2)),
    "general": lambda r: (F(r.standard_normal((5, 5))), r.standard_normal(5)),
    "generalfactor": lambda r: (F(_gen(r, 6)),),
    "generalfactored": lambda r: _factored(r, J.generalfactor, lambda q: _gen(q, 6))
    + (r.standard_normal(6),),
    "generals": lambda r: (F(_gen(r, 5)), F(r.standard_normal((5, 3)))),
    "generalsp": lambda r: (F(_gen(r, 5)), F(r.standard_normal((5, 3))), 3),
    "mgeneral": lambda r: (F(_gen_stack(r, 4, 7)), F(r.standard_normal((4, 7)))),
    "mgeneralp": lambda r: (F(_gen_stack(r, 4, 7)), F(r.standard_normal((4, 7))), 3),
    "mgeneralfactor": lambda r: (F(_gen_stack(r, 6, 8)), np.zeros((6, 8), np.int32, order="F")),
    "mgeneralfactorp": lambda r: (F(_gen_stack(r, 6, 8)),
                                  np.zeros((6, 8), np.int32, order="F"), 4),
    "mgeneralfactored": lambda r: _mfactored(r, J.mgeneralfactor, _gen_stack(r, 6, 8))
    + (F(r.standard_normal((6, 8))),),
    "mgeneralfactoredp": lambda r: _mfactored(r, J.mgeneralfactor, _gen_stack(r, 6, 8))
    + (F(r.standard_normal((6, 8))), 4),
    "svd": lambda r: (F(r.standard_normal((5, 5))),),
}


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
            np.ascontiguousarray(a).view(np.uint8), np.ascontiguousarray(b).view(np.uint8))
    return a == b and type(a) is type(b)


def test_the_same_public_names():
    assert T.__all__ == J.__all__
    assert set(CASES) == set(T.__all__) - {"ScalingAlgo"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bit_equal_to_the_jax_module(name):
    args = CASES[name](np.random.default_rng(sum(map(ord, name))))
    aj, at = copy.deepcopy(args), copy.deepcopy(args)
    rj = getattr(J, name)(*aj)
    rt = getattr(T, name)(*at)
    assert _same(rt, rj), name
    for x, y in zip(at, aj):
        assert _same(x, y), name
    changed = [not _same(x, y) for x, y in zip(at, args)]
    if name not in ("distribute_items", "init_scaling", "copygeneral", "copysymmu",
                    "symmetricfactored", "generalfactored", "msymmetricfactored",
                    "msymmetricfactoredp", "mgeneralfactored", "mgeneralfactoredp"):
        assert any(changed) or name == "svd", "%s wrote nothing in place" % name


def test_tridiag():
    x = np.array([1.0, 0.0, 0.0, 1.0])
    T.tridiag(np.array([0.0, -1, -1, -1]), np.full(4, 2.0), np.array([-1.0, -1, -1, 0]), x)
    np.testing.assert_allclose(x, [0.625, 0.25, 0.5, 0.75], atol=1e-14)


def test_solvers_match_numpy(rng):
    A0, b0 = _gen(rng, 6), rng.standard_normal(6)
    want = np.linalg.solve(A0, b0)
    for solve in (T.general, T.symmetric):
        M = A0 if solve is T.general else (A0 + A0.T) / 2
        b = b0.copy()
        solve(F(M.copy()), b)
        np.testing.assert_allclose(b, np.linalg.solve(M, b0), atol=1e-12)
    A = F(A0.copy())
    ipiv = T.generalfactor(A)
    b = b0.copy()
    T.generalfactored(A, ipiv, b)
    np.testing.assert_allclose(b, want, atol=1e-12)


def test_batched_factor_pairs_interchange_with_single_slices(rng):
    """dgetrf/dsytrf format: a slice of a batched factorization solves
    through the single-matrix pair (reference:
    wlsqm/utils/lapackdrivers.pyx:1196-1354, 1616-1689)."""
    for mfactor, single, stack in ((T.mgeneralfactor, T.generalfactored, _gen_stack),
                                   (T.msymmetricfactor, T.symmetricfactored, _sym_stack)):
        A0 = stack(rng, 5, 4)
        A = F(A0.copy())
        ipiv = np.zeros((5, 4), np.int32, order="F")
        mfactor(A, ipiv)
        b0 = rng.standard_normal(5)
        b = b0.copy()
        single(F(A[:, :, 2]), np.ascontiguousarray(ipiv[:, 2]), b)
        np.testing.assert_allclose(b, np.linalg.solve(A0[:, :, 2], b0), atol=1e-10)


def test_scalings_equilibrate(rng):
    A = F(np.diag([1e8, 1.0, 1e-8]) + 0.1)
    T.rescale_ruiz2001(A)
    np.testing.assert_allclose(np.abs(A).max(axis=0), 1.0, atol=1e-8)
    A = F(rng.standard_normal((4, 4)) * 100.0)
    T.rescale_columns(A)
    np.testing.assert_allclose(np.linalg.norm(A, axis=0), 1.0, atol=1e-12)
    A0 = rng.standard_normal((6, 4))
    A = F(A0.copy())
    rs, cs = T.rescale_rows(A)
    np.testing.assert_allclose(A, A0 * rs[:, None] * cs[None, :], atol=1e-14)


def test_error_paths_and_enum():
    with pytest.raises(np.linalg.LinAlgError):
        T.rescale_dgeequ(F(np.array([[1.0, 1.0], [0.0, 0.0]])))
    with pytest.raises(ValueError, match="Unknown algorithm"):
        T.do_rescale(F(np.eye(3)), 999)
    assert issubclass(T.ScalingAlgo, enum.IntEnum)
    assert [int(a) for a in T.ScalingAlgo] == [int(a) for a in J.ScalingAlgo]
    assert [a.name for a in T.ScalingAlgo] == [a.name for a in J.ScalingAlgo]
    bs, bi = T.distribute_items(10, 3)
    np.testing.assert_array_equal(bi, [0, 4, 7])
