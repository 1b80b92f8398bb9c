"""The port's constants and tables equal the JAX package's, exactly."""

import numpy as np
import pytest
import torch

from wlsqm_tpu.fitter import defs as jdefs
from wlsqm_tpu.fitter import tables as jtables
from wlsqm_tpu.ops import pallas_fit
from wlsqm_tpu_torch.fitter import defs, tables
from wlsqm_tpu_torch.ops import fit_kernel

torch.set_num_threads(1)


def test_defs_constants_equal():
    assert sorted(defs.__all__) == sorted(jdefs.__all__)
    for name in jdefs.__all__:
        ref = getattr(jdefs, name)
        if callable(ref):
            continue
        assert getattr(defs, name) == ref, name
    assert defs._DOF_COUNTS == jdefs._DOF_COUNTS
    assert defs.MAX_ORDER == jdefs.MAX_ORDER


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_number_of_dofs_equal(dim):
    for order in range(5):
        assert defs.number_of_dofs(dim, order) == jdefs.number_of_dofs(dim, order)
    with pytest.raises(ValueError):
        defs.number_of_dofs(dim, 5)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_tables_equal(dim):
    for name in ("EXPONENTS", "INV_FACT", "DEGREE"):
        a = getattr(tables, name)[dim]
        b = getattr(jtables, name)[dim]
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_chain_tables_equal_pallas(dim):
    """The lattice and chains the CUDA header is generated from are the
    TPU kernel's own."""
    for order in range(5):
        e, p, i = fit_kernel.moment_lattice(dim, 2 * order)
        je, jp, ji = pallas_fit._moment_lattice(dim, 2 * order)
        np.testing.assert_array_equal(e, je)
        assert p == jp and i == ji
        x, c = fit_kernel.dof_chain(dim, order)
        jx, jc = pallas_fit._dof_chain(dim, order)
        np.testing.assert_array_equal(x, jx)
        assert c == jc


def test_tables_header_lists_every_order():
    """One table struct per dimension and order; the warp body's instances
    (3D orders 3-4) also carry the device arrays it reads at run time."""
    h = fit_kernel.tables_header()
    for dim in (1, 2, 3):
        for order in range(5):
            no = defs.number_of_dofs(dim, order)
            nm = len(fit_kernel.moment_lattice(dim, 2 * order)[1])
            warp = fit_kernel.warp_body(dim, order)
            assert ("template <> struct MomentTables<%d, %d> {\n"
                    "  static constexpr int NO = %d;\n"
                    "  static constexpr int NM = %d;\n"
                    "  static constexpr bool kWarp = %s;"
                    % (dim, order, no, nm, str(warp).lower())) in h
    assert h.count("slot_at(int i)") == 2 and [
        (d, o) for d in (1, 2, 3) for o in range(5) if fit_kernel.warp_body(d, o)] == [(3, 3), (3, 4)]
