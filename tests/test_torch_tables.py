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
    h = fit_kernel.tables_header()
    for order in range(5):
        no = defs.number_of_dofs(2, order)
        nm = len(fit_kernel.moment_lattice(2, 2 * order)[1])
        assert ("template <> struct MomentTables<%d> {\n"
                "  static constexpr int NO = %d;\n"
                "  static constexpr int NM = %d;" % (order, no, nm)) in h
