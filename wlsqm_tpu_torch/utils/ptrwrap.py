"""Pointer-wrapper compatibility stub.

Port of :mod:`wlsqm_tpu.utils.ptrwrap`.  The reference smuggles a C
``void*`` through a Python attribute so the Python-level ExpertSolver can
hold a CaseManager pointer (reference: wlsqm/utils/ptrwrap.pyx).  This
package holds no raw pointers — the prepared state is a dataclass of
tensors — so the class survives only as an inert container for source
compatibility.
"""

__all__ = ["PointerWrapper"]


class PointerWrapper:
    """Holds an opaque object; kept for API compatibility only."""

    def __init__(self):
        self.ptr = None

    def set_ptr(self, ptr):
        self.ptr = ptr
