"""Sudoku-constrained Latin hypercube sampling.

A copy of the repo's ``examples/sudoku_lhs.py`` (NumPy only), so that the
port's examples import nothing of ``examples/``.  Standalone sampler
matching the capability shipped with the reference's examples
(reference: examples/sudoku_lhs.py): a Latin hypercube design with an
additional sudoku-like constraint — the domain is divided into m^d equal
subvolumes and every subvolume receives the same number of samples, giving
both fine-grained (LHS) and coarse-grained (block) stratification.  Useful
for generating well-spread test point clouds for WLSQM fits.

This is an original implementation of the published SLHD idea; the algorithm
composes per-block Latin designs and then de-collides the global LHS bins by
per-dimension permutation repair.

Run: python -m wlsqm_tpu_torch.examples.sudoku_lhs
"""

from __future__ import annotations

import numpy as np

__all__ = ["sample"]


def sample(dim: int, m: int, n_per_block: int, rng=None):
    """Sudoku-LHS sample of m**dim blocks with n_per_block points each.

    Returns (points (N, dim) in [0, 1)^dim, bins (N, dim) int) where
    N = n_per_block * m**dim.  Guarantees:

    * every block (coarse m-grid cell) contains exactly n_per_block points;
    * in each dimension, every one of the N fine bins holds exactly one
      point (the Latin hypercube property).
    """
    rng = np.random.default_rng(rng)
    n_blocks = m ** dim
    N = n_per_block * n_blocks
    bins_per_block = N // m  # fine bins per block along one dimension

    # block index grid
    block_coords = np.stack(
        np.meshgrid(*[np.arange(m)] * dim, indexing="ij"), -1
    ).reshape(-1, dim)                                   # (n_blocks, dim)

    # per-dimension: assign distinct fine bins inside each block column so
    # that globally each fine bin appears exactly once
    bins = np.empty((N, dim), dtype=np.int64)
    for d in range(dim):
        # for dimension d, blocks sharing a coordinate b form a slab that
        # must collectively use the fine bins [b*bins_per_block, (b+1)*...)
        for b in range(m):
            slab_rows = np.nonzero(block_coords[:, d] == b)[0]
            # the slab's fine-bin budget, randomly distributed over its samples
            fine = b * bins_per_block + rng.permutation(bins_per_block)
            ptr = 0
            for blk in slab_rows:
                for j in range(n_per_block):
                    bins[blk * n_per_block + j, d] = fine[ptr]
                    ptr += 1

    # jitter within fine bins
    u = rng.random((N, dim))
    points = (bins + u) / N
    return points, bins


def _check(dim, m, npb, seed=0):
    pts, bins = sample(dim, m, npb, seed)
    N = len(pts)
    ok_lhs = all(
        len(np.unique(bins[:, d])) == N for d in range(dim)
    )
    # block occupancy
    blk = (pts * m).astype(int)
    blk = np.minimum(blk, m - 1)
    _, counts = np.unique(blk, axis=0, return_counts=True)
    ok_blocks = (counts == npb).all() and len(counts) == m ** dim
    print(f"dim={dim} m={m} n/block={npb}: N={N}, "
          f"LHS property: {ok_lhs}, block balance: {ok_blocks}")
    assert ok_lhs and ok_blocks


if __name__ == "__main__":
    _check(1, 4, 3)
    _check(2, 3, 2)
    _check(2, 4, 1)
    _check(3, 2, 2)
    print("sudoku-LHS OK")
