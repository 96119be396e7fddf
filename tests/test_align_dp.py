import numpy as np
import pytest

from biograph_jax.ops.align_dp import align_blocks_batch


def _apply_ops(ref, alt, ops):
    """Replay ops; M consumes both, D consumes ref, I consumes alt; the
    emitted alt stream must equal alt and ref stream equal ref."""
    ri = ai = 0
    for op, i, j in ops:
        if op == "M":
            assert i == ri and j == ai
            ri += 1
            ai += 1
        elif op == "D":
            assert i == ri
            ri += 1
        else:
            assert j == ai
            ai += 1
    return ri == len(ref) and ai == len(alt)


def _cost(ref, alt, ops):
    c = 0.0
    prev = None
    for op, i, j in ops:
        if op == "M":
            c += 0.0 if ref[i] == alt[j] else 1.0
        else:
            c += 2.5 if prev != op else 0.5
        prev = op
    return c


def test_simple_cases(rng):
    cases = [
        ([0, 1, 2, 3], [0, 1, 2, 3]),          # equal
        ([0, 1, 2, 3], [0, 1, 1, 3]),          # 1 SNP
        ([0, 1, 2, 3], [0, 1, 3]),             # 1 del
        ([0, 1, 3], [0, 1, 2, 3]),             # 1 ins
        ([0, 1, 2, 3, 0, 1], [0, 3, 2, 1, 0, 1]),  # SNPs
        ([0] * 10, [0] * 4),                   # big del
        ([1, 2], [3, 0, 1, 2, 3, 3]),          # messy
    ]
    refs = [np.array(r, np.uint8) for r, a in cases]
    alts = [np.array(a, np.uint8) for r, a in cases]
    all_ops = align_blocks_batch(refs, alts)
    for (r, a), ops in zip(cases, all_ops):
        assert _apply_ops(r, a, ops), (r, a, ops)


def test_matches_scalar_nw_cost(rng):
    """Batch DP cost == scalar DP cost on random block pairs."""
    from biograph_jax.variants.discover import _align_decompose

    refs, alts = [], []
    for _ in range(20):
        n = rng.integers(3, 40)
        m = rng.integers(3, 40)
        refs.append(rng.integers(0, 4, n).astype(np.uint8))
        alts.append(rng.integers(0, 4, m).astype(np.uint8))
    all_ops = align_blocks_batch(refs, alts)

    def scalar_cost(rs, as_):
        n, m = len(rs), len(as_)
        INF = 1e18
        M = np.full((n + 1, m + 1), INF)
        Ix = np.full((n + 1, m + 1), INF)
        Iy = np.full((n + 1, m + 1), INF)
        M[0, 0] = 0.0
        for i in range(1, n + 1):
            Ix[i, 0] = 2.5 + 0.5 * (i - 1)
        for j in range(1, m + 1):
            Iy[0, j] = 2.5 + 0.5 * (j - 1)
        for i in range(1, n + 1):
            for j in range(1, m + 1):
                sub = 0.0 if rs[i - 1] == as_[j - 1] else 1.0
                M[i, j] = sub + min(M[i-1,j-1], Ix[i-1,j-1], Iy[i-1,j-1])
                Ix[i, j] = min(M[i-1,j] + 2.5, Ix[i-1,j] + 0.5)
                Iy[i, j] = min(M[i,j-1] + 2.5, Iy[i,j-1] + 0.5)
        return min(M[n, m], Ix[n, m], Iy[n, m])

    for rs, as_, ops in zip(refs, alts, all_ops):
        assert _apply_ops(rs, as_, ops)
        assert abs(_cost(rs, as_, ops) - scalar_cost(rs, as_)) < 1e-6, (
            rs, as_, ops
        )
