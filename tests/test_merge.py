import numpy as np
import jax.numpy as jnp
import pytest

from biograph_jax.core import dna
from biograph_jax.build.seqset_build import build_seqset
from biograph_jax.build.readmap_build import build_readmap
from biograph_jax.build.merge import merge_seqsets, migrate_readmap


def _reads(rng, genome, n, L=30):
    starts = rng.integers(0, len(genome) - L, size=n)
    codes = np.stack([genome[s : s + L] for s in starts])
    return codes, np.full(n, L, np.int32)


@pytest.mark.slow
def test_merge_two_samples(rng):
    g1 = rng.integers(0, 4, size=2000, dtype=np.uint8)
    g2 = g1.copy()
    g2[800] = (g2[800] + 1) % 4  # sample 2 has a variant
    c1, l1 = _reads(rng, g1, 300)
    c2, l2 = _reads(rng, g2, 300)
    ss1 = build_seqset(c1, l1)
    ss2 = build_seqset(c2, l2)
    rm1 = build_readmap(ss1, c1, l1)
    rm2 = build_readmap(ss2, c2, l2)

    merged, (mm1, mm2) = merge_seqsets([ss1, ss2])

    # merged contains every sequence of both inputs
    q1 = merged.d.find(jnp.asarray(c1), jnp.asarray(l1))
    q2 = merged.d.find(jnp.asarray(c2), jnp.asarray(l2))
    assert bool((q1.begin < q1.end).all())
    assert bool((q2.begin < q2.end).all())

    # mergemap consistency: input entry's sequence is a prefix of its merged
    # entry's sequence
    for ss, mm in ((ss1, mm1), (ss2, mm2)):
        for e in range(0, ss.n_entries, max(ss.n_entries // 20, 1)):
            s_in = ss.entry_sequence(e)
            s_merged = merged.entry_sequence(int(mm[e]))
            assert s_merged.startswith(s_in)

    # migrated readmaps answer coverage on the merged seqset
    rm1m = migrate_readmap(rm1, merged, mm1)
    rm2m = migrate_readmap(rm2, merged, mm2)
    assert rm1m.num_entries == rm1.num_entries
    # sample2's variant context: covered by rm2, not rm1
    win = g2[780:830]
    f2, r2 = rm2m.coverage(jnp.asarray(win[None, :]), jnp.asarray([50]))
    f1, r1 = rm1m.coverage(jnp.asarray(win[None, :]), jnp.asarray([50]))
    tot2 = np.asarray(f2 + r2)[0]
    tot1 = np.asarray(f1 + r1)[0]
    assert tot2[15:35].min() >= 1
    assert tot1[15:25].max() == 0  # sample1 reads don't match the variant ctx


@pytest.mark.slow
def test_merge_identical_is_idempotent(rng):
    g = rng.integers(0, 4, size=1500, dtype=np.uint8)
    c, l = _reads(rng, g, 200)
    ss = build_seqset(c, l)
    merged, (mm1, mm2) = merge_seqsets([ss, ss])
    assert merged.n_entries == ss.n_entries
    assert (mm1 == np.arange(ss.n_entries)).all()
    assert (mm2 == np.arange(ss.n_entries)).all()
