"""Port parity of trim-low-abund's first-pass batch step, kernel K7
(trim_chain): khmer_tpu_torch against khmer_tpu on the same generated
read bundles (tests/test_torch_diginorm.py:make_bundles, without the
mate shorter than k, which both raise on).

Three consecutive batches of 64 bundles go through
Countgraph.trim_pass1_batch on both packages, from an empty table of
4 x 20011 bins, with and without the diginorm branch (dn_cov).  Branches, every row's first_bad, table bins and n_unique are
equal after each batch.  Integer data: exact equality."""

import numpy as np
import pytest

import khmer_tpu
from khmer_tpu_torch import Countgraph

from .test_torch_diginorm import K, make_bundles, port_table


def _bundles(seed):
    batches = make_bundles(seed)
    s0, s1 = batches[0][5]
    batches[0][5] = (s0, None)
    return batches


@pytest.mark.parametrize("size,trim_at,dn_cov,cutoff", [
    (20011, 6, None, 2), (20011, 4, 6, 2), (20011, 5, 8, 3)])
def test_trim_pass1_batches_match(size, trim_at, dn_cov, cutoff):
    j = khmer_tpu.Countgraph(K, size, 4)
    p = Countgraph(K, size, 4, device="cpu")
    seen = set()
    for batch in _bundles(size + trim_at):
        jb, jf = j.trim_pass1_batch(batch, trim_at, dn_cov, cutoff=cutoff)
        pb, pf = p.trim_pass1_batch(batch, trim_at, dn_cov, cutoff=cutoff)
        assert np.array_equal(pb.numpy(), np.asarray(jb).astype(np.uint8))
        assert np.array_equal(pf.numpy(), np.asarray(jf))
        assert np.array_equal(port_table(p), np.asarray(j.storage.table))
        assert p.n_unique_kmers() == j.n_unique_kmers()
        seen.update(pb.tolist())
    assert seen == ({1, 2} if dn_cov is None else {0, 1, 2})


def test_short_read_raises_before_upload():
    """A real read shorter than k raises ValueError on both packages,
    and the port's table is left as it was."""
    batch = make_bundles(1, n_batches=1)[0]
    j = khmer_tpu.Countgraph(K, 20011, 4)
    p = Countgraph(K, 20011, 4, device="cpu")
    with pytest.raises(ValueError):
        j.trim_pass1_batch(batch, 6)
    with pytest.raises(ValueError):
        p.trim_pass1_batch(batch, 6)
    assert not port_table(p).any() and p.n_unique_kmers() == 0
