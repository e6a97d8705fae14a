"""Port parity: sketch primitives (kernels K2, K3, bin_scatter_add and
the OXLI pack/unpack mirrors) against khmer_tpu on the same inputs.
Integer data: the tolerance is exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from khmer_tpu.ops import sketch_ops as jax_ops
from khmer_tpu.storage import ByteStorage as JaxByteStorage
from khmer_tpu_torch import _u64
from khmer_tpu_torch.kernels import bin_scatter_add
from khmer_tpu_torch.ops import sketch_ops
from khmer_tpu_torch.primes import get_n_primes_near_x
from khmer_tpu_torch.storage import ByteStorage

SIZES = (1009, 1013, 1019, 1021)


def _prefilled(kind, rng, sizes=SIZES, high=300):
    total = sum(sizes)
    table = np.zeros(total + 1, np.uint32)
    occ = rng.random(total) < 0.3
    table[:total][occ] = rng.integers(1, high if kind == "byte" else 2,
                                      occ.sum())
    return table


def _t(u32):
    return torch.from_numpy(np.ascontiguousarray(u32).view(np.int32).copy())


@pytest.mark.parametrize("kind", ["byte", "nibble", "bit"])
def test_sketch_update_match(kind):
    """Pre-filled table, a batch full of duplicates and masked lanes:
    table, n_unique, is_new and the bigcount candidates agree."""
    rng = np.random.default_rng(7 if kind == "byte" else 8)
    table = _prefilled(kind, rng)
    distinct = rng.integers(0, 2 ** 64, 1500, dtype=np.uint64)
    hashes = distinct[rng.integers(0, distinct.size, 6000)]
    weights = rng.integers(0, 3, hashes.size).astype(np.uint32)

    spec = jax_ops.SketchSpec(kind, SIZES, use_bigcount=kind == "byte")
    j_table, _, j_nu, aux = jax_ops.sketch_update(
        spec, jnp.asarray(table), jnp.zeros((), jnp.uint64),
        jnp.asarray(5, jnp.uint64), jnp.asarray(hashes),
        jnp.asarray(weights))

    pspec = sketch_ops.SketchSpec(kind, SIZES)
    p_table = _t(table)
    nu = torch.tensor([5], dtype=torch.int64)
    is_new, found, overflowed = sketch_ops.sketch_update(
        pspec.geometry("cpu"), p_table, nu,
        _u64.as_tensor(hashes, "cpu"),
        torch.from_numpy(weights.view(np.int32)),
        track_bigcount=kind == "byte")

    np.testing.assert_array_equal(p_table.numpy().view(np.uint32),
                                  np.asarray(j_table))
    assert int(nu) == int(j_nu)
    np.testing.assert_array_equal(is_new.numpy(), np.asarray(aux["is_new"]))
    if kind == "byte":
        want = np.asarray(aux["bigcount_hashes"])[
            np.asarray(aux["bigcount_valid"])]
        assert not overflowed and not bool(aux["bigcount_overflow"])
        assert len(want) > 10
        assert set(found.tolist()) == set(want.tolist())


def test_bigcount_overflow_recovers_exactly():
    """More crossing lanes than the candidate buffer holds: the port's
    exact recovery yields khmer_tpu's candidate set."""
    rng = np.random.default_rng(9)
    sizes = (70001,)
    hashes = np.unique(rng.integers(0, 2 ** 64, 70000, dtype=np.uint64))
    hashes = hashes[: sketch_ops.BIGCOUNT_LANES + 500]
    base = np.full(sizes[0] + 1, 300, np.uint32)

    j = JaxByteStorage(sizes, use_bigcount=True)
    j.table = jnp.asarray(base)
    j.add_batch(hashes)
    p = ByteStorage(sizes, use_bigcount=True, device="cpu")
    p.table = _t(base)
    p.add_batch(hashes)
    assert len(p.bigcount_candidates) == hashes.size
    assert p.bigcount_candidates == {int(h) for h in j.bigcount_candidates}
    assert p.resolved_bigcounts() == j.resolved_bigcounts()


@pytest.mark.parametrize("kind,use_bigcount,cap",
                         [("byte", True, 65535), ("byte", False, 255),
                          ("nibble", False, 15), ("bit", False, 1)])
def test_sketch_get_match(kind, use_bigcount, cap):
    rng = np.random.default_rng(cap)
    table = rng.integers(0, 140000, sum(SIZES) + 1).astype(np.uint32)
    table[rng.random(table.size) < 0.2] = 0
    hashes = np.concatenate([rng.integers(0, 2 ** 64, 3000,
                                          dtype=np.uint64),
                             np.array([2 ** 64 - 1, 2 ** 63, 0],
                                      np.uint64)])
    spec = jax_ops.SketchSpec(kind, SIZES, use_bigcount=use_bigcount)
    want = np.asarray(jax_ops.sketch_get(spec, jnp.asarray(table),
                                         jnp.asarray(hashes)))
    pspec = sketch_ops.SketchSpec(kind, SIZES)
    got = sketch_ops.sketch_get(pspec.geometry("cpu"), _t(table),
                                _u64.as_tensor(hashes, "cpu"), cap)
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() == cap and want.min() == 0


def test_bin_scatter_add_matches_prototype_semantics():
    """Sorted unique bins with values in [1, 5), as
    benchmarks/explore_pallas_scatter.py feeds its Pallas scatter."""
    rng = np.random.default_rng(11)
    B, N = 100003, 4096
    idx = np.sort(rng.choice(B, N, replace=False)).astype(np.int64)
    vals = rng.integers(1, 5, N).astype(np.uint32)
    table = rng.integers(0, 2 ** 32, B, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jnp.asarray(table).at[idx].add(jnp.asarray(vals)))
    got = _t(table)
    bin_scatter_add(got, torch.from_numpy(idx),
                    torch.from_numpy(vals.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    with pytest.raises(IndexError):
        bin_scatter_add(got, torch.tensor([B]), torch.tensor(
            [1], dtype=torch.int32))


@pytest.mark.parametrize("kind", ["byte", "nibble", "bit"])
@pytest.mark.parametrize("density", [0.001, 0.5])
def test_oxli_pack_unpack_match(kind, density):
    """Save layout bytes (packed on the table's device, and by the host
    mirror) and the load widening (bin_scatter_add of the occupied bins)
    agree, on sparse tables and dense ones, with bins at and past 2**31
    (saturated: negative int32 patterns in the port)."""
    rng = np.random.default_rng(int(density * 1000) + len(kind))
    total = sum(SIZES)
    table = np.zeros(total + 1, np.uint32)
    occ = rng.random(total) < density
    table[:total][occ] = rng.integers(1, 300, occ.sum())
    table[[5, SIZES[0] + 1]] = [2 ** 31, 2 ** 32 - 1]
    spec = jax_ops.SketchSpec(kind, SIZES)
    want = np.asarray(jax_ops.pack_oxli_bytes(spec, jnp.asarray(table)))
    pspec = sketch_ops.SketchSpec(kind, SIZES)
    got = sketch_ops.pack_oxli_bytes(pspec, _t(table))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        sketch_ops.host_pack_oxli_bytes(pspec, table), want)
    back = sketch_ops.unpack_oxli_bytes(pspec, want, "cpu")
    np.testing.assert_array_equal(
        back.numpy().view(np.uint32),
        np.asarray(jax_ops.unpack_oxli_bytes(spec, want)))


def _mod_barrett(h, p, m):
    """Python mirror of csrc/common.cuh:mod_barrett on u64 ints; also
    returns the number of corrections it took."""
    r = h - ((h * m) >> 64) * p
    steps = 0
    while r >= p:
        r -= p
        steps += 1
    return r, steps


@pytest.mark.parametrize("p", list(get_n_primes_near_x(4, 1e8))
                         + [1, 2, 3, 4294967311, (1 << 61) - 1])
def test_barrett_modulo(p):
    """The kernels' reciprocal modulo equals % at the edges of each
    residue class and at random hashes above 2**63, in at most two
    corrections."""
    (m,) = sketch_ops.barrett_recips([p])
    assert m == ((1 << 64) - 1) // p
    top = (1 << 64) - 1
    hs = [0, p - 1, p, top, top - 1, 1 << 63]
    for k in (1, 2, 3, 1000003, top // p - 1, top // p):
        hs += [k * p - 1, k * p, k * p + 1]
    rng = np.random.default_rng(p % 1000)
    hs += [int(x) for x in rng.integers(1 << 63, top, 2000, dtype=np.uint64,
                                        endpoint=True)]
    for h in hs:
        h &= top
        r, steps = _mod_barrett(h, p, m)
        assert r == h % p and steps <= 2, (h, p)
    sizes = torch.tensor([p], dtype=torch.int64)
    got = _u64.umod(_u64.as_tensor(np.array(hs[-2000:], np.uint64), "cpu"),
                    sizes)
    assert got.tolist() == [h % p for h in hs[-2000:]]
