"""Port parity of the OXLI save: for byte, nibble and bit tables with
their nonzero bins below and above khmer_tpu's sparse-route threshold
(so that khmer_tpu takes each of its two routes), the port's one route
(K14) gives khmer_tpu's raw_bytes(), and the saved .ct, .pt and
small-count files are byte-equal.  The plain versions of K13
(count_nonzero) and K14 (pack_oxli_bytes) equal a numpy oracle.  Inputs
from a seed; exact equality.  One geometry for khmer_tpu's side, to keep
its compiles down."""

from unittest import mock

import numpy as np
import pytest
import torch

import khmer_tpu.ops.sketch_ops as jax_ops
from khmer_tpu import storage as jax_storage
from khmer_tpu.io import oxli_format as jax_oxli

from khmer_tpu_torch.convert import storage_from_numpy
from khmer_tpu_torch.io import oxli_format
from khmer_tpu_torch.kernels import plain
from khmer_tpu_torch.ops.sketch_ops import SketchSpec

SIZES = (10007, 10009, 10037)  # odd, none a multiple of 8
KINDS = ("byte", "nibble", "bit")
JAX_CLASS = {"byte": jax_storage.ByteStorage,
             "nibble": jax_storage.NibbleStorage,
             "bit": jax_storage.BitStorage}


def _bins(seed, n, nonzero):
    """n + 1 u32 bins (the spare bin 0) with `nonzero` nonzero bins, a
    tenth of them at or above 2**31 and some past 255."""
    rng = np.random.default_rng(seed)
    bins = np.zeros(n + 1, np.uint32)
    at = rng.choice(n, nonzero, replace=False)
    vals = rng.integers(1, 600, nonzero, dtype=np.uint64)
    big = rng.random(nonzero) < 0.1
    vals[big] = rng.integers(2 ** 31, 2 ** 32, int(big.sum()),
                             dtype=np.uint64)
    bins[at] = vals.astype(np.uint32)
    return bins


def _threshold(kind):
    """The nonzero bins below which khmer_tpu takes the sparse route."""
    return SketchSpec(kind, SIZES).total_bytes // 24


def _nonzero(kind, side):
    t = _threshold(kind)
    return {"sparse": t - 1, "dense": t + 1, "empty": 0,
            "full": sum(SIZES)}[side]


def _pair(kind, side, seed=5):
    """(port storage on the CPU, khmer_tpu storage) over the same bins."""
    import jax.numpy as jnp

    bins = _bins(seed, sum(SIZES), _nonzero(kind, side))
    port = storage_from_numpy(kind, SIZES, bins, device="cpu")
    jst = JAX_CLASS[kind](SIZES)
    jst.table = jnp.asarray(bins)
    return port, jst


SIDES = ("sparse", "dense", "empty", "full")


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("kind", KINDS)
def test_raw_bytes_equal_and_same_route(kind, side):
    """The port's raw_bytes() equals khmer_tpu's on each side of
    khmer_tpu's threshold, khmer_tpu taking the route the side names."""
    port, jst = _pair(kind, side)
    got = port.raw_bytes()
    with mock.patch.object(jax_ops, "sparse_raw_bytes",
                           wraps=jax_ops.sparse_raw_bytes) as sparse:
        want = np.asarray(jst.raw_bytes())
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    jax_route = "sparse" if sparse.call_count else "dense"
    assert jax_route == ("sparse" if side in ("sparse", "empty")
                         else "dense")


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("kind", KINDS)
def test_saved_files_equal(kind, side, tmp_path):
    """.ct (byte), .pt (bit) and small-count (nibble) files of both
    packages are byte-equal, and each loads the other's."""
    port, jst = _pair(kind, side, seed=11)
    mine, theirs = tmp_path / "port.tbl", tmp_path / "jax.tbl"
    oxli_format.save_storage(str(mine), 20, port)
    jax_oxli.save_storage(str(theirs), 20, jst)
    assert mine.read_bytes() == theirs.read_bytes()
    back, k = oxli_format.load_storage(str(theirs), (kind,), device="cpu")
    assert k == 20 and np.array_equal(back.raw_bytes(), port.raw_bytes())


def _oracle_pack(kind, sizes, bins):
    """The OXLI stream of u32 bins, table by table, by numpy alone."""
    out, off = [], 0
    cap = {"byte": 255, "nibble": 15, "bit": 1}[kind]
    for size in sizes:
        v = np.minimum(bins[off: off + size].astype(np.uint64), cap)
        off += size
        if kind == "byte":
            out.append(v.astype(np.uint8))
            continue
        per = 2 if kind == "nibble" else 8
        nb = size // per + 1
        pad = np.zeros(nb * per, np.uint64)
        pad[:size] = v
        pad = pad.reshape(nb, per)
        if kind == "nibble":
            out.append((pad[:, 0] * 16 + pad[:, 1]).astype(np.uint8))
        else:
            out.append((pad << np.arange(8, dtype=np.uint64)).sum(1)
                       .astype(np.uint8))
    return np.concatenate(out)


PLAIN_SIZES = [(1,), (7,), (8,), (9,), (1009, 1013, 1019), (16,) * 32]


@pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
@pytest.mark.parametrize("sizes", PLAIN_SIZES, ids=lambda s: "x".join(
    map(str, s[:3])) + ("..." if len(s) > 3 else ""))
def test_plain_save_kernels_equal_numpy(sizes, density):
    rng = np.random.default_rng(len(sizes) + int(100 * density))
    n = sum(sizes)
    bins = rng.integers(1, 2 ** 32, n + 1, dtype=np.uint64)
    bins[rng.random(n + 1) >= density] = 0
    bins = bins.astype(np.uint32)
    table = torch.from_numpy(bins.view(np.int32))
    for lo, hi in ((0, n), (0, n + 1), (n // 3, n // 2), (n, n)):
        assert int(plain.count_nonzero(table, lo, hi)) == \
            np.count_nonzero(bins[lo:hi])
    for kind in KINDS:
        spec = SketchSpec(kind, sizes)
        got = plain.pack_oxli_bytes(table, kind, *spec.geometry("cpu")[:2],
                                    spec.bytes_per_table)
        assert np.array_equal(got.numpy(), _oracle_pack(kind, sizes, bins))
