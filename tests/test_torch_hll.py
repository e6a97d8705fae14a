"""Port parity of kernel K9 (hll_update), HLLCounter and unique-kmers:
khmer_tpu_torch against khmer_tpu on the same generated input.

K9's plain version is held to khmer_tpu's _make_update_fn on one flat
chunk with masked lanes at p = 4, 14 and 16 (-e 0.26, 0.01 and 0.005),
and HLLCounter's registers and estimates to khmer_tpu.HLLCounter's
after consume_seqfile (the port's native-loader chunks against
khmer_tpu's Python records), consume_string on raw bytes (lowercase, N)
and add, and after merge; then the error paths, pickling and
convert.hll_from_numpy; then unique_kmers.main's stderr lines, stdout
(-S) and report bytes (-R, --diagnostics) against
scripts/unique-kmers.py.  Registers and estimates are integers: exact
equality."""

import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import khmer_tpu
import khmer_tpu_torch
from khmer_tpu.hllcounter import _make_update_fn
from khmer_tpu_torch import HLLCounter, _u64, convert, kernels
from khmer_tpu_torch.scripts import unique_kmers

from .khmer_tst_utils import runscript
from .test_torch_countgraph import write_reads
from .torch_cwd import cwd_for_module, cwd_for_test  # noqa: F401

K = 20
RATES = {4: 0.26, 14: 0.01, 16: 0.005}  # p -> -e


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_hll")
    paths = []
    for seed, n_reads in ((5, 1500), (6, 700)):
        path = str(d / "reads{}.fa".format(seed))
        write_reads(path, seed=seed, n_reads=n_reads, repeats=20)
        paths.append(path)
    return paths


@pytest.mark.parametrize("p", sorted(RATES))
def test_hll_update_matches_update_fn(p):
    rng = np.random.default_rng(p)
    n = 1 << 14
    byts = rng.choice(np.frombuffer(b"ACGTACGTACGTN", np.uint8), n)
    weights = (rng.random(n) < 0.7).astype(np.uint8)
    m = 1 << p
    fn = _make_update_fn(K, p, m)
    want = np.asarray(fn(jnp.zeros(m + 1, jnp.uint8), jnp.asarray(byts),
                         jnp.asarray(weights)))[:m]
    regs = torch.zeros(m, dtype=torch.uint8)
    kernels.hll_update(torch.from_numpy(byts), torch.from_numpy(weights), K,
                       p, m, regs)
    assert np.array_equal(regs.numpy(), want)
    assert want.any()


@pytest.mark.parametrize("p", sorted(RATES))
def test_counter_matches_khmer_tpu(files, p):
    j = khmer_tpu.HLLCounter(RATES[p], K)
    t = HLLCounter(RATES[p], K, device="cpu")
    assert t._p == j._p == p
    assert t.consume_seqfile(files[0]) == j.consume_seqfile(files[0])
    assert t.counters == j.counters
    assert t.estimate_cardinality() == j.estimate_cardinality()
    raw = "ACGTTGCAaacgtnNNACGTRYACGTTTGCAGGCATTACG" * 3
    assert t.consume_string(raw) == j.consume_string(raw)
    assert t.consume_string("ACG") == j.consume_string("ACG") == 0
    for s in ("ACGTAC", "TTTTTTTTTTTTTTTTTTTTTTTTTTT", "acgt"):
        t.add(s)
        j.add(s)
    assert t.counters == j.counters
    assert len(t) == len(j) == t.estimate_cardinality()
    j2 = khmer_tpu.HLLCounter(RATES[p], K)
    t2 = HLLCounter(RATES[p], K, device="cpu")
    j2.consume_seqfile(files[1])
    t2.consume_seqfile(files[1])
    j.merge(j2)
    t.merge(t2)
    assert t.counters == j.counters
    assert t.estimate_cardinality() == j.estimate_cardinality()
    again = convert.hll_from_numpy(np.asarray(j._counters)[:-1], K, "cpu")
    assert again.counters == j.counters
    assert again.estimate_cardinality() == j.estimate_cardinality()
    back = pickle.loads(pickle.dumps(t))
    assert back.counters == t.counters and back.ksize == K


def test_stream_records_counts_the_same(files, capsys):
    j = khmer_tpu.HLLCounter(0.01, K)
    t = HLLCounter(0.01, K, device="cpu")
    assert t.consume_seqfile(files[1], stream_records=True) == \
        j.consume_seqfile(files[1])
    assert t.counters == j.counters
    assert capsys.readouterr().out.count(">") == 720


def _raises(fn):
    try:
        fn()
    except Exception as e:  # the exception both sides must raise alike
        return type(e), str(e)
    return None


def test_error_paths_match():
    cases = [
        lambda m, c: m.HLLCounter(-0.01, K, **c),
        lambda m, c: m.HLLCounter(0.5, K, **c),
        lambda m, c: m.HLLCounter(0.001, K, **c),
        lambda m, c: m.HLLCounter(0.01, K, **c).merge(
            m.HLLCounter(0.02, K, **c)),
        lambda m, c: m.HLLCounter(0.01, K, **c).merge(
            m.HLLCounter(0.01, K + 1, **c)),
        lambda m, c: setattr(m.HLLCounter(0.01, K, **c), "ksize", 0),
        lambda m, c: setattr(m.HLLCounter(0.01, K, **c), "counters", [0]),
        lambda m, c: setattr(m.HLLCounter(0.01, K, **c), "error_rate", -1),
    ]
    for case in cases:
        want = _raises(lambda: case(khmer_tpu, {}))
        assert want is not None
        assert _raises(lambda: case(khmer_tpu_torch,
                                    {"device": "cpu"})) == want
    for side, kw in ((khmer_tpu, {}), (khmer_tpu_torch, {"device": "cpu"})):
        h = side.HLLCounter(0.01, K, **kw)
        h.consume_string("ACGT" * 10)
        with pytest.raises(AttributeError):
            h.ksize = 21
        with pytest.raises(AttributeError):
            h.error_rate = 0.02
    h = HLLCounter(0.01, K, device="cpu")
    h.error_rate = 0.005
    h.ksize = 31
    assert (h._p, h.ksize) == (16, 31)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        HLLCounter(0.01, K)
    with pytest.raises(RuntimeError, match="CUDA"):
        unique_kmers.main(["-q", "x.fa"])


@pytest.mark.parametrize("flags", [["-R", "report.txt"],
                                   ["-S", "--diagnostics", "-e", "0.005",
                                    "-k", "51", "-R", "report.txt"]],
                         ids=["report", "stream-diagnostics"])
def test_unique_kmers_output_matches(files, tmp_path, capsys, flags):
    outs = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        argv = ["-q"] + flags + files
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(d)
            if side == "jax":
                status, out, err = runscript("unique-kmers.py", argv)
                assert status == 0, err
            else:
                capsys.readouterr()
                unique_kmers.main(argv, device="cpu")
                out, err = capsys.readouterr()
        lines = [ln for ln in err.splitlines() if "unique" in ln]
        outs[side] = (out, lines, open(d / "report.txt").read())
    assert outs["port"] == outs["jax"]
    # two files, the total, and with --diagnostics the table's first line
    assert len(outs["port"][1]) == 3 + ("--diagnostics" in flags)
    assert "expected_memory_usage" in outs["port"][2]
    assert outs["port"][0].count(">") == (2240 if "-S" in flags else 0)


def test_clz_from_shifts():
    """The plain K9's count of leading zeros: 64 for 0 (the h >> p == 0
    case, rho = 64 - p + 1), exact above 2**53 where a float log2 is
    not."""
    rng = np.random.default_rng(1)
    vals = [0, 1, 2, 3, (1 << 53) + 1, (1 << 63) - 1, 1 << 63,
            (1 << 64) - 1] + [1 << i for i in range(64)] + \
        [int(x) >> int(s) for x, s in zip(
            rng.integers(0, 2 ** 64, 50, dtype=np.uint64),
            rng.integers(0, 64, 50))]
    got = _u64.clz(_u64.as_tensor(vals, "cpu")).tolist()
    assert got == [64 - v.bit_length() for v in vals]
