"""Port parity where the port used to part from khmer_tpu: empty inputs,
mask thresholds outside uint32 and load_storage's signature.

* A 0-byte file and an empty gzip stream: consume_seqfile_banding,
  consume_seqfile_with_mask, consume_seqfile_banding_with_mask and
  HLLCounter.consume_seqfile raise khmer_tpu's OSError ("<f> does not
  contain any sequences!"); the calls that already agreed (the plain
  consume_seqfile of every hash, consume_fasta, consume_seqfile_and_tag)
  still do what khmer_tpu does; unique-kmers on an empty file
  fails with that OSError after the same stderr lines.
* A mask threshold of -1 or 2**32 raises khmer_tpu's OverflowError before
  the file is read (also on an empty file); 1.5, True, 2**31, 65535 and
  65536 count what khmer_tpu counts.
* io.oxli_format.load_storage(path) with khmer_tpu's one argument loads a
  .ct and a gzipped .ct as khmer_tpu's does.
* The bulk consumes of a whole table (consume_seqfile, and
  consume_seqfile_banding through the filters) take khmer_tpu's bigcount
  candidates, its deferred counter's: on reads where one read repeats
  past 255 and a k-mer seen once shares all its bins with that read's,
  the saved .ct (bigcount section included) and n_unique equal
  khmer_tpu's; consume_seqfile_and_tag, which both packages run by
  sketch_update's rule, still gives khmer_tpu's bytes.

Each case is held against khmer_tpu on the same generated file."""

import contextlib
import gzip
import io
import sys
from unittest import mock

import numpy as np
import pytest

import khmer_tpu
import khmer_tpu.io.oxli_format as jax_oxli
import khmer_tpu_torch
from khmer_tpu_torch.io import oxli_format
from khmer_tpu_torch.scripts import unique_kmers
from .khmer_tst_utils import runscript
from .torch_cwd import cwd_for_module, cwd_for_test  # noqa: F401

K = 15


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_faults")
    (d / "e.fa").write_bytes(b"")
    with gzip.open(str(d / "e.fa.gz"), "wb"):
        pass
    rng = np.random.default_rng(4)
    genome = "".join(rng.choice(list("ACGT"), 600))
    with open(str(d / "r.fa"), "w") as f:
        for i in range(40):
            s = int(rng.integers(0, 500))
            f.write(">r%d\n%s\n" % (i, genome[s:s + 100]))
    return d


def _both(fn):
    """fn(khmer_tpu, {}) and fn(khmer_tpu_torch, {"device": "cpu"}): each
    result, or the type and text of what it raised."""
    out = []
    for mod, kw in ((khmer_tpu, {}), (khmer_tpu_torch, {"device": "cpu"})):
        try:
            out.append(fn(mod, kw))
        except Exception as err:  # compared below, never swallowed
            out.append((type(err), str(err)))
    return out


FILTERED = {
    "banding": lambda t, m, f: t.consume_seqfile_banding(f, 2, 1),
    "with_mask": lambda t, m, f: t.consume_seqfile_with_mask(f, m),
    "banding_with_mask":
        lambda t, m, f: t.consume_seqfile_banding_with_mask(f, 2, 1, m),
}


@pytest.mark.parametrize("name", ["e.fa", "e.fa.gz"])
@pytest.mark.parametrize("call", list(FILTERED) + ["hll"])
def test_empty_input_raises(files, call, name):
    path = str(files / name)

    def run(mod, kw):
        if call == "hll":
            return mod.HLLCounter(0.01, K, **kw).consume_seqfile(path)
        t = mod.Countgraph(K, 101, 2, **kw)
        return FILTERED[call](t, mod.Nodegraph(K, 101, 2, **kw), path)

    want, got = _both(run)
    assert got == want == (OSError, path + " does not contain any sequences!")


@pytest.mark.parametrize("name", ["e.fa", "e.fa.gz"])
def test_calls_that_agreed_still_agree(files, name):
    path = str(files / name)

    calls = [lambda mod, kw, c=cls: getattr(mod, c)(K, 101, 2, **kw)
             .consume_seqfile(path)
             for cls in ("Countgraph", "Counttable", "CyclicCounttable")]
    calls.append(lambda mod, kw: mod.Countgraph(K, 101, 2, **kw)
                 .consume_fasta(path))
    calls.append(lambda mod, kw: mod.Nodegraph(K, 101, 2, **kw)
                 .consume_seqfile_and_tag(path))
    want, got = zip(*[_both(c) for c in calls])
    assert got == want
    # the bulk consumes count nothing; consume-and-tag reads through the
    # parser, which refuses the file in both
    assert want[:4] == ((0, 0),) * 4 and want[4][0] is OSError


def test_unique_kmers_on_an_empty_file(files, tmp_path):
    path = str(files / "e.fa")
    status, _, want_err = runscript("unique-kmers.py", ["-k", "20", path],
                                    in_directory=str(tmp_path), fail_ok=True)
    assert status != 0
    assert want_err.rstrip().splitlines()[-1] == \
        "OSError: " + path + " does not contain any sequences!"
    buf = io.StringIO()
    with pytest.raises(OSError) as err, contextlib.redirect_stderr(buf), \
            mock.patch.object(sys, "argv", ["unique-kmers.py"]):
        unique_kmers.main(["-k", "20", path], device="cpu")
    assert str(err.value) == path + " does not contain any sequences!"
    # the lines before khmer_tpu's traceback, past the banner's runtime
    before = want_err[:want_err.index("Traceback")].splitlines()
    assert [ln for ln in buf.getvalue().splitlines() if "runtime" not in ln] \
        == [ln for ln in before if "runtime" not in ln]


@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("threshold", [-1, 2 ** 32])
@pytest.mark.parametrize("call", ["with_mask", "banding_with_mask"])
def test_threshold_out_of_range(files, call, threshold, empty):
    path = str(files / ("e.fa" if empty else "r.fa"))

    def run(mod, kw):
        t = mod.Countgraph(K, 101, 2, **kw)
        m = mod.Nodegraph(K, 101, 2, **kw)
        if call == "with_mask":
            return t.consume_seqfile_with_mask(path, m, threshold=threshold)
        return t.consume_seqfile_banding_with_mask(path, 2, 1, m,
                                                   threshold=threshold)

    want, got = _both(run)
    assert got == want == (OverflowError, "Python integer {} out of bounds "
                           "for uint32".format(threshold))


@pytest.mark.parametrize("threshold", [1.5, True, 2 ** 31, 65535, 65536])
def test_thresholds_in_range_count_as_before(files, threshold):
    path = str(files / "r.fa")

    def run(mod, kw):
        m = mod.Countgraph(K, 1009, 2, **kw)
        m.consume_seqfile(path)
        t = mod.Countgraph(K, 1009, 2, **kw)
        res = [t.consume_seqfile_with_mask(path, m, threshold=threshold),
               t.consume_seqfile_with_mask(path, m, threshold=threshold,
                                           consume_masked=True)]
        return res, bytes(np.asarray(t.storage.raw_bytes()))

    want, got = _both(run)
    assert got == want
    assert want[0][1][1] == 0 or threshold in (1.5, True)


@pytest.mark.parametrize("gz", [False, True])
def test_load_storage_takes_one_argument(files, tmp_path, gz):
    path = str(tmp_path / ("t.ct.gz" if gz else "t.ct"))
    t = khmer_tpu.Countgraph(K, 1009, 2)
    t.consume_seqfile(str(files / "r.fa"))
    t.save(path)
    want, wk = jax_oxli.load_storage(path)
    got, gk = oxli_format.load_storage(path, device="cpu")
    assert gk == wk and got.kind == want.kind == "byte"
    assert bytes(got.raw_bytes()) == bytes(np.asarray(want.raw_bytes()))
    got, _ = oxli_format.load_storage(path, ("byte",), device="cpu")
    with pytest.raises(oxli_format.OxliFileError):
        oxli_format.load_storage(path, ("bit",), device="cpu")
    assert bytes(khmer_tpu_torch.Countgraph.load(path, device="cpu")
                 .storage.raw_bytes()) == bytes(got.raw_bytes())


@pytest.fixture(scope="module")
def repeated_read(tmp_path_factory):
    """60 random 120-base reads, then the first of them 300 times more."""
    path = str(tmp_path_factory.mktemp("torch_faults_bc") / "rep.fa")
    rng = np.random.default_rng(1)
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, 120))
            for _ in range(60)]
    seqs += [seqs[0]] * 300
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(">r%d\n%s\n" % (i, s))
    return path


BULK = {
    "consume_seqfile": lambda t, f: t.consume_seqfile(f),
    "banding": lambda t, f: t.consume_seqfile_banding(f, 1, 0),
    "and_tag": lambda t, f: t.consume_seqfile_and_tag(f),
}


@pytest.mark.parametrize("call", list(BULK))
def test_bulk_consume_bigcount_section(repeated_read, tmp_path, call):
    """Countgraph(20, 4999, 3) with bigcount: the .ct bytes and n_unique
    of each consume equal khmer_tpu's (16,015 bytes, 101 bigcount
    entries, for the bulk consumes; 16,025 for the tagging one)."""
    def run(mod, kw):
        t = mod.Countgraph(20, 4999, 3, **kw)
        t.set_use_bigcount(True)
        ret = BULK[call](t, repeated_read)
        path = str(tmp_path / "{}.ct".format(mod.__name__))
        t.save(path)
        with open(path, "rb") as f:
            return ret, t.n_unique_kmers(), f.read()

    want, got = _both(run)
    assert got == want
    assert want[1] == 5333
    assert len(want[2]) == (16025 if call == "and_tag" else 16015)
