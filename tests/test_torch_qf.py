"""Port parity of the quotient filter (QFCounttable, OnDiskQFCounttable,
BufferedQFCounttable, QFStorage, io/mqf_format, create_MQFGraph and
qf_from_numpy) against khmer_tpu on the CPU: the cases of
tests/test_qf.py and tests/test_qfstorage.py that need no reference
tree, on inputs made from a seed; exact equality everywhere.

normalize-by-median --mqf/--bmqf and trim-low-abund --mqf are held to
the reference's read-by-read loop (upstream normalize-by-median.py and
trim-low-abund.py) over khmer_tpu's QFCounttable, written out here: the
batched scripts of khmer_tpu stop at their QF tables (their batch steps
read a bin table that QFStorage lacks), so they give no bytes to hold
the port to."""

import argparse
import os

import numpy as np
import pytest

import khmer_tpu as kj
from khmer_tpu import khmer_args as jax_args
from khmer_tpu.io.fastx import screed_open, write_record
from khmer_tpu.trimming import trim_record
from khmer_tpu.utils import broken_paired_reader, clean_input_reads

import khmer_tpu_torch as kt
from khmer_tpu_torch import khmer_args
from khmer_tpu_torch.convert import qf_from_numpy
from khmer_tpu_torch.io import oxli_format
from khmer_tpu_torch.ops.hashing import hash_murmur3_scalar
from khmer_tpu_torch.scripts import normalize_by_median, trim_low_abund

from .test_torch_filters import write_pairs
from .torch_cwd import cwd_for_module, cwd_for_test  # noqa: F401


def _random_seqs(n, length, seed=9):
    rng = np.random.default_rng(seed)
    return ["".join("ACGT"[c] for c in rng.integers(0, 4, length))
            for _ in range(n)]


def _state(qf):
    keys, counts = qf.storage.state_arrays()
    return np.asarray(keys), np.asarray(counts)


def _same_state(a, b):
    (ka, ca), (kb, cb) = _state(a), _state(b)
    return np.array_equal(ka, kb) and np.array_equal(ca, cb)


@pytest.fixture(scope="module")
def reads_fa(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("qf") / "reads.fa")
    write_pairs(path, seed=21, n_pairs=300)
    return path


@pytest.mark.parametrize("size,slot", [(1024, None), (1000, 5), (4096, 11)])
def test_qf_counts_match_dict_and_khmer_tpu(size, slot):
    """Counts, n_unique_kmers and hashsizes over khash % range equal a
    dict's and khmer_tpu's (a non-power-of-two size rounds up)."""
    port = kt.QFCounttable(20, size, slot, device="cpu")
    ref = kj.QFCounttable(20, size, slot)
    seqs = _random_seqs(30, 50)
    key_range = int(port.storage.range)
    counts = {}
    for s in seqs:
        assert port.consume(s) == ref.consume(s) == len(s) - 19
        for i in range(len(s) - 19):
            key = hash_murmur3_scalar(s[i:i + 20]) % key_range
            counts[key] = counts.get(key, 0) + 1
    for s in seqs:
        got = port.get_kmer_counts(s)
        assert got == ref.get_kmer_counts(s)
        assert got == [counts[hash_murmur3_scalar(s[i:i + 20]) % key_range]
                       for i in range(len(s) - 19)]
    assert port.n_unique_kmers() == ref.n_unique_kmers() == len(counts)
    assert port.hashsizes() == ref.hashsizes()
    assert port.n_tables() == ref.n_tables() == 1
    assert port.storage.nslots == ref.storage.nslots
    assert _same_state(port, ref)


def test_qf_add_returns_was_new():
    for qf in (kt.QFCounttable(20, 64, device="cpu"), kj.QFCounttable(20, 64)):
        km = "ACGTACGTACGTACGTACGT"
        assert qf.add(km) is True
        assert qf.add(km) is False
        assert qf.get(km) == 2


@pytest.mark.parametrize("count", [65535, 65536, 70000, 2 ** 40 + 7])
def test_qf_u16_narrowing(count):
    """A count past 65535 reads as its low 16 bits in both packages."""
    km = "ATG" * 5 + "CA" + "GGG"
    key = hash_murmur3_scalar(km) % (1024 * 256)
    port = qf_from_numpy(20, 1024, None, [key], [count], device="cpu")
    ref = kj.QFCounttable(20, 1024)
    ref.storage.set_state_arrays(np.array([key], np.uint64),
                                 np.array([count], np.uint64))
    assert port.get(km) == ref.get(km) == count & 0xFFFF
    assert port.get_kmer_counts(km) == ref.get_kmer_counts(km)


@pytest.mark.parametrize("slot", [None, 5, 11])
def test_qf_saved_bytes_equal_and_cross_load(slot, reads_fa, tmp_path):
    port = kt.QFCounttable(20, 1 << 14, slot, device="cpu")
    ref = kj.QFCounttable(20, 1 << 14, slot)
    assert port.consume_seqfile(reads_fa) == ref.consume_seqfile(reads_fa)
    assert _same_state(port, ref)
    mine, theirs = str(tmp_path / "port.qf"), str(tmp_path / "jax.qf")
    port.save(mine)
    ref.save(theirs)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    back = kt.QFCounttable.load(theirs, device="cpu")
    other = kj.QFCounttable.load(mine)
    assert back.ksize() == other.ksize() == 20
    assert _same_state(back, ref) and _same_state(other, port)
    assert back.n_unique_kmers() == ref.n_unique_kmers()


def test_qf_abundance_distribution(reads_fa):
    port = kt.QFCounttable(17, 1 << 14, device="cpu")
    ref = kj.QFCounttable(17, 1 << 14)
    port.consume_seqfile(reads_fa)
    ref.consume_seqfile(reads_fa)
    got = port.abundance_distribution(reads_fa)
    assert got == ref.abundance_distribution(reads_fa) and sum(got) > 0


@pytest.mark.parametrize("mode", ["band", "mask", "mask-consume-masked",
                                  "band-and-mask"])
def test_qf_filtered_consume(mode, reads_fa):
    """consume_seqfile_banding / _with_mask on a QF equal khmer_tpu's: the
    band and the mask (a Counttable, read with its get_batch) drop lanes
    on the host."""
    masks = []
    for cls, kw in ((kt.Counttable, {"device": "cpu"}), (kj.Counttable, {})):
        m = cls(20, 5003, 3, **kw)
        m.consume_seqfile(reads_fa)
        masks.append(m)
    out = []
    for cls, mask, kw in ((kt.QFCounttable, masks[0], {"device": "cpu"}),
                          (kj.QFCounttable, masks[1], {})):
        qf = cls(20, 1 << 13, **kw)
        if mode == "band":
            res = qf.consume_seqfile_banding(reads_fa, 4, 1)
        elif mode == "band-and-mask":
            res = qf.consume_seqfile_banding_with_mask(reads_fa, 3, 2, mask,
                                                       threshold=1)
        else:
            res = qf.consume_seqfile_with_mask(
                reads_fa, mask, threshold=2,
                consume_masked=mode == "mask-consume-masked")
        out.append((res, qf))
    assert out[0][0] == out[1][0] and 0 < out[0][0][1]
    assert _same_state(out[0][1], out[1][1])


def test_qf_bigcount_and_raw_tables_unsupported():
    qf = kt.QFCounttable(20, 64, device="cpu")
    with pytest.raises(ValueError):
        qf.set_use_bigcount(True)
    with pytest.raises(ValueError):
        qf.get_raw_tables()
    assert qf.get_use_bigcount() is False


def test_buffered_qf_counttable():
    for b in (kt.BufferedQFCounttable(20, 1024, device="cpu"),
              kj.BufferedQFCounttable(20, 1024)):
        s = _random_seqs(1, 60)[0]
        b.consume(s)
        b.addToBufferQuery(s)
        b.queryBuffer()
        assert b.get_kmer_counts(s) == [1] * (len(s) - 19)
        assert b.get_median_count(s) == (1, 1.0, 0.0)
        assert b.median_at_least(s, 1)
        b.clearQueryBuffer()
        assert b.get_median_count(s)[0] == 1


def test_qf_raw_dump_with_big_counts(tmp_path):
    """A count far past the fixed counter survives the raw dump, and both
    packages write it alike."""
    km = "ATG" * 5 + "CA"
    files = []
    for name, qf in (("port", kt.QFCounttable(17, 2 ** 9, 11, device="cpu")),
                     ("jax", kj.QFCounttable(17, 2 ** 9, 11))):
        qf.storage.add_batch([qf.hash(km)], [70000])
        qf.count(km)
        path = str(tmp_path / (name + ".qf"))
        qf.save(path)
        files.append(open(path, "rb").read())
    assert files[0] == files[1]
    loaded = kt.QFCounttable.load(str(tmp_path / "jax.qf"), device="cpu")
    assert int(_state(loaded)[1][0]) == 70001
    assert loaded.get(km) == 70001 & 0xFFFF


def test_on_disk_qf_spills_and_counts(tmp_path):
    d = str(tmp_path / "spill")
    table = kt.OnDiskQFCounttable(17, 2 ** 10, 9, directory=d, device="cpu")
    mem = kj.QFCounttable(17, 2 ** 10, 9)
    for s in _random_seqs(200, 17, seed=3):
        for qf in (table, mem):
            qf.count(s)
            qf.count(s)
    assert any(f.startswith("qf_keys") for f in os.listdir(d))
    assert isinstance(table.storage.state_arrays()[0], np.memmap)
    assert _same_state(table, mem)
    path = str(tmp_path / "spilled.qf")
    table.save(path)
    assert _same_state(kj.QFCounttable.load(path), mem)
    with pytest.raises(ValueError):
        kt.OnDiskQFCounttable(17, 1024, device="cpu")


def test_layered_and_legacy_qf_files(tmp_path):
    """A payload after the dump's blocks is refused; khmer_tpu's round-1
    payload still loads."""
    qf = kt.QFCounttable(20, 1 << 12, device="cpu")
    qf.add("A" * 20)
    path = str(tmp_path / "plain.qf")
    qf.save(path)
    kt.QFCounttable.load(path, device="cpu")
    data = open(path, "rb").read()
    layered = str(tmp_path / "layered.qf")
    with open(layered, "wb") as f:
        f.write(data + data[6:])
    with pytest.raises(OSError) as err:
        kt.QFCounttable.load(layered, device="cpu")
    assert "layered" in str(err.value)
    keys = np.array([3, 9, 40], np.uint64)
    counts = np.array([1, 5, 70000], np.uint64)
    legacy = str(tmp_path / "legacy.qf")
    with open(legacy, "wb") as f:
        f.write(b"OXLI" + bytes([4, 8, 21]))
        f.write(np.array([1 << 10, 3], "<u8").tobytes())
        f.write(keys.tobytes() + counts.tobytes())
    for cls, kw in ((kt.QFCounttable, {"device": "cpu"}), (kj.QFCounttable,
                                                           {})):
        t = cls.load(legacy, **kw)
        assert t.ksize() == 21 and t.storage.nslots == 1 << 10
        assert np.array_equal(_state(t)[0], keys)
        assert np.array_equal(_state(t)[1], counts)
    with pytest.raises(OSError):
        kt.Countgraph.load(path, device="cpu")
    with pytest.raises(OSError):
        oxli_format.load_storage(path, device="cpu")


def test_read_write(tmp_path):
    """tests/test_qfstorage.py: a saved QF reads back the same counts."""
    import random

    rng = random.Random(1)
    qf = kt.QFCounttable(20, 1024 * 4, device="cpu")
    kmers = ["".join(rng.choice("ACGT") for _ in range(20))
             for _ in range(400)]
    for kmer in kmers:
        qf.add(kmer)
    fname = str(tmp_path / "zzz")
    qf.save(fname)
    qf2 = kt.QFCounttable.load(fname, device="cpu")
    assert qf.ksize() == qf2.ksize()
    assert [qf.get(k) for k in kmers] == [qf2.get(k) for k in kmers]


def _mqf_args(**kw):
    args = dict(ksize=20, unique_kmers=3000, fp_rate=None, mqf=True,
                bmqf=False)
    args.update(kw)
    return argparse.Namespace(**args)


@pytest.mark.parametrize("kw", [{}, {"fp_rate": 0.01}, {"mqf": False,
                                                       "bmqf": True},
                                {"unique_kmers": 10 ** 6, "ksize": 12}])
def test_create_MQFGraph_sizes(kw, capsys):
    port = khmer_args.create_MQFGraph(_mqf_args(**kw), device="cpu")
    port_err = capsys.readouterr().err
    ref = jax_args.create_MQFGraph(_mqf_args(**kw))
    assert port_err == capsys.readouterr().err
    assert type(port).__name__ == type(ref).__name__
    assert (port.storage.nslots, port.storage.rem_bits, port.hashsizes()) \
        == (ref.storage.nslots, ref.storage.rem_bits, ref.hashsizes())


@pytest.mark.parametrize("kw", [{"ksize": 32}, {"unique_kmers": 0},
                                {"unique_kmers": 10 ** 6, "fp_rate": 0.9},
                                {"mqf": False}])
def test_create_MQFGraph_errors(kw, capsys):
    with pytest.raises(SystemExit) as exc:
        khmer_args.create_MQFGraph(_mqf_args(**kw), device="cpu")
    port_err = capsys.readouterr().err
    with pytest.raises(SystemExit) as ref_exc:
        jax_args.create_MQFGraph(_mqf_args(**kw))
    assert exc.value.code == ref_exc.value.code == 1
    assert port_err == capsys.readouterr().err and "ERROR" in port_err


@pytest.mark.parametrize("graph_type,exp_buckets", [
    ("qfcounttable", "2.4 million buckets"),
    ("countgraph", "3.0 million buckets"),
    ("smallcountgraph", "6.0 million buckets"),
    ("nodegraph", "24.0 million buckets"),
])
def test_check_tablespace_buckets(graph_type, exp_buckets):
    """tests/test_script_arguments.py's bucket table, qfcounttable's
    1 / 1.26 buckets a byte included."""
    args = khmer_args.build_counting_args().parse_args(["-M", "3G"])
    total = khmer_args.calculate_graphsize(args, graph_type) * args.n_tables
    assert "{:.1f} million buckets".format(total / 1e9) == exp_buckets


def test_qf_from_numpy(reads_fa, tmp_path):
    ref = kj.QFCounttable(20, 1 << 14, 6)
    ref.consume_seqfile(reads_fa)
    keys, counts = ref.storage.state_arrays()
    port = qf_from_numpy(20, 1 << 14, 6, keys, counts, device="cpu")
    assert port.n_unique_kmers() == ref.n_unique_kmers()
    seq = _random_seqs(1, 80)[0]
    assert port.get_kmer_counts(seq) == ref.get_kmer_counts(seq)
    port.save(str(tmp_path / "p.qf"))
    ref.save(str(tmp_path / "j.qf"))
    assert (tmp_path / "p.qf").read_bytes() == (tmp_path / "j.qf").read_bytes()
    with pytest.raises(ValueError):
        qf_from_numpy(20, 1 << 14, 6, keys[::-1], counts, device="cpu")


# -- the streaming filters over a QF: the reference's read-by-read loop --


def _bundles(fa, k):
    return broken_paired_reader(clean_input_reads(screed_open(fa)),
                                min_length=k)


def _nbm_oracle(fa, out, qf, C):
    """Upstream normalize-by-median: a bundle is kept when any of its
    reads has a median count below C, and its reads are then consumed."""
    with open(out, "wb") as f:
        for _, _, r0, r1 in _bundles(fa, qf.ksize()):
            reads = [r0] + ([r1] if r1 is not None else [])
            if not all(qf.median_at_least(r.cleaned_seq, C) for r in reads):
                for r in reads:
                    qf.consume(r.cleaned_seq)
                    write_record(r, f)


def _trim_oracle(fa, out, qf, cutoff, trim_at=20):
    """Upstream trim-low-abund (no -V, no --diginorm): pass 1 trims the
    bundles at coverage and consumes and sets aside the others, pass 2
    trims the set-aside reads against the final table."""
    def at_coverage(reads):
        return all(qf.median_at_least(r.cleaned_seq, trim_at)
                   for r in reads)

    saved = []
    with open(out, "wb") as f:
        for _, _, r0, r1 in _bundles(fa, qf.ksize()):
            reads = [r0] + ([r1] if r1 is not None else [])
            if at_coverage(reads):
                for r in reads:
                    rec, _ = trim_record(qf, r, cutoff)
                    if rec:
                        write_record(rec, f)
            else:
                for r in reads:
                    qf.consume(r.cleaned_seq)
                saved.append(reads)
        for reads in saved:
            for r in reads:
                rec, _ = trim_record(qf, r, cutoff)
                if rec:
                    write_record(rec, f)


# -U of the script runs: above the file's distinct k-mers, so that the
# scripts' closing false-positive check passes
QF_UNIQUE = 20000
QF_RUNS = [  # (name, port module, flags, oracle)
    ("nbm-mqf", normalize_by_median, ["--mqf", "-p", "-C", "5"], "nbm"),
    ("nbm-bmqf", normalize_by_median, ["--bmqf", "-p", "-C", "5"], "nbm"),
    ("trim-mqf", trim_low_abund, ["--mqf", "-C", "2"], "trim"),
]


@pytest.mark.parametrize("batch", [16, 16384])
@pytest.mark.parametrize("name,module,flags,oracle", QF_RUNS,
                         ids=[r[0] for r in QF_RUNS])
def test_qf_scripts_equal_reference_loop(name, module, flags, oracle, batch,
                                         reads_fa, tmp_path, capsys,
                                         monkeypatch):
    """The port's script writes the bytes of the reference's read-by-read
    loop over khmer_tpu's QFCounttable (sized by khmer_tpu's
    create_MQFGraph from the same -U), at any batch, and reports its
    n_unique_kmers."""
    monkeypatch.chdir(tmp_path)  # trim-low-abund's pass-2 directory
    out = str(tmp_path / "port.fa")
    table = ["-k", "20", "-U", str(QF_UNIQUE)]
    capsys.readouterr()
    module.main(["-o", out] + table + flags + [reads_fa], device="cpu",
                batch=batch)
    err = capsys.readouterr().err
    qf = jax_args.create_MQFGraph(_mqf_args(unique_kmers=QF_UNIQUE,
                                            mqf="--mqf" in flags,
                                            bmqf="--bmqf" in flags))
    want = str(tmp_path / "oracle.fa")
    if oracle == "nbm":
        _nbm_oracle(reads_fa, want, qf, 5)
        assert "Total number of unique k-mers: {}".format(
            qf.n_unique_kmers()) in err
    else:
        _trim_oracle(reads_fa, want, qf, 2)
    got = open(out, "rb").read()
    assert got == open(want, "rb").read()
    n = got.count(b">")
    assert 0 < n <= 600 and (oracle == "trim" or n < 600)


def test_qf_batch_count_wrap_is_exact():
    """A key whose narrowed count wraps within a batch: the batch step
    splits, and the decisions equal the read-by-read loop's."""
    rng = np.random.default_rng(4)
    rand = ["".join("ACGT"[c] for c in rng.integers(0, 4, n))
            for n in (60, 10)]
    x, y = rand[0] + "A" * 40, rand[1] + "A" * 90
    key = hash_murmur3_scalar("A" * 20) % (1024 * 256)
    port = qf_from_numpy(20, 1024, None, [key], [65530], device="cpu")
    ref = kj.QFCounttable(20, 1024)
    ref.storage.set_state_arrays(np.array([key], np.uint64),
                                 np.array([65530], np.uint64))
    keep = port.diginorm_batch([(x, None), (y, None)], 20).numpy()
    want = []
    for s in (x, y):
        want.append(not ref.median_at_least(s, 20))
        if want[-1]:
            ref.consume(s)
    assert want == [True, True] and keep.tolist() == [1, 1]
    assert _same_state(port, ref)
