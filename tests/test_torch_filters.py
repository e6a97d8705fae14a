"""Port parity of the slice-2 scripts: normalize-by-median (-p, with
--savegraph, and on a loaded bigcount .ct, which takes its host
replay), trim-low-abund (plain, -V -Z, --diginorm), filter-abund,
filter-abund-single and count-median of khmer_tpu_torch write the same
bytes as scripts/*.py on one generated file of interleaved read pairs
(/1 /2 names; 1% substitutions in a third of the reads, so that reads
are dropped and trimmed).  Both sides cut batches of BATCH bundles:
khmer_tpu through KHMER_TPU_DN_BATCH / KHMER_TPU_TRIM_BATCH, the port
through `batch=`.  Exact equality of every output file."""

import os

import numpy as np
import pytest

from khmer_tpu_torch.scripts import (count_median, filter_abund,
                                     filter_abund_single, load_into_counting,
                                     normalize_by_median, trim_low_abund)

from .khmer_tst_utils import runscript
from .test_torch_rows import _with_errors
from .torch_cwd import cwd_for_module, cwd_for_test  # noqa: F401

BATCH = 64
TABLE = ["-k", "20", "-N", "4", "-x", "20011"]


def write_pairs(path, seed=12, n_pairs=300, genome_len=4000, readlen=100):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), genome_len))
    starts = rng.integers(0, genome_len - readlen, 2 * n_pairs)
    reads = [genome[s:s + readlen] for s in starts]
    noisy = _with_errors(reads, 0.01, seed)
    reads = [noisy[i] if i % 3 == 0 else r for i, r in enumerate(reads)]
    with open(path, "w") as f:
        for i in range(n_pairs):
            f.write(">p%d/1\n%s\n>p%d/2\n%s\n" % (i, reads[2 * i], i,
                                                  reads[2 * i + 1]))


RUNS = [  # (name, khmer_tpu script, port module, argv, outputs)
    ("nbm", "normalize-by-median.py", normalize_by_median,
     TABLE + ["-p", "-C", "5", "--savegraph", "nbm.ct", "reads.fa"],
     ["reads.fa.keep", "nbm.ct"]),
    ("trim", "trim-low-abund.py", trim_low_abund,
     TABLE + ["-C", "2", "-o", "trim.fa", "reads.fa"], ["trim.fa"]),
    ("trim-V", "trim-low-abund.py", trim_low_abund,
     TABLE + ["-C", "3", "-V", "-Z", "8", "-o", "trimv.fa", "reads.fa"],
     ["trimv.fa"]),
    ("trim-dn", "trim-low-abund.py", trim_low_abund,
     TABLE + ["-C", "2", "--diginorm", "--diginorm-coverage", "6",
              "-o", "trimdn.fa", "--savegraph", "trimdn.ct", "reads.fa"],
     ["trimdn.fa", "trimdn.ct"]),
    ("filter", "filter-abund.py", filter_abund,
     ["-C", "2", "-o", "filter.fa", "nbm.ct", "reads.fa"], ["filter.fa"]),
    ("filter-single", "filter-abund-single.py", filter_abund_single,
     TABLE + ["-C", "3", "-o", "single.fa", "reads.fa"], ["single.fa"]),
    ("median", "count-median.py", count_median,
     ["nbm.ct", "reads.fa", "median.csv"], ["median.csv"]),
    # a loaded .ct that counts past 255: normalize-by-median's host replay
    ("lic", "load-into-counting.py", load_into_counting,
     TABLE + ["lic.ct", "reads.fa"], ["lic.ct"]),
    ("nbm-host", "normalize-by-median.py", normalize_by_median,
     ["-p", "-C", "5", "-l", "lic.ct", "-o", "host.fa", "reads.fa"],
     ["host.fa"]),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for side in ("jax", "port"):
        d = tmp_path_factory.mktemp("torch_filters_" + side)
        write_pairs(str(d / "reads.fa"))
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(d)
            mp.setenv("KHMER_TPU_DN_BATCH", str(BATCH))
            mp.setenv("KHMER_TPU_TRIM_BATCH", str(BATCH))
            for _, script, module, argv, _ in RUNS:
                if side == "jax":
                    runscript(script, ["-q"] * (script != "count-median.py")
                              + argv)
                else:
                    kw = dict(batch=BATCH) if module in (
                        normalize_by_median, trim_low_abund) else {}
                    module.main(["-q"] * (module is not count_median) + argv,
                                device="cpu", **kw)
        out[side] = {name: open(os.path.join(d, name), "rb").read()
                     for run in RUNS for name in run[4]}
    return out


@pytest.mark.parametrize("name", [n for run in RUNS for n in run[4]])
def test_script_output_bytes_match(runs, name):
    assert runs["port"][name] == runs["jax"][name]
    assert len(runs["port"][name]) > 0


def test_filters_drop_and_trim(runs):
    """The input exercises the decisions: normalize-by-median drops
    reads, and trim-low-abund trims some and keeps others whole."""
    src = runs["port"]["filter.fa"]
    kept = runs["port"]["reads.fa.keep"].count(b">")
    assert 0 < kept < 600
    trimmed = runs["port"]["trim.fa"]
    assert 0 < trimmed.count(b">") <= 600 and len(trimmed) < 600 * 107
    assert src.count(b">") > 0


@pytest.mark.parametrize("flag", [["--bmqf"], ["--small-count"],
                                  ["--mqf"]])
def test_unported_tables_exit(tmp_path, capsys, flag):
    """Tables that later slices ported run instead of exiting with an
    error that names the slice (-H murmur, once the first case, is ported
    and held to khmer_tpu in tests/test_torch_counttable.py).
    --small-count is ported since slice 3b (held to khmer_tpu in
    tests/test_torch_smallcount.py) and --mqf/--bmqf since slice 5 (held
    to the reference's loop in tests/test_torch_qf.py; they size the
    filter from -U, and k <= 31): each runs and keeps every read here."""
    fa = str(tmp_path / "reads.fa")
    write_pairs(fa, n_pairs=4)
    sizing = [] if flag == ["--small-count"] else ["-k", "20", "-U", "1000"]
    normalize_by_median.main(["-q", "-o", str(tmp_path / "o.fa")] + sizing +
                             flag + [fa], device="cpu")
    assert "not ported" not in capsys.readouterr().err
    assert open(tmp_path / "o.fa").read().count(">") == 8
