"""Port parity: the three ported scripts write the same bytes as
scripts/load-into-counting.py, abundance-dist-single.py and
abundance-dist.py on the same generated input (exact equality)."""

import os

import pytest

from khmer_tpu_torch.scripts import (abundance_dist, abundance_dist_single,
                                     load_into_counting)
from .khmer_tst_utils import runscript
from .test_torch_countgraph import write_reads
from .torch_cwd import cwd_for_module, cwd_for_test  # noqa: F401

TABLE_ARGS = ["-k", "20", "-N", "4", "-x", "1e6"]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_scripts")
    fa = str(d / "reads.fa")
    write_reads(fa, seed=6, n_reads=1500, repeats=280)
    out = {}
    for side in ("jax", "port"):
        sd = d / side
        sd.mkdir()
        ct = str(sd / "out.ct")
        single = str(sd / "single.hist")
        multi = str(sd / "multi.hist")
        saved = str(sd / "single.ct")
        lic = TABLE_ARGS + ["-s", "tsv", ct, fa]
        ads = TABLE_ARGS + ["--savegraph", saved, fa, single]
        ad = ["-z", ct, fa, multi]
        if side == "jax":
            runscript("load-into-counting.py", lic)
            runscript("abundance-dist-single.py", ads)
            runscript("abundance-dist.py", ad)
        else:
            load_into_counting.main(lic, device="cpu")
            abundance_dist_single.main(ads, device="cpu")
            abundance_dist.main(ad, device="cpu")
        out[side] = {name: _read(str(sd / name)) for name in os.listdir(sd)}
    return out


@pytest.mark.parametrize("name", ["out.ct", "out.ct.info",
                                  "out.ct.info.tsv", "single.hist",
                                  "single.ct", "multi.hist"])
def test_script_output_bytes_match(runs, name):
    assert runs["port"][name] == runs["jax"][name]
    assert len(runs["port"][name]) > 0


def test_histograms_reach_bigcounts(runs):
    rows = runs["port"]["multi.hist"].decode().splitlines()
    assert rows[0] == "abundance,count,cumulative,cumulative_fraction"
    assert int(rows[-1].split(",")[0]) > 255
