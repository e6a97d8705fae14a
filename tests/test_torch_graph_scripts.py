"""Port parity of the five partitioning scripts: load-graph,
partition-graph, merge-partitions, annotate-partitions and
extract-partitions through khmer_tpu_torch.scripts (device="cpu")
against scripts/*.py through runscript, chained on the same generated
metagenome reads; every output file byte-equal (exact equality).

Three chains: the default (-s small enough for three subsets), one with
--no-big-traverse (with the port's read and seed batches cut small:
they change no output), and one with a stoptags file (--stoptags)
written by khmer_tpu; the table geometry is 4 x 20011 bins at k = 20."""

import contextlib
import os
from unittest import mock

import pytest
import torch

import khmer_tpu
from khmer_tpu_torch import graph, partitioning
from khmer_tpu_torch.scripts import (annotate_partitions, extract_partitions,
                                     load_graph, merge_partitions,
                                     partition_graph)
from .khmer_tst_utils import runscript
from .test_torch_partition import write_metagenome
from .torch_cwd import cwd_for_module, cwd_for_test  # noqa: F401

TABLE = ["-k", "20", "-N", "4", "-x", "20011"]
CHAINS = {"default": [], "no-big-traverse": ["--no-big-traverse"],
          "stoptags": ["--stoptags"]}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _run(side, script, module, argv, cwd, small_batches):
    if side == "jax":
        runscript(script, argv, in_directory=cwd)
        return
    here = os.getcwd()
    os.chdir(cwd)
    try:
        # the port's batches, which change nothing, cut small
        with mock.patch.object(graph, "TAG_BATCH", 50), \
                mock.patch.multiple(partitioning, SEED_BATCH=16,
                                    ANNOTATE_BATCH=32) \
                if small_batches else contextlib.nullcontext():
            module.main(argv, device="cpu")
    finally:
        os.chdir(here)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_graph_scripts")
    fa = str(d / "reads.fa")
    seqs = write_metagenome(fa, seed=11, n_genomes=10, n_reads=260)
    # stop tags at k-mer 30 of every fifth read, written by khmer_tpu
    ng = khmer_tpu.Nodegraph(20, 1, 1)
    ng.stop_tags = {ng.get_kmer_hashes(s)[30] for s in seqs[::5]
                    if len(s) >= 60}
    ng.save_stop_tags(str(d / "stop.stoptags"))
    out = {}
    for name, flags in CHAINS.items():
        if name == "stoptags":
            flags = flags + [str(d / "stop.stoptags")]
        for side in ("jax", "port"):
            sd = d / name / side
            sd.mkdir(parents=True)
            g = "g"
            steps = [
                ("load-graph.py", load_graph, TABLE + [g, fa]),
                ("partition-graph.py", partition_graph,
                 flags + ["-s", "100", g]),
                ("merge-partitions.py", merge_partitions,
                 ["-k", "20", "--keep-subsets", g]),
                ("annotate-partitions.py", annotate_partitions,
                 ["-k", "20", g, fa]),
                ("extract-partitions.py", extract_partitions,
                 ["-m", "2", "-X", "60", "g", "reads.fa.part"])]
            for script, module, argv in steps:
                _run(side, script, module, argv, str(sd),
                     name == "no-big-traverse")
            out[name, side] = {f: _read(str(sd / f))
                               for f in sorted(os.listdir(sd))}
    out["dir"] = d
    return out


@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_output_bytes_match(chains, name):
    want, got = chains[name, "jax"], chains[name, "port"]
    assert sorted(got) == sorted(want)
    for f in want:
        assert got[f] == want[f], f
    subsets = [f for f in got if f.startswith("g.subset.")]
    groups = [f for f in got if ".group" in f]
    assert len(subsets) == 3 and len(groups) >= 2
    assert len(got["g.pmap.merged"]) > 18


def test_chain_flags_change_the_partitions(chains):
    default = chains["default", "port"]["g.pmap.merged"]
    assert chains["stoptags", "port"]["g.pmap.merged"] != default


@pytest.mark.parametrize("script", ["load_graph", "partition_graph",
                                    "merge_partitions", "annotate_partitions",
                                    "extract_partitions"])
def test_scripts_default_to_the_card(chains, tmp_path, script):
    """Without device=, every entry point asks for CUDA and raises here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    d = chains["dir"] / "default" / "port"
    argv = {"load_graph": TABLE + [str(tmp_path / "g"),
                                   str(chains["dir"] / "reads.fa")],
            "partition_graph": [str(d / "g")],
            "merge_partitions": ["-k", "20", "--keep-subsets", str(d / "g")],
            "annotate_partitions": ["-k", "20", str(d / "g"),
                                    str(chains["dir"] / "reads.fa")],
            "extract_partitions": [str(tmp_path / "x"),
                                   str(d / "reads.fa.part")]}[script]
    module = {"load_graph": load_graph, "partition_graph": partition_graph,
              "merge_partitions": merge_partitions,
              "annotate_partitions": annotate_partitions,
              "extract_partitions": extract_partitions}[script]
    here = os.getcwd()
    os.chdir(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            module.main(argv)
    finally:
        os.chdir(here)
