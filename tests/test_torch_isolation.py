"""The port stands alone: no module of khmer_tpu_torch and no line of
chip_smoke.py imports jax or khmer_tpu, and with no CUDA device the
default device raises instead of running on the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from .khmer_tst_utils import REPO_ROOT, subprocess_env

PORT_DIR = os.path.join(REPO_ROOT, "khmer_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for root, _, files in os.walk(PORT_DIR):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _port_modules():
    mods = []
    for path in _port_sources()[1:]:
        rel = os.path.relpath(path, REPO_ROOT)[: -len(".py")]
        parts = rel.split(os.sep)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _forbidden(name):
    return name is not None and (name.split(".")[0] in ("jax", "jaxlib")
                                 or name == "khmer_tpu"
                                 or name.startswith("khmer_tpu."))


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO_ROOT))
def test_no_jax_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, "{} imports {}".format(path, bad)


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, sys\n"
            "for m in {!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'khmer_tpu'))\n"
            "print(len(sys.modules), bad)\n"
            "assert not bad, bad\n").format(_port_modules())
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          env=subprocess_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(_port_modules()) >= 44


# the modules of the tag-based partitioning slice, which the scans above
# must reach
PARTITION_MODULES = (
    "khmer_tpu_torch.graph", "khmer_tpu_torch.traversal",
    "khmer_tpu_torch.partitioning", "khmer_tpu_torch.partition_device",
    "khmer_tpu_torch.scripts.load_graph",
    "khmer_tpu_torch.scripts.partition_graph",
    "khmer_tpu_torch.scripts.merge_partitions",
    "khmer_tpu_torch.scripts.annotate_partitions",
    "khmer_tpu_torch.scripts.extract_partitions")


@pytest.mark.parametrize("module", PARTITION_MODULES)
def test_partition_modules_are_scanned(module):
    assert module in _port_modules()


def test_default_device_refuses_to_run_on_cpu():
    from khmer_tpu_torch import Countgraph, Nodegraph

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        Countgraph(20, 1000, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        Nodegraph(20, 1000, 4)
    assert Countgraph(20, 1000, 4, device="cpu").storage.table.is_cpu
