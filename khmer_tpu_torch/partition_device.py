"""Connected components of the tag graph on the device (kernel K10).

Port of khmer_tpu/partition_device.py:42-77 and its host baseline
(:140-170).  The reference partitions tags by chasing PartitionID
pointers on the host (subset.cc:623-910); this engine labels the
components of a star edge list (each seed tag to every tag its search
reaches) by min-label propagation with pointer jumping, in blocks of
rounds of kernel K10 (kernels.cc_rounds), until a block changes nothing.
The components are the reference's partitions as SETS of tags.

The sharded round (khmer_tpu's make_sharded_cc_round and
connected_components_sharded) comes with the multi-GPU slice of the
port.
"""

import numpy as np
import torch

from khmer_tpu_torch import kernels
from khmer_tpu_torch._config import resolve_device


def connected_components(n_nodes, src, dst, device=None, stats=None):
    """int32 labels [n_nodes] on the device, each node's label the
    smallest node index of its component, for edge arrays src and dst
    (uint32 numpy, or int32 tensors): cc_rounds in blocks of
    kernels.CC_BLOCK rounds, with one read of the changed flag per block,
    until a block changes nothing.  `stats`, a dict, gets the number of cc_rounds calls
    ("calls")."""
    dev = resolve_device(device)
    labels = torch.arange(n_nodes, dtype=torch.int32, device=dev)
    src = _edges(src, dev)
    dst = _edges(dst, dev)
    calls = 0
    while True:
        labels, changed = kernels.cc_rounds(labels, src, dst,
                                            kernels.CC_BLOCK)
        calls += 1
        if not bool(changed):
            break
    if stats is not None:
        stats["calls"] = calls
    return labels


def _edges(arr, dev):
    """An edge array (uint32 numpy, or an int32 tensor) as int32 on dev."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=dev, dtype=torch.int32).contiguous()
    arr = np.ascontiguousarray(np.asarray(arr, np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(dev)


def host_union_find(n_nodes, src, dst):
    """Host baseline: weighted union-find over the same edges; each
    node's label is the smallest node index of its component (uint32)."""
    parent = list(range(n_nodes))
    rank = [0] * n_nodes

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for a, b in zip(src, dst):
        ra, rb = find(int(a)), find(int(b))
        if ra == rb:
            continue
        if rank[ra] < rank[rb]:
            ra, rb = rb, ra
        parent[rb] = ra
        if rank[ra] == rank[rb]:
            rank[ra] += 1
    roots = {}
    out = np.empty(n_nodes, np.uint32)
    for i in range(n_nodes):
        r = find(i)
        if r not in roots:
            roots[r] = i  # first (smallest) index reaching this root
        out[i] = roots[r]
    return out
