"""Connected components of the tag graph on the device (kernel K10).

Port of khmer_tpu/partition_device.py:42-77 and its host baseline
(:140-170).  The reference partitions tags by chasing PartitionID
pointers on the host (subset.cc:623-910); this engine labels the
components of a star edge list (each seed tag to every tag its search
reaches) by min-label propagation with pointer jumping, in blocks of
rounds of kernel K10 (kernels.cc_rounds), until a block changes nothing.
The components are the reference's partitions as SETS of tags.

The sharded engine (khmer_tpu's make_sharded_cc_round and
connected_components_sharded, :80-137) spreads the edge list over the
shards of a Mesh (parallel/comm.py): every round each shard relaxes its
own edges (K10's relax entry point), the labels go through an all-reduce
min, and the two pointer jumps follow (K10's jump entry point), so edges
never move and only the label vector crosses the mesh.
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


def make_sharded_cc_round(mesh, rounds=4):
    """step(labels, src_sh, dst_sh) -> (labels, changed): `rounds` CC
    rounds over a mesh, labels replicated (one int32 [T] tensor per local
    shard) and the edges sharded (src_sh, dst_sh: each local shard's
    int32 edges).  A round relaxes each shard's edges, takes the min over
    the mesh and jumps twice; changed says whether a round changed a
    label anywhere."""
    def step(labels, src_sh, dst_sh):
        flags = [torch.zeros(1, dtype=torch.int32, device=d)
                 for d in mesh.devices]
        for _ in range(rounds):
            relaxed = [kernels.cc_relax(lab, s, d)
                       for lab, s, d in zip(labels, src_sh, dst_sh)]
            relaxed = mesh.all_reduce(relaxed, "umin32")
            # shards of one device hold one replica of the labels
            jumped = {}
            out = []
            for m, lab, flag in zip(relaxed, labels, flags):
                key = (id(m), id(lab))
                if key not in jumped:
                    jumped[key] = kernels.cc_jump(m, lab, flag)
                out.append(jumped[key])
            labels = out
        return labels, mesh.total(flags, "max") != 0

    return step


def connected_components_sharded(mesh, n_nodes, src, dst, block=4,
                                 stats=None):
    """connected_components over a mesh: the edge list (uint32 numpy or
    integer tensors) padded with (0, 0) edges to a multiple of the mesh's
    size, rank r holding the r-th equal slice, then blocks of `block`
    rounds until one changes nothing.  Returns the int32 labels [n_nodes]
    on the mesh's first device; `stats` gets the number of blocks
    ("calls")."""
    NS = mesh.size
    src, dst = _host_edges(src), _host_edges(dst)
    E = src.size
    per = -(-max(E, 1) // NS)
    pad = per * NS - E
    src = np.concatenate([src, np.zeros(pad, np.uint32)]).view(np.int32)
    dst = np.concatenate([dst, np.zeros(pad, np.uint32)]).view(np.int32)
    src_sh = [torch.from_numpy(src[r * per:(r + 1) * per]).to(d)
              for r, d in zip(mesh.ranks, mesh.devices)]
    dst_sh = [torch.from_numpy(dst[r * per:(r + 1) * per]).to(d)
              for r, d in zip(mesh.ranks, mesh.devices)]
    labels = mesh.replicate(torch.arange(n_nodes, dtype=torch.int32))
    step = make_sharded_cc_round(mesh, rounds=block)
    calls = 0
    while True:
        labels, changed = step(labels, src_sh, dst_sh)
        calls += 1
        if not changed:
            break
    if stats is not None:
        stats["calls"] = calls
    return labels[0]


def _host_edges(arr):
    """An edge array (uint32 numpy, or an integer tensor) as uint32
    numpy."""
    if isinstance(arr, torch.Tensor):
        return arr.to(torch.int64).cpu().numpy().astype(np.uint32)
    return np.ascontiguousarray(np.asarray(arr, np.uint32))


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
