"""A mesh of shards and the collectives of the sharded consume.

khmer_tpu lays its devices out as a jax.sharding.Mesh with axes
("data", "shard") and runs shard_map programs whose collectives
(all_to_all, psum, pmin, all_gather) ride the interconnect.  PyTorch has
no shard_map, so the port's Mesh holds the same [data, shard] grid as a
list of shards, each on a torch device, and offers those collectives on
lists of per-shard tensors.  A shard's rank is its flat place in the
grid, data-major (rank = d * shard + s), as in khmer_tpu's banding.

Two forms:

  * in-process shards (group=None): this process holds every shard.  The
    devices may repeat (cuda:0 four times on one card, cpu in the tests,
    cuda:0..n-1 where there are several cards), and a collective is a
    copy between the shards' tensors;
  * a torch.distributed process group: every process holds its own
    shards, consecutive ranks (process p holds ranks p * L .. p * L + L
    - 1 of its L local shards), and a collective reduces over the local
    shards, then over the processes.  The backend is the group's: NCCL
    where each process has its own card, gloo on the CPU.  With gloo,
    CUDA tensors travel through a host copy, and come back to the device
    they were on.

Every collective takes one tensor per local shard (on that shard's
device) and returns one per local shard, in the order of Mesh.devices.
Results may share storage between shards on the same device: treat
them as read-only.
"""

import torch

_FLIP32 = -(1 << 31)  # x ^ _FLIP32 orders int32 patterns as uint32
_OPS = ("sum", "min", "umin32")


class Mesh:
    """A [data, shard] grid of shards, of which this process holds the
    ones on `devices`, in rank order.

    devices: the local shards' torch devices (repeats allowed);
    data, shard: the grid, data * shard == the mesh's size (the local
    shards times the group's processes);
    group: None for in-process shards, or a torch.distributed process
    group (torch.distributed.group.WORLD for the default one)."""

    def __init__(self, devices, data, shard, group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.group = group
        if group is None:
            self.n_procs, self.proc = 1, 0
            self.backend = None
        else:
            import torch.distributed as dist

            self.n_procs = dist.get_world_size(group)
            self.proc = dist.get_rank(group)
            self.backend = str(dist.get_backend(group))
        self.n_local = len(self.devices)
        self.size = self.n_local * self.n_procs
        if data * shard != self.size:
            raise ValueError("mesh {}x{} does not cover {} shards".format(
                data, shard, self.size))
        self.shape = {"data": int(data), "shard": int(shard)}
        self.ranks = tuple(range(self.proc * self.n_local,
                                 (self.proc + 1) * self.n_local))

    # -- moving tensors for the process group ------------------------------

    def _wire(self, t):
        """t as the backend takes it: on the host for gloo."""
        if self.backend == "gloo" and t.is_cuda:
            return t.cpu()
        return t

    def replicate(self, t):
        """One tensor per local shard, t on each shard's device (shared by
        shards of one device)."""
        by_dev = {}
        for d in self.devices:
            if d not in by_dev:
                by_dev[d] = t.to(d)
        return [by_dev[d] for d in self.devices]

    # -- collectives --------------------------------------------------------

    def all_to_all(self, sends):
        """sends[i]: [size, ...] on local shard i, row j for rank j.
        Returns recvs, recvs[i][j] = rank j's row for local shard i."""
        if len(sends) != self.n_local:
            raise ValueError("all_to_all: one tensor per local shard")
        if self.group is None:
            return [torch.stack([sends[j][i].to(d)
                                 for j in range(self.size)])
                    for i, d in enumerate(self.devices)]
        import torch.distributed as dist

        L, P = self.n_local, self.n_procs
        row = sends[0].shape[1:]
        home = self.devices[0]
        # [P(dest proc), L(src local), L(dest local), ...]
        x = torch.stack([s.to(home) for s in sends])          # [L, size]
        x = x.reshape(L, P, L, *row).transpose(0, 1).contiguous()
        x = self._wire(x)
        y = torch.empty_like(x)  # [P(src proc), L(src local), L(dest), ...]
        dist.all_to_all_single(y, x, group=self.group)
        y = y.reshape(self.size, L, *row)
        return [y[:, i].to(d).contiguous()
                for i, d in enumerate(self.devices)]

    def all_reduce(self, tensors, op):
        """Reduce over every shard of the mesh.  op: "sum" (in the
        tensors' dtype, so int32 bit patterns of uint32 sum mod 2**32, as
        the backends' SUM does), "min" (signed) or "umin32" (uint32 bit
        patterns in int32)."""
        if op not in _OPS:
            raise ValueError("all_reduce: unknown op {!r}".format(op))
        if len(tensors) != self.n_local:
            raise ValueError("all_reduce: one tensor per local shard")
        home = self.devices[0]
        flip = op == "umin32"
        acc = tensors[0].to(home) ^ _FLIP32 if flip else \
            tensors[0].to(home).clone()
        for t in tensors[1:]:
            t = t.to(home)
            if op == "sum":
                acc += t
            else:
                torch.minimum(acc, t ^ _FLIP32 if flip else t, out=acc)
        if self.group is not None:
            import torch.distributed as dist

            wire = self._wire(acc)
            dist.all_reduce(wire, op=dist.ReduceOp.SUM if op == "sum"
                            else dist.ReduceOp.MIN, group=self.group)
            acc = wire.to(home)
        if flip:
            acc ^= _FLIP32
        return self.replicate(acc)

    def total(self, values, op="sum"):
        """A Python int reduced over the mesh from one int (or one-element
        tensor) per local shard: "sum" or "max"."""
        t = torch.tensor([int(v) for v in values], dtype=torch.int64)
        local = int(t.sum()) if op == "sum" else int(t.max())
        if self.group is None:
            return local
        import torch.distributed as dist

        wire = torch.tensor([local], dtype=torch.int64)
        if self.backend == "nccl":
            wire = wire.to(self.devices[0])
        dist.all_reduce(wire, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=self.group)
        return int(wire.item())

    def all_gather(self, tensors):
        """Every shard's 1-D tensor (any lengths), on the host, in rank
        order: a list of numpy arrays of mesh.size."""
        if len(tensors) != self.n_local:
            raise ValueError("all_gather: one tensor per local shard")
        local = [t.cpu().numpy() for t in tensors]
        if self.group is None:
            return local
        import torch.distributed as dist

        lens = [a.size for a in local]
        width = self.total([max(lens)], "max")
        dtype = tensors[0].dtype
        pad = torch.zeros((self.n_local, max(width, 1)), dtype=dtype)
        for i, a in enumerate(local):
            pad[i, :a.size] = torch.from_numpy(a)
        sizes = torch.tensor(lens, dtype=torch.int64)
        on = self.devices[0] if self.backend == "nccl" else "cpu"
        pad, sizes = pad.to(on), sizes.to(on)
        pads = [torch.empty_like(pad) for _ in range(self.n_procs)]
        sizes_all = [torch.empty_like(sizes) for _ in range(self.n_procs)]
        dist.all_gather(pads, pad, group=self.group)
        dist.all_gather(sizes_all, sizes, group=self.group)
        out = []
        for p, s in zip(pads, sizes_all):
            p, s = p.cpu().numpy(), s.cpu().numpy()
            out += [p[i, :s[i]] for i in range(self.n_local)]
        return out

