"""Carry sketch state from host arrays into the port.

A khmer_tpu table (``np.asarray(cg.storage.table)``, a uint32 array of
sum(tablesizes) + 1 bins) together with its counters becomes a port
table that answers every query the same way, a graph with its tags and
stop tags too; khmer_tpu's HLL registers (``np.asarray(h._counters)
[:-1]``) become a port HLLCounter.
"""

import numpy as np
import torch

from khmer_tpu_torch.graph import Countgraph
from khmer_tpu_torch.hashtable import QFCounttable
from khmer_tpu_torch.hllcounter import HLLCounter
from khmer_tpu_torch.storage import BY_KIND


def storage_from_numpy(kind, tablesizes, bins_u32, n_unique=0,
                       bigcount_candidates=(), bigcounts=None,
                       device=None):
    """A 'byte', 'nibble' or 'bit' Storage holding the given uint32
    bins."""
    st = BY_KIND[kind](tablesizes, device=device)
    bins = np.array(bins_u32, np.uint32)
    if bins.shape != (st.spec.total_bins + 1,):
        raise ValueError("expected {} bins, got {}".format(
            st.spec.total_bins + 1, bins.shape))
    st.replace_table(torch.from_numpy(bins.view(np.int32)).to(st.device))
    st._n_unique.fill_(int(n_unique))
    st.bigcount_candidates = set(int(h) for h in bigcount_candidates)
    st.bigcounts = dict(bigcounts or {})
    return st


def countgraph_from_numpy(ksize, tablesizes, bins_u32, n_unique=0,
                          bigcount_candidates=(), bigcounts=None,
                          use_bigcount=False, device=None):
    """A Countgraph over the given uint32 bins; use_bigcount as
    khmer_tpu's graph has it (``cg.get_use_bigcount()``)."""
    return table_from_numpy(Countgraph, ksize, tablesizes, bins_u32,
                            n_unique, bigcount_candidates, bigcounts,
                            use_bigcount, device)


def table_from_numpy(cls, ksize, tablesizes, bins_u32, n_unique=0,
                     bigcount_candidates=(), bigcounts=None,
                     use_bigcount=False, device=None):
    """A table of class `cls` (Countgraph, SmallCountgraph, Nodegraph,
    Counttable, SmallCounttable, CyclicCounttable or Nodetable) over the
    given uint32 bins; use_bigcount as khmer_tpu's table has it (byte
    tables only)."""
    t = cls.__new__(cls)
    t._ksize = int(ksize)
    t.storage = storage_from_numpy(cls.storage_class.kind, tablesizes,
                                   bins_u32, n_unique, bigcount_candidates,
                                   bigcounts, device)
    if t.storage.kind == "byte":
        t.set_use_bigcount(use_bigcount)
    t._post_load()
    return t


def graph_from_numpy(cls, ksize, sizes, bins, tags=(), stop_tags=(),
                     tag_density=40, device=None):
    """A Countgraph or Nodegraph (`cls`) over khmer_tpu's uint32 bins with
    its tags, stop tags and tag density (``g.all_tags``, ``g.stop_tags``,
    ``g.tag_density``), so that both packages partition one state."""
    g = table_from_numpy(cls, ksize, sizes, bins, device=device)
    g.all_tags = set(int(t) for t in tags)
    g.stop_tags = set(int(t) for t in stop_tags)
    g._tag_density = int(tag_density)
    return g


def hll_from_numpy(counters_u8, ksize, device=None):
    """An HLLCounter holding the given uint8 registers (their count is the
    register count, as khmer_tpu's explicit-count constructor takes it)."""
    regs = np.asarray(counters_u8, np.uint8)
    h = HLLCounter(int(regs.size), ksize, device=device)
    h.counters = regs
    return h


def qf_from_numpy(ksize, nslots, slot_size, keys, counts, device=None):
    """A QFCounttable of nslots slots (slot_size remainder bits, None for
    the classic 8) holding the given sorted distinct uint64 keys with
    their uint64 counts, as khmer_tpu's QFStorage.state_arrays() gives
    them."""
    keys = np.array(keys, np.uint64)
    counts = np.array(counts, np.uint64)
    if keys.shape != counts.shape or keys.ndim != 1 or \
            (keys[1:] <= keys[:-1]).any():
        raise ValueError("need sorted distinct keys with one count each")
    t = QFCounttable(ksize, nslots, slot_size, device=device)
    if keys.size and keys[-1] >= t.storage.range:
        raise ValueError("a key lies outside the filter's key range")
    t.storage.set_state_arrays(keys, counts)
    return t
