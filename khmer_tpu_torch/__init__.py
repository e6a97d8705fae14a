"""khmer_tpu_torch: the PyTorch/CUDA port of khmer_tpu for NVIDIA Hopper.

It sits beside the JAX package and is held against it bit for bit; it
imports nothing of it.  Tables live on a CUDA device unless the caller
passes ``device="cpu"``, where every kernel runs as its plain PyTorch
version (khmer_tpu_torch/kernels/plain.py).

Ported so far: Countgraph and Nodegraph over the exact 2-bit hash, with
the scripts load-into-counting and abundance-dist(-single) (slice 1) and
normalize-by-median, trim-low-abund, filter-abund(-single) and
count-median (slice 2), each as ``khmer_tpu_torch.scripts.<name>.main``
(``main(argv, device=None)``), and the read-level queries they use
(``count_rows``, ``get_median_count(_batch)``, ``median_at_least(_batch)``,
``trim_on_abundance``, ``diginorm_batch``, ``trim_pass1_batch``, ...);
the murmur hash family (slice 3a): Counttable and Nodetable (any k up to
255, also behind ``-H murmur`` in the streaming filters), HLLCounter and
the script unique-kmers; tag-based partitioning (slice 4a): Hashgraph's
tags, SubsetPartition (with the device engine do_partition_device) and
the scripts load-graph, partition-graph, merge-partitions,
annotate-partitions and extract-partitions; 4-bit counts and the cyclic
hash (slice 3b): SmallCountgraph (behind ``--small-count`` in
load-into-counting, abundance-dist-single, normalize-by-median,
filter-abund-single and trim-low-abund), SmallCounttable and
CyclicCounttable (the rolling hash, any k up to 255); the banded and
masked consume (``consume_seqfile_banding``, ``consume_seqfile_with_mask``,
``consume_seqfile_banding_with_mask``) and the rest of the table API
(slices 2b and 3c): ``n_tables``, ``get_kmers``, ``get_raw_tables``,
``consume_fasta``, ``Nodegraph.update``, the positional dumps, the hash
and prime helpers, FastxParser (``parsing``), ``thread_utils``, Kmer,
HashSet and the 1.x names Hashbits, new_hashbits and new_hashtable;
traversal, stop tags and the knot-removal workflow (slice 4b): the graph
queries (``traverse_from_kmer``, ``calc_connected_graph_size``,
``find_high_degree_nodes``, ...), ``consume_seqfile_and_tag_with_stoptags``,
``repartition_largest_partition``, ``sweep_for_tags``, ``find_unpart``,
PrePartitionInfo and the scripts make-initial-stoptags, find-knots,
filter-stoptags and do-partition; labels, assembly and the read aligner
(slice 4c): GraphLabels, LinearAssembler, SimpleLabeledAssembler,
JunctionCountAssembler, ReadAligner, ``assemble_linear_path``, and the
sandbox scripts correct-reads, sweep-reads and assemble-on-the-go
(``khmer_tpu_torch.sandbox.<name>``); the quotient filter (slice 5):
QFCounttable, OnDiskQFCounttable and BufferedQFCounttable (behind
``--mqf``/``--bmqf`` in normalize-by-median and ``--mqf`` in
trim-low-abund), host-exact as khmer_tpu's.
"""

from collections import namedtuple
from struct import unpack
import sys

from khmer_tpu_torch._version import __version__
from khmer_tpu_torch.assembly import (JunctionCountAssembler, LinearAssembler,
                                      SimpleLabeledAssembler)
from khmer_tpu_torch.graph import (Countgraph, Hashgraph, Nodegraph,
                                   SmallCountgraph)
from khmer_tpu_torch.hashset import HashSet
from khmer_tpu_torch.hashtable import (BufferedQFCounttable, Counttable,
                                       CyclicCounttable, Nodetable,
                                       OnDiskQFCounttable, QFCounttable,
                                       SmallCounttable)
from khmer_tpu_torch.hllcounter import HLLCounter
from khmer_tpu_torch.io.fastx import FastxReader, Read
from khmer_tpu_torch.io.oxli_format import FILETYPES
from khmer_tpu_torch.kmer import Kmer
from khmer_tpu_torch.labeling import GraphLabels
from khmer_tpu_torch.legacy import Hashbits, new_hashbits, new_hashtable
from khmer_tpu_torch.ops.hashing import (
    forward_hash,
    forward_hash_no_rc,
    hash_murmur3_scalar as hash_murmur3,
    hash_no_rc_murmur3_scalar as hash_no_rc_murmur3,
    reverse_complement,
    reverse_hash,
)
from khmer_tpu_torch.parsing import FastxParser
from khmer_tpu_torch.partitioning import PrePartitionInfo, SubsetPartition
from khmer_tpu_torch.primes import get_n_primes_near_x, is_prime
from khmer_tpu_torch.readaligner import ReadAligner

__all__ = ["BufferedQFCounttable", "Countgraph", "Counttable",
           "CyclicCounttable", "FastxParser", "FastxReader", "GraphLabels",
           "HLLCounter", "HashSet", "Hashbits", "Hashgraph",
           "JunctionCountAssembler", "Kmer", "LinearAssembler", "Nodegraph",
           "Nodetable", "OnDiskQFCounttable", "PrePartitionInfo",
           "QFCounttable", "Read", "ReadAligner", "ReadParser",
           "SimpleLabeledAssembler", "SmallCountgraph",
           "SmallCounttable", "SubsetPartition",
           "__version__", "__version_cpp__", "calc_expected_collisions",
           "extract_countgraph_info", "extract_nodegraph_info",
           "forward_hash", "forward_hash_no_rc", "get_n_primes_near_x",
           "hash_murmur3", "hash_no_rc_murmur3", "is_prime", "new_hashbits",
           "new_hashtable", "reverse_complement", "reverse_hash"]

# khmer's name for its read parser (khmer_tpu/__init__.py:60)
ReadParser = FastxReader

_buckets_per_byte = {
    # parity with reference khmer/__init__.py:86-93
    'qfcounttable': 1 / 1.26,
    'countgraph': 1,
    'counttable': 1,
    'smallcountgraph': 2,
    'nodegraph': 8,
}


def extract_nodegraph_info(filename):
    """Header peek for a nodegraph file (khmer/__init__.py:96-132)."""
    try:
        with open(filename, 'rb') as f:
            signature, = unpack('4s', f.read(4))
            version, = unpack('B', f.read(1))
            ht_type, = unpack('B', f.read(1))
            ksize, = unpack('I', f.read(4))
            n_tables, = unpack('B', f.read(1))
            occupied, = unpack('Q', f.read(8))
            table_size, = unpack('Q', f.read(8))
        if signature != b"OXLI":
            raise ValueError(
                "Node graph '{}' is missing file type "
                "signature".format(filename) + str(signature))
    except ValueError:
        raise
    except Exception:
        raise ValueError("Node graph '{}' is corrupt ".format(filename))

    return ksize, round(table_size, -2), n_tables, version, ht_type, occupied


def extract_countgraph_info(filename):
    """Header peek for a countgraph file (khmer/__init__.py:135-179)."""
    CgInfo = namedtuple("CgInfo", ['ksize', 'n_tables', 'table_size',
                                   'use_bigcount', 'version', 'ht_type',
                                   'n_occupied'])
    try:
        with open(filename, 'rb') as f:
            signature, = unpack('4s', f.read(4))
            version, = unpack('B', f.read(1))
            ht_type, = unpack('B', f.read(1))
            if ht_type != FILETYPES['SMALLCOUNT']:
                use_bigcount, = unpack('B', f.read(1))
            else:
                use_bigcount = None
            ksize, = unpack('I', f.read(4))
            n_tables, = unpack('B', f.read(1))
            occupied, = unpack('Q', f.read(8))
            table_size, = unpack('Q', f.read(8))
        if signature != b'OXLI':
            raise ValueError(
                "Count graph file '{}' is missing file type "
                "signature. ".format(filename) + str(signature))
    except ValueError:
        raise
    except Exception:
        raise ValueError(
            "Count graph file '{}' is corrupt ".format(filename))

    return CgInfo(ksize, n_tables, round(table_size, -2), use_bigcount,
                  version, ht_type, occupied)


def __version_cpp__():
    """Version stamp compiled into the native loader: the analogue of
    reference khmer.__version_cpp__ (_cpy_khmer.cc / tests/test_version.py)."""
    from khmer_tpu_torch.native import native_version

    return native_version()


def calc_expected_collisions(graph, force=False, max_false_pos=.2):
    """FP-rate estimate + guard (khmer/__init__.py:182-216)."""
    sizes = graph.hashsizes()
    n_ht = float(len(sizes))
    occupancy = float(graph.n_occupied())
    min_size = min(sizes)

    fp_one = occupancy / min_size
    fp_all = fp_one ** n_ht

    if fp_all > max_false_pos:
        print("**", file=sys.stderr)
        print("** ERROR: the graph structure is too small for ",
              file=sys.stderr)
        print("** this data set.  Increase data structure size",
              file=sys.stderr)
        print("** with --max_memory_usage/-M.", file=sys.stderr)
        print("**", file=sys.stderr)
        print("** Do not use these results!!", file=sys.stderr)
        print("**", file=sys.stderr)
        print("** (estimated false positive rate of %.3f;" % fp_all,
              file=sys.stderr, end=' ')
        print("max recommended %.3f)" % max_false_pos, file=sys.stderr)
        print("**", file=sys.stderr)

        if not force:
            sys.exit(1)

    return fp_all
