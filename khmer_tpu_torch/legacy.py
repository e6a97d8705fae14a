"""khmer 1.x/2.x compatibility surface (a copy of khmer_tpu/legacy.py;
the factories take the port's `device`).

The reference package still exposes its nose-era module factories and
per-read frequency dumps alongside the 3.0 classes:

  * ``new_hashtable`` / ``new_hashbits`` and the ``Hashbits`` type
    (src/khmer/_cpy_khmer.cc:3242-3265, 4836-4841) — single-table
    counting hash and Bloom-graph constructors used throughout the
    2.x test suites (tests/test_hashbits.py, test_hashbits_obj.py,
    test_filter.py);
  * ``CountingHash::output_fasta_kmer_pos_freq`` (lib/counting.cc:
    "outputs the kmer frequencies for each read") and
    ``fasta_count_kmers_by_position`` (lib/counting.cc) — per-window
    count dumps over a FASTA file.

Here they are thin wrappers over the modern classes: the factories
return ordinary :class:`~khmer_tpu_torch.graph.Countgraph` /
:class:`Hashbits` objects (same prime-sized tables), and the dump
methods batch each read's windows through one device query instead of
the reference's per-k-mer ``get_count`` loop.
"""

from khmer_tpu_torch.graph import Countgraph, Nodegraph

__all__ = [
    "Hashbits",
    "new_hashbits",
    "new_hashtable",
    "output_fasta_kmer_pos_freq",
    "fasta_count_kmers_by_position",
]


class Hashbits(Nodegraph):
    """2.x name for the presence/absence Bloom de Bruijn graph.

    Constructor signature is identical to Nodegraph's
    (k, starting_size, n_tables); the reference kept the type as an
    alias through 3.0 (src/khmer/_cpy_khmer.cc:703-711).
    """


def new_hashbits(k, starting_size, n_tables=2, device=None):
    """1.x factory: khmer.new_hashbits(k, size, n) -> Hashbits.

    Parity: _cpy_khmer.cc new_hashbits (primes near `starting_size`,
    same as the class constructor).
    """
    return Hashbits(int(k), starting_size, int(n_tables), device=device)


def new_hashtable(k, size, device=None):
    """1.x factory: a single-table counting hash.

    Parity: _cpy_khmer.cc:3242-3265 new_hashtable (one table, exact
    requested size rounded to a prime like the class constructors).
    """
    return Countgraph(int(k), size, 1, device=device)


def output_fasta_kmer_pos_freq(table, inputfile, outputfile):
    """Write one line per read: the count of each k-mer window.

    Parity: CountingHash::output_fasta_kmer_pos_freq
    (lib/counting.cc) — raw reads (no cleaning), counts separated and
    terminated by single spaces, one newline per read (blank line for
    reads shorter than k).  Bound as a Hashtable method in
    hashtable.py.
    """
    from khmer_tpu_torch.io.fastx import FastxReader

    k = table.ksize()
    with open(outputfile, "w") as out:
        for read in FastxReader(inputfile):
            seq = read.sequence.upper()
            if len(seq) >= k:
                counts = table.get_kmer_counts(seq)
                out.write("".join("%d " % c for c in counts))
            out.write("\n")


def fasta_count_kmers_by_position(table, inputfile, max_read_len,
                                  limit_by_count=0):
    """Histogram of window *positions* whose count equals a target.

    Parity: CountingHash::fasta_count_kmers_by_position
    (lib/counting.cc) — valid (cleanable) reads only; position i is
    tallied when its window's count equals `limit_by_count` (or
    unconditionally when the limit is 0).  Returns a list of
    `max_read_len` tallies.  Bound as a Hashtable method.
    """
    from khmer_tpu_torch.io.fastx import FastxReader
    from khmer_tpu_torch.ops.encode import clean_sequence

    k = table.ksize()
    counts_at = [0] * int(max_read_len)
    for read in FastxReader(inputfile):
        seq = clean_sequence(read.sequence)
        if len(seq) < k:
            continue
        counts = table.get_kmer_counts(seq)
        for i, c in enumerate(counts):
            if i >= max_read_len:
                break
            if limit_by_count == 0 or c == limit_by_count:
                counts_at[i] += 1
    return counts_at
