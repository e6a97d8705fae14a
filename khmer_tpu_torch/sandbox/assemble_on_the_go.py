#!/usr/bin/env python
# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Streaming assembly: low-coverage reads feed the countgraph,
medium-coverage reads get labeled across high-degree nodes, and once
a read's coverage saturates its labeled-path contigs are translated
and emitted as ORFs.

Usage: python -m khmer_tpu_torch.sandbox.assemble_on_the_go <reads.fq>
    [ ... ]

PyTorch/CUDA port of sandbox/assemble-on-the-go.py: the same output.
Read by read, as each read's decision reads the counts that the reads
before it added; the Countgraph(21, 1e8, 4) lives on `device` (CUDA
unless told otherwise).
"""

import argparse
import sys

from khmer_tpu_torch import Countgraph, GraphLabels
from khmer_tpu_torch.io.fastx import FastxReader

COV_LOW = 20      # below: just consume
COV_ASSEMBLE = 30  # at: assemble; between: trim + label
K = 21
MIN_ORF_LEN = 99

# standard genetic code, TCAG-nested codon order
_CODE = 'FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG'
_BASES = 'TCAG'
DNA_TO_AA = {
    a + b + c: _CODE[16 * i + 4 * j + k]
    for i, a in enumerate(_BASES)
    for j, b in enumerate(_BASES)
    for k, c in enumerate(_BASES)
}
_RC = str.maketrans('ACGTN', 'TGCAN')


def six_frame_peptides(seq):
    """Translate all six reading frames."""
    rc = seq.translate(_RC)[::-1]
    for frame_src in (seq, rc):
        for start in (0, 1, 2):
            yield ''.join(
                DNA_TO_AA.get(frame_src[i:i + 3], 'X')
                for i in range(start, len(frame_src), 3))


def orfs_of(seq, min_length=MIN_ORF_LEN):
    for pep in six_frame_peptides(seq):
        for orf in pep.split('*'):
            if len(orf) >= min_length:
                yield orf


def main(argv=None, device=None):
    cli = argparse.ArgumentParser(description='streaming ORF assembly')
    cli.add_argument('fastq_files', nargs='+')
    opts = cli.parse_args(argv)

    graph = Countgraph(K, 1e8, 4, device=device)
    labels = GraphLabels(graph)
    next_label = 1
    next_orf = 1
    emitted = set()

    n = 0
    for filename in opts.fastq_files:
        for record in FastxReader(filename):
            n += 1
            if n % 10000 == 0:
                print('...', n, file=sys.stderr)

            seq = record.sequence
            if len(seq) < K:
                continue

            cov, _, _ = graph.get_median_count(seq)

            if cov < COV_LOW:
                graph.consume(seq)
            elif cov < COV_ASSEMBLE:
                trimmed, _ = graph.trim_on_abundance(seq, 3)
                if len(trimmed) < K:
                    continue
                graph.consume(trimmed)
                hdn = graph.find_high_degree_nodes(trimmed)
                labels.label_across_high_degree_nodes(trimmed, hdn,
                                                      next_label)
                next_label += 1
            elif cov == COV_ASSEMBLE:
                for contig in labels.assemble_labeled_path(seq[:K]):
                    for orf in orfs_of(contig):
                        if hash(orf) in emitted:
                            continue
                        emitted.add(hash(orf))
                        print('>orf%d\n%s' % (next_orf, orf))
                        next_orf += 1


if __name__ == '__main__':
    main()
