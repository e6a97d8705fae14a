#!/usr/bin/env python
# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Count the median/avg k-mer abundance for each sequence in the input
file, based on the k-mer counts in the given k-mer countgraph.

% scripts/count-median.py <countgraph> <input seqs> <output counts>

The output file contains sequence id, median, average, stddev, and seq
length, in comma-separated value (CSV) format.

NOTE: All 'N's in the input sequences are converted to 'A's.

PyTorch/CUDA port of scripts/count-median.py: the same flags and output
bytes.  The countgraph is loaded onto `device` and read with K5, a batch
of reads a call.  Run as ``python -m khmer_tpu_torch.scripts.count_median``.
"""

import argparse
import csv
import sys
import textwrap

import numpy as np

from khmer_tpu_torch import Countgraph
from khmer_tpu_torch.io.fastx import screed_open
from khmer_tpu_torch.kfile import check_input_files, check_space
from khmer_tpu_torch.khmer_args import KhmerArgumentParser, sanitize_help


def get_parser():
    epilog = """\
    Count the median/avg k-mer abundance for each sequence in the input
    file, based on the k-mer counts in the given k-mer countgraph.  Can be
    used to estimate expression levels (mRNAseq) or coverage
    (genomic/metagenomic).

    Example::

        load-into-counting.py counts tests/test-data/test-reads.fq.gz
        count-median.py counts tests/test-data/test-reads.fq.gz medians.txt

    NOTE: All 'N's in the input sequences are converted to 'A's.
    """
    parser = KhmerArgumentParser(
        description='Count k-mers summary stats for sequences',
        epilog=textwrap.dedent(epilog))
    parser.add_argument('countgraph', metavar='input_count_graph_filename',
                        help='input k-mer countgraph filename')
    parser.add_argument('input', metavar='input_sequence_filename',
                        help='input FAST[AQ] sequence filename')
    parser.add_argument('output', metavar='output_summary_filename',
                        help='output summary filename',
                        type=argparse.FileType('w'))
    parser.add_argument('-f', '--force', default=False, action='store_true',
                        help='Overwrite output file if it exists')
    return parser


def main(argv=None, device=None):
    args = sanitize_help(get_parser()).parse_args(argv)

    htfile = args.countgraph
    input_filename = args.input
    output = args.output

    infiles = [htfile, input_filename]
    for infile in infiles:
        check_input_files(infile, args.force)

    check_space(infiles, args.force)

    print('loading k-mer countgraph from', htfile, file=sys.stderr)
    countgraph = Countgraph.load(htfile, device=device)
    ksize = countgraph.ksize()
    print('writing to', getattr(output, 'name', '-'), file=sys.stderr)

    output = csv.writer(output)
    output.writerow(['name', 'median', 'average', 'stddev', 'seqlen'])

    def flush(batch):
        rows = countgraph._hash_count_rows([s for _, s in batch])
        for (name, seq), (hashes, counts) in zip(batch, rows):
            # counts read saturated at MAX_KCOUNT; a graph loaded with
            # a bigcount section overlays the exact >255 values
            # (reference CountingHash::get_count + bigcount map)
            counts = countgraph.storage.overlay_bigcounts(
                np.asarray(counts), np.asarray(hashes))
            # float32 SEQUENTIAL accumulation replicates the C++
            # get_median_count arithmetic bit-for-bit (float average/
            # stddev, reference src/oxli/hashtable.cc:307-339) —
            # cumsum is the sequential sum, f64 pairwise sums differ
            # in the 7th decimal of the goldens
            c32 = counts.astype(np.float32)
            n = np.float32(c32.size)
            ave = np.cumsum(c32, dtype=np.float32)[-1] / n
            var = np.cumsum((c32 - ave) ** 2,
                            dtype=np.float32)[-1] / n
            stdev = np.sqrt(var, dtype=np.float32)
            medn = int(np.sort(c32)[c32.size // 2])
            ave, stdev = [round(float(x), 9) for x in (ave, stdev)]
            output.writerow([name, medn, ave, stdev, len(seq)])

    batch = []
    for record in screed_open(input_filename):
        seq = record.sequence.upper()
        if 'N' in seq:
            seq = seq.replace('N', 'A')

        if ksize <= len(seq):
            batch.append((record.name, seq))
            if len(batch) >= 8192:
                flush(batch)
                batch = []
    if batch:
        flush(batch)


if __name__ == '__main__':
    main()
