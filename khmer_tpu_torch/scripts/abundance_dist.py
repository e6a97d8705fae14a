# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Histogram k-mer abundances of a sequence file against a
previously saved countgraph.

Usage: abundance-dist.py [ -z -s ] <countgraph> <data> <histout>
(-h shows every option).  PyTorch/CUDA port of scripts/abundance-dist.py
with the same flags and output bytes; run as
``python -m khmer_tpu_torch.scripts.abundance_dist``.
"""

import csv
import os
import sys
import textwrap

import khmer_tpu_torch as khmer
from khmer_tpu_torch import Countgraph
from khmer_tpu_torch.kfile import check_input_files
from khmer_tpu_torch.khmer_args import KhmerArgumentParser, sanitize_help
from khmer_tpu_torch.khmer_logger import (configure_logging, log_error,
                                          log_info, log_warn)


def get_parser():
    epilog = """\
    Build the table first, then histogram against it::

        load-into-counting.py -x 1e7 -N 2 -k 17 counts reads.fa
        abundance-dist.py counts reads.fa reads.dist
    """
    parser = KhmerArgumentParser(
        description="Histogram the k-mer abundances of a sequence file "
        "against a saved countgraph.",
        epilog=textwrap.dedent(epilog), citations=['counting'])

    parser.add_argument('input_count_graph_filename',
                        help='saved k-mer countgraph to read counts from')
    parser.add_argument('input_sequence_filename',
                        help='FAST[AQ] file whose k-mers are histogrammed')
    parser.add_argument('output_histogram_filename',
                        help='CSV output: abundance, k-mer count, '
                        'cumulative count, cumulative fraction of '
                        'distinct k-mers')
    parser.add_argument('-z', '--no-zero', dest='output_zero', default=True,
                        action='store_false',
                        help='skip abundance bins with zero k-mers')
    parser.add_argument('-s', '--squash', dest='squash_output', default=False,
                        action='store_true',
                        help='overwrite an existing output file')
    parser.add_argument('-b', '--no-bigcount', dest='bigcount', default=True,
                        action='store_false',
                        help='stop counting at 255, ignoring bigcounts')
    parser.add_argument('-f', '--force', default=False, action='store_true',
                        help='continue past missing or empty input files')
    parser.add_argument('-q', '--quiet', dest='quiet', default=False,
                        action='store_true')
    return parser


def main(argv=None, device=None):
    args = sanitize_help(get_parser()).parse_args(argv)
    configure_logging(args.quiet)

    infiles = [args.input_count_graph_filename,
               args.input_sequence_filename]
    for infile in infiles:
        check_input_files(infile, False)

    log_info('loading saved countgraph {graph}',
             graph=args.input_count_graph_filename)
    countgraph = Countgraph.load(args.input_count_graph_filename,
                                  device=device)

    if not countgraph.get_use_bigcount() and args.bigcount:
        log_warn("WARNING: The loaded graph has bigcount DISABLED while "
                 "bigcount reporting is ENABLED--counts higher than 255 "
                 "will not be reported.")

    countgraph.set_use_bigcount(args.bigcount)

    kmer_size = countgraph.ksize()
    hashsizes = countgraph.hashsizes()
    tracking = khmer.Nodegraph(kmer_size, 1, 1, primes=hashsizes,
                               device=countgraph.device)

    log_info('k-mer size: {ksize}', ksize=kmer_size)
    log_info('histogram will be written to {output}',
             output=args.output_histogram_filename)

    if args.output_histogram_filename in ('-', '/dev/stdout'):
        pass
    elif os.path.exists(args.output_histogram_filename):
        if not args.squash_output:
            log_error('ERROR: {output} exists; not squashing.',
                      output=args.output_histogram_filename)
            sys.exit(1)
        log_info('** squashing existing file {output}',
                 output=args.output_histogram_filename)

    log_info('computing the abundance histogram...')
    abundances = countgraph.abundance_distribution(
        args.input_sequence_filename, tracking)
    total = sum(abundances)

    if 0 == total:
        log_error("ERROR: abundance distribution is uniformly zero; "
                  "nothing to report.")
        log_error("\tPlease verify that the input files are valid.")
        sys.exit(1)

    if args.output_histogram_filename in ('-', '/dev/stdout'):
        countgraph_fp = sys.stdout
    else:
        countgraph_fp = open(args.output_histogram_filename, 'w')
    countgraph_fp_csv = csv.writer(countgraph_fp)
    countgraph_fp_csv.writerow(['abundance', 'count', 'cumulative',
                                'cumulative_fraction'])

    sofar = 0
    for abund, count in enumerate(abundances):
        if count == 0 and not args.output_zero:
            continue
        sofar += count
        frac = sofar / float(total)
        countgraph_fp_csv.writerow([abund, count, sofar, round(frac, 3)])
        if sofar == total:
            break
    if countgraph_fp is not sys.stdout:
        countgraph_fp.close()


if __name__ == '__main__':
    main()
