#!/usr/bin/env python
# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Sequence trimming by abundance w/o countgraph.

Trim sequences at k-mers of the given abundance for the given file,
without loading a prebuilt countgraph.  Output sequences will be
placed in 'infile.abundfilt'.

% python scripts/filter-abund-single.py <data>

PyTorch/CUDA port of scripts/filter-abund-single.py: the same flags and
output bytes.  The file is counted on `device` as load-into-counting
counts it (K1, K2), then read back with K5, a batch of reads a call.
Run as ``python -m khmer_tpu_torch.scripts.filter_abund_single``.
"""

import os
import sys
import textwrap

import khmer_tpu_torch as khmer
from khmer_tpu_torch import khmer_args
from khmer_tpu_torch.io.fastx import FastxReader as ReadParser
from khmer_tpu_torch.khmer_args import (add_threading_args,
                                        build_counting_args,
                                        calculate_graphsize,
                                        check_argument_range,
                                        report_on_config, sanitize_help)
from khmer_tpu_torch.kfile import (add_output_compression_type,
                                   check_input_files, check_space,
                                   check_space_for_graph, get_file_writer)
from khmer_tpu_torch.khmer_logger import (configure_logging, log_error,
                                          log_info)
from khmer_tpu_torch.trimming import trim_record_from_counts
from khmer_tpu_torch.utils import broken_paired_reader, write_record

DEFAULT_NORMALIZE_LIMIT = 20
DEFAULT_CUTOFF = 2


def get_parser():
    epilog = """\
    Trimmed sequences will be placed in
    ``${input_sequence_filename}.abundfilt``.

    This script is constant memory.

    Example::

        filter-abund-single.py -k 20 -x 5e7 -C 2 data/100k-filtered.fa
    """
    parser = build_counting_args(
        descr="Trims sequences at a minimum k-mer abundance "
        "(in memory version).", epilog=textwrap.dedent(epilog),
        citations=['counting', 'SeqAn'])
    add_threading_args(parser)
    parser.add_argument('-C', '--cutoff', default=DEFAULT_CUTOFF,
                        type=check_argument_range(0, 256, "cutoff"),
                        help="Trim at k-mers below this abundance.")
    parser.add_argument('-V', '--variable-coverage', action='store_true',
                        dest='variable_coverage', default=False,
                        help='Only trim low-abundance k-mers from sequences '
                        'that have high coverage.')
    parser.add_argument('-Z', '--normalize-to', type=int,
                        dest='normalize_to',
                        help='Base the variable-coverage cutoff on this '
                        'median k-mer abundance.',
                        default=DEFAULT_NORMALIZE_LIMIT)
    parser.add_argument('--savegraph', metavar="filename", default='',
                        help="If present, the name of the file to save the "
                        "k-mer countgraph to")
    parser.add_argument('-o', '--outfile',
                        metavar='optional_output_filename',
                        default=None, help='Override default output filename '
                        'and output trimmed sequences into a file with the '
                        'given filename.')
    parser.add_argument('datafile', metavar='input_sequence_filename',
                        help="FAST[AQ] sequence file to trim")
    parser.add_argument('-f', '--force', default=False, action='store_true',
                        help='Overwrite output file if it exists')
    parser.add_argument('-q', '--quiet', dest='quiet', default=False,
                        action='store_true')
    add_output_compression_type(parser)
    return parser


def main(argv=None, device=None):
    args = sanitize_help(get_parser()).parse_args(argv)

    configure_logging(args.quiet)
    check_input_files(args.datafile, args.force)
    check_space([args.datafile], args.force)

    if args.savegraph:
        if args.hash_function != 'twobit-exact':
            log_error('ERROR: cannot save different hash functions yet.')
            sys.exit(1)

        tablesize = calculate_graphsize(args, 'countgraph')
        check_space_for_graph(args.savegraph, tablesize, args.force)

    report_on_config(args)

    log_info('making countgraph')
    graph = khmer_args.create_counttable(args, device=device)

    # first, load reads into graph
    log_info('consuming input, round 1 -- {datafile}',
             datafile=args.datafile)
    graph.consume_seqfile(args.datafile)

    log_info('Total number of unique k-mers: {nk}',
             nk=graph.n_unique_kmers())

    fp_rate = khmer.calc_expected_collisions(graph, args.force)
    log_info('fp rate estimated to be {fpr:1.3f}', fpr=fp_rate)

    # the filtering loop
    log_info('filtering {datafile}', datafile=args.datafile)
    if args.outfile is None:
        outfile = os.path.basename(args.datafile) + '.abundfilt'
    else:
        outfile = args.outfile
    outfp = open(outfile, 'wb')
    outfp = get_file_writer(outfp, args.gzip, args.bzip)

    paired_iter = broken_paired_reader(ReadParser(args.datafile),
                                       min_length=graph.ksize(),
                                       force_single=True)

    # the graph is frozen during the filtering pass: batch the fetches
    def flush(batch):
        rows = graph.count_rows([r.cleaned_seq for r in batch])
        for read, counts in zip(batch, rows):
            trimmed_record, _ = trim_record_from_counts(
                graph.ksize(), read, counts, args.cutoff,
                args.variable_coverage, args.normalize_to)
            if trimmed_record:
                write_record(trimmed_record, outfp)

    batch = []
    for n, is_pair, read1, read2 in paired_iter:
        assert not is_pair
        assert read2 is None
        batch.append(read1)
        if len(batch) >= 8192:
            flush(batch)
            batch = []
    if batch:
        flush(batch)

    log_info('output in {outfile}', outfile=outfile)

    if args.savegraph:
        log_info('Saving k-mer countgraph filename {graph}',
                 graph=args.savegraph)
        graph.save(args.savegraph)


if __name__ == '__main__':
    main()
