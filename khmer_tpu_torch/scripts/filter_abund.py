#!/usr/bin/env python
# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Trim sequences at a minimum k-mer abundance, using a pre-built
countgraph.

% python scripts/filter-abund.py <countgraph> <data1> [ <data2> <...> ]

Trimmed sequences will be placed in ${input_sequence_filename}.abundfilt.

PyTorch/CUDA port of scripts/filter-abund.py: the same flags and output
bytes (-T is accepted and unused).  The countgraph is loaded onto
`device` and read with K5, a batch of reads a call.  Run as
``python -m khmer_tpu_torch.scripts.filter_abund``.
"""

import os
import sys
import textwrap

from khmer_tpu_torch import Countgraph
from khmer_tpu_torch.io.fastx import FastxReader as ReadParser
from khmer_tpu_torch.khmer_args import (FileType as khFileType,
                                        KhmerArgumentParser,
                                        add_threading_args,
                                        check_argument_range, sanitize_help)
from khmer_tpu_torch.kfile import (add_output_compression_type,
                                   check_input_files, check_space,
                                   get_file_writer)
from khmer_tpu_torch.khmer_logger import (configure_logging, log_error,
                                          log_info)
from khmer_tpu_torch.trimming import trim_record_from_counts
from khmer_tpu_torch.utils import broken_paired_reader, write_record

DEFAULT_NORMALIZE_LIMIT = 20
DEFAULT_CUTOFF = 2


def get_parser():
    epilog = """\
    Trimmed sequences will be placed in
    ``${input_sequence_filename}.abundfilt`` for each input sequence file.
    If the input sequences are from RNAseq or metagenome sequencing then
    :option:`--variable-coverage` should be used.

    Example::

        load-into-counting.py -k 20 -x 5e7 countgraph data/100k-filtered.fa
        filter-abund.py -C 2 countgraph data/100k-filtered.fa
    """
    parser = KhmerArgumentParser(
        description='Trim sequences at a minimum k-mer abundance.',
        epilog=textwrap.dedent(epilog),
        citations=['counting'])
    parser.add_argument('input_graph', metavar='input_count_graph_filename',
                        help='The input k-mer countgraph filename')
    parser.add_argument('input_filename', metavar='input_sequence_filename',
                        help='Input FAST[AQ] sequence filename', nargs='+')
    add_threading_args(parser)
    parser.add_argument('-C', '--cutoff', dest='cutoff',
                        default=DEFAULT_CUTOFF,
                        type=check_argument_range(0, 256, 'cutoff'),
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
    parser.add_argument('-o', '--output', dest='single_output_file',
                        type=khFileType('wb'),
                        metavar="optional_output_filename",
                        help='Output the trimmed sequences into a single '
                        'file with the given filename instead of creating a '
                        'new file for each input file.')
    parser.add_argument('-f', '--force', default=False, action='store_true',
                        help='Overwrite output file if it exists')
    parser.add_argument('-q', '--quiet', dest='quiet', default=False,
                        action='store_true')
    add_output_compression_type(parser)
    return parser


def main(argv=None, device=None):
    args = sanitize_help(get_parser()).parse_args(argv)

    configure_logging(args.quiet)

    infiles = args.input_filename
    if ('-' in infiles or '/dev/stdin' in infiles) and not \
       args.single_output_file:
        log_error("Accepting input from stdin; output filename must "
                  "be provided with -o.")
        sys.exit(1)

    for filename in infiles:
        check_input_files(filename, args.force)

    check_space(infiles, args.force)

    log_info('loading countgraph: {graph}', graph=args.input_graph)
    countgraph = Countgraph.load(args.input_graph, device=device)
    ksize = countgraph.ksize()

    log_info("K: {ksize}", ksize=ksize)

    if args.single_output_file:
        outfile = args.single_output_file.name
        outfp = get_file_writer(args.single_output_file, args.gzip,
                                args.bzip)

    # the filtering loop
    for infile in infiles:
        log_info('filtering {infile}', infile=infile)
        if not args.single_output_file:
            outfile = os.path.basename(infile) + '.abundfilt'
            outfp = open(outfile, 'wb')
            outfp = get_file_writer(outfp, args.gzip, args.bzip)

        paired_iter = broken_paired_reader(ReadParser(infile),
                                           min_length=ksize,
                                           force_single=True)

        # the countgraph is frozen here, so whole batches of reads are
        # trimmed from one device fetch
        def flush(batch):
            rows = countgraph.count_rows(
                [r.cleaned_seq for r in batch])
            for read, counts in zip(batch, rows):
                trimmed_record, _ = trim_record_from_counts(
                    ksize, read, counts, args.cutoff,
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


if __name__ == '__main__':
    main()
