# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Calculate the abundance distribution of k-mers from a single sequence
file, building the countgraph in the process.

% python scripts/abundance-dist-single.py <data> <histout>

Use '-h' for parameter help.

PyTorch/CUDA port of scripts/abundance-dist-single.py (same flags and
output bytes).  Run as
``python -m khmer_tpu_torch.scripts.abundance_dist_single``.
"""

import csv
import os
import sys
import textwrap

from khmer_tpu_torch import khmer_args
from khmer_tpu_torch.khmer_args import (add_threading_args,
                                        build_counting_args,
                                        calculate_graphsize,
                                        report_on_config, sanitize_help)
from khmer_tpu_torch.kfile import check_input_files, check_space_for_graph
from khmer_tpu_torch.khmer_logger import (configure_logging, log_error,
                                          log_info)


def get_parser():
    epilog = '''\
    Note that with :option:`-b`/:option:`--no-bigcount` this script is
    constant memory; in exchange, k-mer counts will stop at 255.

    To count k-mers in multiple files use :program:`load_into_counting.py`
    and :program:`abundance_dist.py`.

    Example::

        abundance-dist-single.py -x 1e7 -N 2 -k 17 \\
                tests/test-data/test-abund-read-2.fa test-dist
    '''
    parser = build_counting_args(
        descr="Calculate the abundance distribution of k-mers from a "
        "single sequence file.", epilog=textwrap.dedent(epilog),
        citations=['counting', 'SeqAn'])
    add_threading_args(parser)

    parser.add_argument('input_sequence_filename', help='The name of the '
                        'input FAST[AQ] sequence file.')
    parser.add_argument('output_histogram_filename', help='The name of the '
                        'output histogram file. The columns are: (1) k-mer '
                        'abundance, (2) k-mer count, (3) cumulative count, '
                        '(4) fraction of total distinct k-mers.')
    parser.add_argument('-z', '--no-zero', dest='output_zero', default=True,
                        action='store_false',
                        help='Do not output zero-count bins')
    parser.add_argument('-b', '--no-bigcount', dest='bigcount', default=True,
                        action='store_false',
                        help='Do not count k-mers past 255')
    parser.add_argument('-s', '--squash', dest='squash_output', default=False,
                        action='store_true',
                        help='Overwrite output file if it exists')
    parser.add_argument('--savegraph', metavar="filename",
                        help="Save the k-mer countgraph to the specified "
                        "filename.")
    parser.add_argument('-f', '--force', default=False, action='store_true',
                        help='Override sanity checks')
    parser.add_argument('-q', '--quiet', dest='quiet', default=False,
                        action='store_true')
    return parser


def main(argv=None, device=None):
    args = sanitize_help(get_parser()).parse_args(argv)
    graph_type = 'smallcountgraph' if args.small_count else 'countgraph'

    configure_logging(args.quiet)
    report_on_config(args, graph_type)

    check_input_files(args.input_sequence_filename, args.force)
    if args.savegraph is not None:
        graphsize = calculate_graphsize(args, graph_type)
        check_space_for_graph(args.savegraph, graphsize, args.force)
    if (not args.squash_output and
            os.path.exists(args.output_histogram_filename)):
        log_error('ERROR: {output} exists; not squashing.',
                  output=args.output_histogram_filename)
        sys.exit(1)

    hist_fp = open(args.output_histogram_filename, 'w')
    hist_fp_csv = csv.writer(hist_fp)
    hist_fp_csv.writerow(['abundance', 'count', 'cumulative',
                          'cumulative_fraction'])

    log_info('making countgraph')
    # reserve ~8/9 of any memory cap for the countgraph, ~1/9 for tracking
    countgraph = khmer_args.create_countgraph(args, multiplier=8 / (9. + 0.3),
                                             device=device)

    log_info('building k-mer tracking graph')
    tracking = khmer_args.create_matching_nodegraph(countgraph)

    log_info('kmer_size: {ksize}', ksize=countgraph.ksize())
    log_info('k-mer countgraph sizes: {sizes}', sizes=countgraph.hashsizes())
    log_info('outputting to {output}', output=args.output_histogram_filename)

    log_info('consuming input, round 1 -- {input}',
             input=args.input_sequence_filename)
    countgraph.consume_seqfile(args.input_sequence_filename)

    log_info('Total number of unique k-mers: {nk}',
             nk=countgraph.n_unique_kmers())

    log_info('preparing hist from {seqfile}...',
             seqfile=args.input_sequence_filename)
    log_info('consuming input, round 2 -- {filename}',
             filename=args.input_sequence_filename)
    abundance_list = countgraph.abundance_distribution(
        args.input_sequence_filename, tracking)

    abundance = dict(enumerate(abundance_list))
    total = sum(abundance.values())

    if 0 == total:
        log_error("ERROR: abundance distribution is uniformly zero; "
                  "nothing to report.")
        log_error("\tPlease verify that the input files are valid.")
        sys.exit(1)

    sofar = 0
    for abund, count in sorted(abundance.items()):
        if count == 0 and not args.output_zero:
            continue
        sofar += count
        frac = sofar / float(total)
        hist_fp_csv.writerow([abund, count, sofar, round(frac, 3)])
        if sofar == total:
            break
    hist_fp.close()

    if args.savegraph is not None:
        log_info('Saving k-mer countgraph to {savegraph}',
                 savegraph=args.savegraph)
        countgraph.save(args.savegraph)

    log_info('wrote to: {output}', output=args.output_histogram_filename)


if __name__ == '__main__':
    main()
