# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Build a graph from the given sequences, save in <ptname>.

% load-graph.py <ptname> <data1> [ <data2> <...> ]

Use '-h' for parameter help.

PyTorch/CUDA port of scripts/load-graph.py: the same flags and output
bytes (<ptname>, <ptname>.tagset, <ptname>.info); the nodegraph lives on
`device` (CUDA unless told otherwise).  Run as
``python -m khmer_tpu_torch.scripts.load_graph``.
"""

import sys

import khmer_tpu_torch as khmer
from khmer_tpu_torch import khmer_args
from khmer_tpu_torch.khmer_args import (add_threading_args,
                                        build_nodegraph_args,
                                        calculate_graphsize,
                                        report_on_config, sanitize_help)
from khmer_tpu_torch.kfile import check_input_files, check_space_for_graph


def get_parser():
    parser = build_nodegraph_args(
        descr="Load sequences into the compressible graph format "
        "plus optional tagset.")
    add_threading_args(parser)
    parser.add_argument('--no-build-tagset', '-n', default=False,
                        action='store_true', dest='no_build_tagset',
                        help='Do NOT construct tagset while loading '
                        'sequences')
    parser.add_argument('output_filename',
                        metavar='output_nodegraph_filename', help='output'
                        ' k-mer nodegraph filename.')
    parser.add_argument('input_filenames', metavar='input_sequence_filename',
                        nargs='+', help='input FAST[AQ] sequence filename')
    parser.add_argument('-f', '--force', default=False, action='store_true',
                        help='Overwrite output file if it exists')
    return parser


def main(argv=None, device=None):
    args = sanitize_help(get_parser()).parse_args(argv)
    graph_type = 'nodegraph'
    report_on_config(args, graphtype=graph_type)
    base = args.output_filename
    filenames = args.input_filenames

    for fname in filenames:
        check_input_files(fname, args.force)

    graphsize = calculate_graphsize(args, graph_type)
    space_needed = (args.n_tables * graphsize /
                    khmer._buckets_per_byte[graph_type])
    check_space_for_graph(base, space_needed, args.force)

    print('Saving k-mer nodegraph to %s' % base, file=sys.stderr)
    print('Loading kmers from sequences in %s' %
          repr(filenames), file=sys.stderr)
    if args.no_build_tagset:
        print('We WILL NOT build the tagset.', file=sys.stderr)
    else:
        print('We WILL build the tagset (for partitioning/traversal).',
              file=sys.stderr)

    print('making nodegraph', file=sys.stderr)
    nodegraph = khmer_args.create_nodegraph(args, device=device)

    for filename in filenames:
        print('consuming input', filename, file=sys.stderr)
        if args.no_build_tagset:
            nodegraph.consume_seqfile(filename)
        else:
            nodegraph.consume_seqfile_and_tag(filename)

    print('Total number of unique k-mers: {0}'.format(
        nodegraph.n_unique_kmers()), file=sys.stderr)

    print('saving k-mer nodegraph in', base, file=sys.stderr)
    nodegraph.save(base)

    if not args.no_build_tagset:
        print('saving tagset in', base + '.tagset', file=sys.stderr)
        nodegraph.save_tagset(base + '.tagset')

    with open(base + '.info', 'w') as info_fp:
        info_fp.write('%d unique k-mers' % nodegraph.n_unique_kmers())

        fp_rate = \
            khmer.calc_expected_collisions(
                nodegraph, args.force, max_false_pos=.15)
        # 0.18 is ACTUAL MAX. Do not change.

        print('false positive rate estimated to be %1.3f' % fp_rate,
              file=sys.stderr)
        print('\nfalse positive rate estimated to be %1.3f' % fp_rate,
              file=info_fp)

    print('wrote to ' + base + '.info and ' + base, file=sys.stderr)
    if not args.no_build_tagset:
        print('and ' + base + '.tagset', file=sys.stderr)


if __name__ == '__main__':
    main()
