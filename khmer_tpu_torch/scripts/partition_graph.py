# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Partition a graph based on waypoint connectivity.

% partition-graph.py <basename>

Load a k-mer nodegraph + tagset and partition the tag graph; output
one ${basename}.subset.#.pmap file per subset.

PyTorch/CUDA port of scripts/partition-graph.py: the same flags and
output bytes; the searches of a batch of seed tags probe the graph on
`device` (CUDA unless told otherwise) one level at a time, and
-T/--threads is accepted and ignored, as in khmer_tpu.  Run as
``python -m khmer_tpu_torch.scripts.partition_graph``.
"""

import sys
import textwrap

from khmer_tpu_torch import Nodegraph
from khmer_tpu_torch.khmer_args import (KhmerArgumentParser,
                                        add_threading_args, sanitize_help)
from khmer_tpu_torch.kfile import check_input_files

DEFAULT_SUBSET_SIZE = int(1e5)


def get_parser():
    epilog = """\
    The resulting partition maps are saved as ``${basename}.subset.#.pmap``
    files.
    """
    parser = KhmerArgumentParser(
        description="Partition a sequence graph based upon waypoint "
        "connectivity", epilog=textwrap.dedent(epilog),
        citations=['graph'])
    parser.add_argument('basename', help="basename of the input k-mer "
                        "nodegraph  + tagset files")
    parser.add_argument('-S', '--stoptags', metavar='filename', default='',
                        help="Use stoptags in this file during partitioning")
    parser.add_argument('-s', '--subset-size', default=DEFAULT_SUBSET_SIZE,
                        type=float, help='Set subset size (usually 1e5-1e6 '
                        'is good)')
    parser.add_argument('--no-big-traverse', action='store_true',
                        default=False, help='Truncate graph joins at big '
                        'traversals')
    parser.add_argument('-f', '--force', default=False, action='store_true',
                        help='Overwrite output file if it exists')
    add_threading_args(parser)
    return parser


def main(argv=None, device=None):
    args = sanitize_help(get_parser()).parse_args(argv)
    basename = args.basename

    for fname in (basename, basename + '.tagset'):
        check_input_files(fname, args.force)

    print('--', file=sys.stderr)
    print('SUBSET SIZE', args.subset_size, file=sys.stderr)
    print('N THREADS', args.threads, file=sys.stderr)
    if args.stoptags:
        print('stoptag file:', args.stoptags, file=sys.stderr)
    print('--', file=sys.stderr)

    print('loading nodegraph %s' % basename, file=sys.stderr)
    nodegraph = Nodegraph.load(basename, device=device)
    nodegraph.load_tagset(basename + '.tagset')

    if args.stoptags:
        print('loading stoptags from', args.stoptags, file=sys.stderr)
        nodegraph.load_stop_tags(args.stoptags)

    stop_big_traversals = args.no_big_traverse
    if stop_big_traversals:
        print('** This script brakes for lumps:',
              ' stop_big_traversals is true.', file=sys.stderr)
    else:
        print('** Traverse all the things:',
              ' stop_big_traversals is false.', file=sys.stderr)

    # divide the tags up into subsets
    divvy = list(nodegraph.divide_tags_into_subsets(int(args.subset_size)))
    n_subsets = len(divvy)
    divvy.append(0)

    print('enqueued %d subset tasks' % n_subsets, file=sys.stderr)
    with open('%s.info' % basename, 'w') as info_fp:
        info_fp.write('%d subsets total\n' % n_subsets)

    for i in range(n_subsets):
        start, end = divvy[i], divvy[i + 1]
        print('starting pre-partitioning on subset %d/%d' %
              (i + 1, n_subsets), file=sys.stderr)
        subset = nodegraph.do_subset_partition(
            start, end, break_on_stop_tags=bool(args.stoptags),
            stop_big_traversals=stop_big_traversals)
        outfile = '%s.subset.%d.pmap' % (basename, i)
        subset.save_partitionmap(outfile)
        print('saved %s' % outfile, file=sys.stderr)

    print('---', file=sys.stderr)
    print('done making subsets! see %s.subset.*.pmap' %
          (basename,), file=sys.stderr)


if __name__ == '__main__':
    main()
