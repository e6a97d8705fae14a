# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Do all the partition steps in one script.

% do-partition.py <graphbase> <reads1> [ <reads2> ... ]

Use '-h' for parameter help.

PyTorch/CUDA port of scripts/do-partition.py: load-graph +
partition-graph + merge-partitions + annotate-partitions in one run,
with the same flags and output bytes; the nodegraph lives on `device`
(CUDA unless told otherwise), and the pmap files are merged in glob
order, as khmer_tpu merges them.  Run as
``python -m khmer_tpu_torch.scripts.do_partition``.
"""

import glob
import os
import sys
import textwrap

import khmer_tpu_torch as khmer
from khmer_tpu_torch import Nodegraph, khmer_args
from khmer_tpu_torch.khmer_args import (add_threading_args,
                                        build_nodegraph_args,
                                        report_on_config, sanitize_help)
from khmer_tpu_torch.kfile import check_input_files, check_space

DEFAULT_SUBSET_SIZE = int(1e5)


def get_parser():
    epilog = """\
    Load in a set of sequences, partition them, merge the partitions,
    and annotate the original sequences files with the partition
    information.

    This script combines the functionality of :program:`load-graph.py`,
    :program:`partition-graph.py`, :program:`merge-partitions.py`, and
    :program:`annotate-partitions.py` into one script. This is convenient
    but should probably not be used for large data sets, because
    :program:`do-partition.py` doesn't provide save/resume functionality.

    Example::

        do-partition.py -k 20 example tests/test-data/random-20-a.fa
    """
    parser = build_nodegraph_args(
        descr='Load, partition, and annotate FAST[AQ] sequences',
        epilog=textwrap.dedent(epilog))
    add_threading_args(parser)
    parser.add_argument('--subset-size', '-s', default=DEFAULT_SUBSET_SIZE,
                        dest='subset_size', type=float,
                        help='Set subset size (usually 1e5-1e6 is good)')
    parser.add_argument('--no-big-traverse', dest='no_big_traverse',
                        action='store_true', default=False,
                        help='Truncate graph joins at big traversals')
    parser.add_argument('--keep-subsets', dest='keep_subsets',
                        default=False, action='store_true',
                        help='Keep individual subsets')
    parser.add_argument('graphbase', help="base name for output files")
    parser.add_argument('input_filenames', metavar='input_sequence_filename',
                        nargs='+', help='input FAST[AQ] sequence filenames')
    parser.add_argument('-f', '--force', default=False, action='store_true',
                        help='Overwrite output file if it exists')
    return parser


def main(argv=None, device=None):  # pylint: disable=too-many-locals
    args = sanitize_help(get_parser()).parse_args(argv)

    report_on_config(args, graphtype='nodegraph')

    for infile in args.input_filenames:
        check_input_files(infile, args.force)

    check_space(args.input_filenames, args.force)

    print('Saving k-mer nodegraph to %s' %
          args.graphbase, file=sys.stderr)
    print('Loading kmers from sequences in %s' %
          repr(args.input_filenames), file=sys.stderr)
    print('--', file=sys.stderr)
    print('SUBSET SIZE', args.subset_size, file=sys.stderr)
    print('N THREADS', args.threads, file=sys.stderr)
    print('--', file=sys.stderr)

    # load-graph.py
    print('making nodegraph', file=sys.stderr)
    nodegraph = khmer_args.create_nodegraph(args, device=device)

    for filename in args.input_filenames:
        print('consuming input', filename, file=sys.stderr)
        nodegraph.consume_seqfile_and_tag(filename)

    # 0.18 is ACTUAL MAX. Do not change.
    fp_rate = khmer.calc_expected_collisions(
        nodegraph, args.force, max_false_pos=.15)
    print('fp rate estimated to be %1.3f' % fp_rate, file=sys.stderr)

    # partition-graph
    stop_big_traversals = args.no_big_traverse
    if stop_big_traversals:
        print('** This script brakes for lumps: ',
              'stop_big_traversals is true.', file=sys.stderr)
    else:
        print('** Traverse all the things:',
              ' stop_big_traversals is false.', file=sys.stderr)

    divvy = list(nodegraph.divide_tags_into_subsets(int(args.subset_size)))
    n_subsets = len(divvy)
    divvy.append(0)

    print('enqueued %d subset tasks' % n_subsets, file=sys.stderr)
    with open('%s.info' % args.graphbase, 'w') as info_fp:
        info_fp.write('%d subsets total\n' % (n_subsets))

    for i in range(n_subsets):
        start, end = divvy[i], divvy[i + 1]
        subset = nodegraph.do_subset_partition(
            start, end, stop_big_traversals=stop_big_traversals)
        outfile = '%s.subset.%d.pmap' % (args.graphbase, i)
        subset.save_partitionmap(outfile)

    print('---', file=sys.stderr)
    print('done making subsets! see %s.subset.*.pmap' %
          (args.graphbase,), file=sys.stderr)

    # merge-partitions
    pmap_files = glob.glob(args.graphbase + '.subset.*.pmap')

    print('loading %d pmap files (first one: %s)' %
          (len(pmap_files), pmap_files[0]), file=sys.stderr)

    nodegraph = Nodegraph(args.ksize, 1, 1, device=device)

    for pmap_file in pmap_files:
        print('merging', pmap_file, file=sys.stderr)
        nodegraph.merge_subset_from_disk(pmap_file)

    if not args.keep_subsets:
        print('removing pmap files', file=sys.stderr)
        for pmap_file in pmap_files:
            os.unlink(pmap_file)

    # annotate-partitions
    for infile in args.input_filenames:
        print('outputting partitions for', infile, file=sys.stderr)
        outfile = os.path.basename(infile) + '.part'
        part_count = nodegraph.output_partitions(infile, outfile)
        print('output %d partitions for %s' % (
            part_count, infile), file=sys.stderr)
        print('partitions are in', outfile, file=sys.stderr)


if __name__ == '__main__':
    main()
