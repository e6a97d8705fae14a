# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Find highly-connected k-mers and output them in a .stoptags file.

% find-knots.py <base>

Load a k-mer nodegraph/tagset pair created by load-graph.py, and a set
of pmap files created by partition-graph.py.  Go through each pmap
file, select the largest partition in each, and traverse from each of
its waypoints to identify Highly Connected Kmers; output them to
<graphbase>.stoptags after each pmap file.

PyTorch/CUDA port of scripts/find-knots.py: the same flags and output
bytes; the nodegraph and the counting table live on `device` (CUDA
unless told otherwise).  Run as
``python -m khmer_tpu_torch.scripts.find_knots``.
"""

import glob
import os
import sys
import textwrap

from khmer_tpu_torch import Nodegraph, khmer_args
from khmer_tpu_torch.khmer_args import build_counting_args, sanitize_help
from khmer_tpu_torch.kfile import check_input_files, check_space
from khmer_tpu_torch.partitioning import SubsetPartition

DEFAULT_COUNTING_HT_SIZE = 3e6                # number of bytes
DEFAULT_COUNTING_HT_N = 4                     # number of counting tables

EXCURSION_DISTANCE = 40
EXCURSION_KMER_THRESHOLD = 200
EXCURSION_KMER_COUNT_THRESHOLD = 2


def get_parser():
    epilog = """\
    Load an k-mer nodegraph/tagset pair created by
    :program:`load-graph.py`, and a set of pmap files created by
    :program:`partition-graph.py`. Go through each pmap file, select the
    largest partition in each, and do the same kind of traversal as in
    :program:`make-initial-stoptags.py` from each of the waypoints in
    that partition; this should identify all of the Highly Connected
    Kmers in that partition. These HCKs are output to
    ``<graphbase>.stoptags`` after each pmap file.
    """
    parser = build_counting_args(
        descr="Find all highly connected k-mers.",
        epilog=textwrap.dedent(epilog),
        citations=['graph'])
    parser.set_defaults(max_tablesize=DEFAULT_COUNTING_HT_SIZE,
                        n_tables=DEFAULT_COUNTING_HT_N)
    parser.add_argument('graphbase', help='Basename for the input and '
                        'output files.')
    parser.add_argument('-f', '--force', default=False, action='store_true',
                        help='Continue past warnings')
    return parser


def main(argv=None, device=None):
    args = sanitize_help(get_parser()).parse_args(argv)

    graphbase = args.graphbase

    infiles = [graphbase, graphbase + '.tagset']
    if os.path.exists(graphbase + '.stoptags'):
        infiles.append(graphbase + '.stoptags')
    for fname in infiles:
        check_input_files(fname, args.force)

    check_space(infiles, args.force)

    print('loading k-mer nodegraph %s' % graphbase, file=sys.stderr)
    graph = Nodegraph.load(graphbase, device=device)

    print('loading tagset %s.tagset...' % graphbase, file=sys.stderr)
    graph.load_tagset(graphbase + '.tagset')

    initial_stoptags = False
    if os.path.exists(graphbase + '.stoptags'):
        print('loading stoptags %s.stoptags' % graphbase, file=sys.stderr)
        graph.load_stop_tags(graphbase + '.stoptags')
        initial_stoptags = True

    pmap_files = glob.glob(args.graphbase + '.subset.*.pmap')

    print('loading %d pmap files (first one: %s)' %
          (len(pmap_files), pmap_files[0]), file=sys.stderr)
    print('---', file=sys.stderr)
    print('output stoptags will be in',
          graphbase + '.stoptags', file=sys.stderr)
    if initial_stoptags:
        print(
            '(these output stoptags will include the already-loaded set)',
            file=sys.stderr)
    print('---', file=sys.stderr)

    # create countgraph
    ksize = graph.ksize()
    counting = khmer_args.create_countgraph(args, ksize=ksize,
                                            device=device)

    # load & merge
    for index, subset_file in enumerate(pmap_files):
        print('<-', subset_file, file=sys.stderr)
        subset = SubsetPartition.load(subset_file, graph)

        print('** repartitioning subset... %s' % subset_file,
              file=sys.stderr)
        graph.repartition_largest_partition(counting,
                                            EXCURSION_DISTANCE,
                                            EXCURSION_KMER_THRESHOLD,
                                            EXCURSION_KMER_COUNT_THRESHOLD,
                                            subs=subset)

        print('** merging subset... %s' % subset_file, file=sys.stderr)
        graph.merge_subset(subset)

        print('** repartitioning, round 2... %s' %
              subset_file, file=sys.stderr)
        size = graph.repartition_largest_partition(
            counting, EXCURSION_DISTANCE, EXCURSION_KMER_THRESHOLD,
            EXCURSION_KMER_COUNT_THRESHOLD)

        print('** repartitioned size:', size, file=sys.stderr)

        print('saving stoptags binary', file=sys.stderr)
        graph.save_stop_tags(graphbase + '.stoptags')
        os.rename(subset_file, subset_file + '.processed')
        print('(%d of %d)\n' % (index, len(pmap_files)), file=sys.stderr)

    print('done!', file=sys.stderr)


if __name__ == '__main__':
    main()
