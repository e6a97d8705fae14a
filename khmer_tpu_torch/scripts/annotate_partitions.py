# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Annotate sequences with partition numbers.

% annotate-partitions.py <pmap_file> <file1> [ <file2> ... ]

Partition-annotated sequences will be in <fileN>.part.

PyTorch/CUDA port of scripts/annotate-partitions.py (the same flags and
output bytes); the reads' k-mers are hashed on `device` (kernel K1).
Run as ``python -m khmer_tpu_torch.scripts.annotate_partitions``.
"""

import os
import sys
import textwrap

from khmer_tpu_torch import Nodegraph
from khmer_tpu_torch.khmer_args import KhmerArgumentParser, sanitize_help
from khmer_tpu_torch.kfile import check_input_files, check_space

DEFAULT_K = 32


def get_parser():
    epilog = """\
    Load in a partitionmap (generally produced by
    :program:`partition-graph.py` or :program:`merge-partitions.py`) and
    annotate the sequences in the given files with their partition IDs.
    Use :program:`extract-partitions.py` to extract sequences into
    separate group files.
    """
    parser = KhmerArgumentParser(
        description="Annotate sequences with partition IDs.",
        epilog=textwrap.dedent(epilog))
    parser.add_argument('-k', '--ksize', type=int, default=DEFAULT_K,
                        help="k-mer size (default: %d)" % DEFAULT_K)
    parser.add_argument('graphbase', help='basename for input and output '
                        'files')
    parser.add_argument('input_filenames', metavar='input_sequence_filename',
                        nargs='+', help='input FAST[AQ] sequences to '
                        'annotate.')
    parser.add_argument('-f', '--force', default=False, action='store_true',
                        help='Overwrite output file if it exists')
    return parser


def main(argv=None, device=None):
    args = sanitize_help(get_parser()).parse_args(argv)

    ksize = args.ksize
    filenames = args.input_filenames
    nodegraph = Nodegraph(ksize, 1, 1, device=device)

    partitionmap_file = args.graphbase + '.pmap.merged'

    check_input_files(partitionmap_file, args.force)
    for fname in filenames:
        check_input_files(fname, args.force)

    check_space(filenames, args.force)

    print('loading partition map from:', partitionmap_file, file=sys.stderr)
    nodegraph.load_partitionmap(partitionmap_file)

    for infile in filenames:
        print('outputting partitions for', infile, file=sys.stderr)
        outfile = os.path.basename(infile) + '.part'
        part_count = nodegraph.output_partitions(infile, outfile)
        print('output %d partitions for %s' % (
            part_count, infile), file=sys.stderr)
        print('partitions are in', outfile, file=sys.stderr)


if __name__ == '__main__':
    main()
