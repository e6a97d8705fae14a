# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Merge multiple pmap files into a single one.

% merge-partitions.py <base>

Load <base>.subset.*.pmap and merge into a single pmap file.  Final
merged pmap file will be in <base>.pmap.merged.

PyTorch/CUDA port of scripts/merge-partitions.py (the same flags and
output bytes).  Run as ``python -m khmer_tpu_torch.scripts.merge_partitions``.
"""

import glob
import os
import sys
import textwrap

from khmer_tpu_torch import Nodegraph
from khmer_tpu_torch.khmer_args import KhmerArgumentParser, sanitize_help
from khmer_tpu_torch.kfile import check_input_files, check_space

DEFAULT_K = 32


def get_parser():
    epilog = """\
    Take the ``${graphbase}.subset.#.pmap`` files and merge them all into a
    single ``${graphbase}.pmap.merged`` file for
    :program:`annotate-partitions.py` to use.
    """
    parser = KhmerArgumentParser(
        description="Merge partition map '.pmap' files.",
        epilog=textwrap.dedent(epilog),
        citations=['graph'])
    parser.add_argument('-k', '--ksize', type=int, default=DEFAULT_K,
                        help="k-mer size (default: %d)" % DEFAULT_K)
    parser.add_argument('--keep-subsets', dest='remove_subsets',
                        default=True, action='store_false',
                        help='Keep individual subsets (default: False)')
    parser.add_argument('graphbase', help='basename for input and output '
                        'files')
    parser.add_argument('-f', '--force', default=False, action='store_true',
                        help='Overwrite output file if it exists')
    return parser


def main(argv=None, device=None):
    args = sanitize_help(get_parser()).parse_args(argv)

    output_file = args.graphbase + '.pmap.merged'
    pmap_files = glob.glob(args.graphbase + '.subset.*.pmap')

    print('loading %d pmap files (first one: %s)' %
          (len(pmap_files), pmap_files[0]), file=sys.stderr)

    nodegraph = Nodegraph(args.ksize, 1, 1, device=device)

    for pfile in pmap_files:
        check_input_files(pfile, args.force)

    check_space(pmap_files, args.force)

    for pmap_file in pmap_files:
        print('merging', pmap_file, file=sys.stderr)
        nodegraph.merge_subset_from_disk(pmap_file)

    print('saving merged to', output_file, file=sys.stderr)
    nodegraph.save_partitionmap(output_file)

    if args.remove_subsets:
        print('removing pmap files', file=sys.stderr)
        for pmap_file in pmap_files:
            os.unlink(pmap_file)


if __name__ == '__main__':
    main()
