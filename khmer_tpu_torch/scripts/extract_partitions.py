# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Separate partition-annotated sequences into group files.

% extract-partitions.py <base> <file1.part> [ <file2.part> ... ]

Grouped sequences will be in <base>.groupN.fa (or .fq) files; the
partition size distribution goes to <base>.dist with columns
(1) number of reads, (2) count of partitions with n reads,
(3) cumulative sum of partitions, (4) cumulative sum of reads.

PyTorch/CUDA port of scripts/extract-partitions.py (the same flags and
output bytes); host only.  Run as
``python -m khmer_tpu_torch.scripts.extract_partitions``.
"""

import sys
import textwrap

from khmer_tpu_torch._config import resolve_device
from khmer_tpu_torch.io.fastx import screed_open
from khmer_tpu_torch.kfile import (add_output_compression_type,
                                   check_input_files, check_space,
                                   get_file_writer)
from khmer_tpu_torch.khmer_args import KhmerArgumentParser, sanitize_help
from khmer_tpu_torch.utils import write_record

DEFAULT_MAX_SIZE = int(1e6)
DEFAULT_THRESHOLD = 5


def get_parser():
    epilog = """
    Example (results will be in ``example.group0000.fa``)::

        load-graph.py -k 20 example tests/test-data/random-20-a.fa
        partition-graph.py example
        merge-partitions.py -k 20 example
        annotate-partitions.py -k 20 example tests/test-data/random-20-a.fa
        extract-partitions.py example random-20-a.fa.part
    """
    parser = KhmerArgumentParser(
        description="Separate sequences that are annotated with partitions "
        "into grouped files.", epilog=textwrap.dedent(epilog),
        citations=['graph'])
    parser.add_argument('prefix', metavar='output_filename_prefix')
    parser.add_argument('part_filenames', metavar='input_partition_filename',
                        nargs='+')
    parser.add_argument('-X', '--max-size', dest='max_size',
                        default=DEFAULT_MAX_SIZE, type=int,
                        help='Max group size (n sequences)')
    parser.add_argument('-m', '--min-partition-size', dest='min_part_size',
                        default=DEFAULT_THRESHOLD, type=int,
                        help='Minimum partition size worth keeping')
    parser.add_argument('-n', '--no-output-groups', dest='output_groups',
                        default=True, action='store_false',
                        help='Do not actually output groups files.')
    parser.add_argument('-U', '--output-unassigned', default=False,
                        action='store_true',
                        help='Output unassigned sequences, too')
    parser.add_argument('-f', '--force', default=False, action='store_true',
                        help='Overwrite output file if it exists')
    add_output_compression_type(parser)
    return parser


def partitioned_reads(filenames):
    for filename in filenames:
        for read in screed_open(filename):
            _, pid = read.name.rsplit('\t', 1)
            yield read, int(pid)


def main(argv=None, device=None):
    """Nothing here runs on `device`; like every entry point, the script
    refuses to start without a CUDA device unless given device="cpu"."""
    resolve_device(device)
    args = sanitize_help(get_parser()).parse_args(argv)
    distfilename = args.prefix + '.dist'

    for infile in args.part_filenames:
        check_input_files(infile, args.force)
    check_space(args.part_filenames, args.force)

    print('---', file=sys.stderr)
    print('reading partitioned files:', repr(args.part_filenames),
          file=sys.stderr)
    if args.output_groups:
        print('outputting to files named "%s.groupN.fa"' % args.prefix,
              file=sys.stderr)
        print('min reads to keep a partition:', args.min_part_size,
              file=sys.stderr)
        print('max size of a group file:', args.max_size, file=sys.stderr)
    else:
        print('NOT outputting groups! Beware!', file=sys.stderr)
    if args.output_unassigned:
        print('outputting unassigned reads to "%s.unassigned.fa"' %
              args.prefix, file=sys.stderr)
    print('partition size distribution will go to %s' % distfilename,
          file=sys.stderr)
    print('---', file=sys.stderr)

    # sniff the format, validating every input is the same kind
    # (reference extract-partitions.py:282-291)
    is_fastq = None
    for read, _ in partitioned_reads(args.part_filenames):
        if is_fastq is None:
            is_fastq = getattr(read, 'quality', None) is not None
        else:
            assert (getattr(read, 'quality', None) is not None) \
                == is_fastq, \
                "Input files must have consistent format."
    suffix = 'fq' if is_fastq else 'fa'

    # pass 1: counts per partition (+ optional unassigned output)
    count = {}
    n_unassigned = 0
    unassigned_fp = None
    if args.output_unassigned:
        ofile = open('%s.unassigned.%s' % (args.prefix, suffix), 'wb')
        unassigned_fp = get_file_writer(ofile, args.gzip, args.bzip)
    for read, pid in partitioned_reads(args.part_filenames):
        count[pid] = count.get(pid, 0) + 1
        if pid == 0:
            n_unassigned += 1
            if unassigned_fp:
                write_record(read, unassigned_fp)
    if unassigned_fp:
        unassigned_fp.close()

    # histogram
    dist = {}
    for _, size in count.items():
        dist[size] = dist.get(size, 0) + 1
    with open(distfilename, 'w') as distfp:
        total = 0
        wtotal = 0
        for size, n_parts in sorted(dist.items()):
            total += n_parts
            wtotal += size * n_parts
            distfp.write('%d %d %d %d\n' % (size, n_parts, total, wtotal))

    if not args.output_groups:
        return

    # group assignment: sort partitions by size, pack up to max_size
    count.pop(0, None)
    divvy = sorted(count.items(), key=lambda y: y[1])
    divvy = [y for y in divvy if y[1] > args.min_part_size]

    group_d = {}
    group_n = 0
    group = set()
    total = 0
    for pid, n_reads in divvy:
        group.add(pid)
        total += n_reads
        if total > args.max_size:
            for p in group:
                group_d[p] = group_n
            group_n += 1
            group = set()
            total = 0
    if group:
        for p in group:
            group_d[p] = group_n
        group_n += 1

    print('%d groups' % group_n, file=sys.stderr)
    if group_n == 0:
        print('nothing to output; exiting!', file=sys.stderr)
        return

    group_fps = {}
    for index in range(group_n):
        fname = '%s.group%04d.%s' % (args.prefix, index, suffix)
        group_fps[index] = get_file_writer(open(fname, 'wb'), args.gzip,
                                           args.bzip)

    total_seqs = 0
    part_seqs = 0
    toosmall_parts = 0
    for read, pid in partitioned_reads(args.part_filenames):
        total_seqs += 1
        if pid == 0:
            continue
        if pid not in group_d:
            toosmall_parts += 1
            continue
        write_record(read, group_fps[group_d[pid]])
        part_seqs += 1
    for fp in group_fps.values():
        fp.close()

    print('---', file=sys.stderr)
    print('Of %d total seqs,' % total_seqs, file=sys.stderr)
    print('extracted %d partitioned seqs into group files,' % part_seqs,
          file=sys.stderr)
    print('discarded %d sequences from small partitions (see -m),' %
          toosmall_parts, file=sys.stderr)
    print('and found %d unpartitioned sequences (see -U).' % n_unassigned,
          file=sys.stderr)
    print('', file=sys.stderr)
    print('Created %d group files named %s.groupXXXX.%s' %
          (len(group_fps), args.prefix, suffix), file=sys.stderr)


if __name__ == '__main__':
    main()
