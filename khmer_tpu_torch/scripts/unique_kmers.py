# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Estimate number of unique k-mers, with precision <= ERROR_RATE.

% python scripts/unique-kmers.py [ -k <k size> ] [ -e <ERROR_RATE> ] <data1>
<data2> ...

PyTorch/CUDA port of scripts/unique-kmers.py (same flags, stderr lines
and report bytes): the HyperLogLog register update of every chunk of
bases is kernel K9.  Run as ``python -m khmer_tpu_torch.scripts.unique_kmers``.
"""

import argparse
import os
import sys
import textwrap

import khmer_tpu_torch as khmer
from khmer_tpu_torch.khmer_args import (DEFAULT_K, KhmerArgumentParser,
                                        graphsize_args_report, sanitize_help)


def get_parser():
    descr = "Estimate number of unique k-mers, with precision <= ERROR_RATE."
    epilog = """\
    A HyperLogLog counter is used to do cardinality estimation.

    Example::

        unique-kmers.py -k 17 tests/test-data/test-abund-read{,-2,-3}.fa
    """
    parser = KhmerArgumentParser(
        description=descr, epilog=textwrap.dedent(epilog),
        citations=['SeqAn', 'hll'])

    env_ksize = os.environ.get('KHMER_KSIZE', DEFAULT_K)

    parser.add_argument('-q', '--quiet', dest='quiet', default=False,
                        action='store_true')
    parser.add_argument('-k', '--ksize', type=int, default=env_ksize,
                        help='k-mer size to use')
    parser.add_argument('-e', '--error-rate', type=float, default=0.01,
                        help='Acceptable error rate')
    parser.add_argument('-R', '--report',
                        metavar='filename', type=argparse.FileType('w'),
                        help='generate informational report and write to'
                        ' filename')
    parser.add_argument('-S', '--stream-records', default=False,
                        action='store_true',
                        help='write input sequences to STDOUT')
    parser.add_argument('--diagnostics', default=False, action='store_true',
                        help='print out recommended tablesize arguments '
                        'and restrictions')
    parser.add_argument('input_filenames', metavar='input_sequence_filename',
                        help='Input FAST[AQ] sequence filename(s).',
                        nargs='+')
    return parser


def main(argv=None, device=None):
    args = sanitize_help(get_parser()).parse_args(argv)

    total_hll = khmer.HLLCounter(args.error_rate, args.ksize, device=device)

    report_fp = args.report
    input_filename = None
    for input_filename in args.input_filenames:
        hllcpp = khmer.HLLCounter(args.error_rate, args.ksize,
                                  device=device)
        hllcpp.consume_seqfile(input_filename,
                               stream_records=args.stream_records)

        cardinality = hllcpp.estimate_cardinality()
        print('Estimated number of unique {0}-mers in {1}: {2}'.format(
            args.ksize, input_filename, cardinality), file=sys.stderr)

        if report_fp:
            print(cardinality, args.ksize, '(total)', file=report_fp)
            report_fp.flush()
        total_hll.merge(hllcpp)

    cardinality = total_hll.estimate_cardinality()
    print('Total estimated number of unique {0}-mers: {1}'.format(
        args.ksize, cardinality), file=sys.stderr)

    to_print = graphsize_args_report(cardinality, args.error_rate)
    if args.diagnostics:
        print(to_print, file=sys.stderr)

    if report_fp:
        print(cardinality, args.ksize, 'total', file=report_fp)
        print(to_print, file=report_fp)
        report_fp.flush()


if __name__ == "__main__":
    main()
