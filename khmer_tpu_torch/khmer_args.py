# Derived in part from khmer (https://github.com/dib-lab/khmer/),
# Copyright (C) 2010-2015 Michigan State University,
# Copyright (C) 2015-2016 The Regents of the University of California;
# BSD 3-clause — full license text: LICENSE.third-party at repo root.
"""Common argparse constructs + the memory->table-geometry solver.

The part of khmer_tpu/khmer_args.py that the ported scripts use
(parity: reference khmer/khmer_args.py).  The table constructors take
the device the tables live on.
"""

import argparse
import math
import sys
import textwrap
from argparse import _VersionAction
from collections import namedtuple

import khmer_tpu_torch as khmer
from khmer_tpu_torch import __version__, extract_countgraph_info
from khmer_tpu_torch.khmer_logger import (configure_logging, log_error,
                                          log_info, log_warn)


def print_error(msg):
    print(msg, file=sys.stderr)

DEFAULT_K = 32
DEFAULT_N_TABLES = 4
DEFAULT_MAX_TABLESIZE = 1e6
DEFAULT_N_THREADS = 1

ALGORITHMS = {
    'software': 'MR Crusoe et al., '
                '2015. https://doi.org/10.12688/f1000research.6924.1',
    'diginorm': 'CT Brown et al., arXiv:1203.4802 [q-bio.GN]',
    'streaming': 'Q Zhang, S Awad, CT Brown, '
                 'https://doi.org/10.7287/peerj.preprints.890v1',
    'graph': 'J Pell et al., https://doi.org/10.1073/pnas.1121464109',
    'counting': 'Q Zhang et al., '
                'https://doi.org/10.1371/journal.pone.0101271',
    'sweep': 'C Scott, MR Crusoe, and CT Brown, unpublished',
    'SeqAn': 'A. Döring et al. https://doi.org:80/10.1186/1471-2105-9-11',
    'hll': 'Irber and Brown. https://doi.org/10.1101/056846',
}


class CitationAction(argparse.Action):
    """Print citation info and exit."""

    def __init__(self, *args, **kwargs):
        self.citations = kwargs.pop('citations')
        super().__init__(*args, nargs=0, default=argparse.SUPPRESS, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        info(parser.prog, self.citations)
        parser.exit()


class _HelpAction(argparse._HelpAction):
    def __call__(self, parser, namespace, values, option_string=None):
        info(parser.prog, parser._citations)
        super().__call__(parser, namespace, values,
                         option_string=option_string)


class _VersionStdErrAction(_VersionAction):
    def __call__(self, parser, namespace, values, option_string=None):
        info(parser.prog, parser._citations)
        version = self.version
        if version is None:
            version = parser.version
        formatter = parser._get_formatter()
        formatter.add_text(version)
        parser._print_message(formatter.format_help(), sys.stderr)
        parser.exit()


class ComboFormatter(argparse.ArgumentDefaultsHelpFormatter,
                     argparse.RawDescriptionHelpFormatter):
    pass


class KhmerArgumentParser(argparse.ArgumentParser):
    """ArgumentParser with khmer's common --version/--info/--help."""

    def __init__(self, citations=None, formatter_class=ComboFormatter,
                 **kwargs):
        super().__init__(formatter_class=formatter_class, add_help=False,
                         **kwargs)
        self._citations = citations
        self.add_argument('--version', action=_VersionStdErrAction,
                          version='khmer {v}'.format(v=__version__))
        self.add_argument('--info', action=CitationAction,
                          help='print citation information',
                          citations=self._citations)
        self.add_argument('-h', '--help', action=_HelpAction,
                          default=argparse.SUPPRESS,
                          help='show this help message and exit')

    def parse_args(self, args=None, namespace=None):
        args = super().parse_args(args=args, namespace=namespace)
        if 'quiet' not in args or not args.quiet:
            info(self.prog, self._citations)
        return args


class FileType(argparse.FileType):
    """argparse.FileType honoring '-' as raw stdin/stdout fd."""

    def __call__(self, fname):
        if fname == '-':
            if 'r' in self._mode:
                fname = sys.stdin.fileno()
            elif 'w' in self._mode:
                fname = sys.stdout.fileno()
        return super().__call__(fname)


def memory_setting(label):
    """Parse '16G'/'1e9'/'1000' into a float byte count
    (khmer_args.py:178-206)."""
    suffixes = {
        'K': 1000.0,
        'M': 1000.0 ** 2,
        'G': 1000.0 ** 3,
        'T': 1000.0 ** 4,
    }
    try:
        return float(label)
    except ValueError:
        pass
    prefix = label[:-1]
    suffix = label[-1:].upper()
    if suffix not in suffixes:
        raise ValueError('cannot parse memory setting "{}"'.format(label))
    try:
        return float(prefix) * suffixes[suffix]
    except ValueError:
        raise ValueError('cannot parse memory setting "{}"'.format(label))


# ---------------------------------------------------------------------------
# memory -> geometry solver
# ---------------------------------------------------------------------------

_SolverResult = namedtuple(
    "result", ["num_htables", "htable_size", "mem_use", "fp_rate"])


def estimate_optimal_with_K_and_M(num_kmers, mem_cap):
    """Best (n_tables, tablesize) under a memory cap
    (khmer_args.py:295-312)."""
    n_tables = math.log(2) * (mem_cap / float(num_kmers))
    int_n_tables = int(n_tables)
    if int_n_tables == 0:
        int_n_tables = 1
    ht_size = int(mem_cap / int_n_tables)
    mem_cap = ht_size * int_n_tables
    fp_rate = (1 - math.exp(-num_kmers / float(ht_size))) ** int_n_tables
    return _SolverResult(int_n_tables, ht_size, mem_cap, fp_rate)


def estimate_optimal_with_K_and_f(num_kmers, des_fp_rate):
    """Smallest memory achieving a target FP rate
    (khmer_args.py:315-334)."""
    n_tables = math.log(des_fp_rate, 0.5)
    int_n_tables = int(n_tables)
    if int_n_tables == 0:
        int_n_tables = 1
    ht_size = int(-num_kmers / (
        math.log(1 - des_fp_rate ** (1 / float(int_n_tables)))))
    mem_cap = ht_size * int_n_tables
    fp_rate = (1 - math.exp(-num_kmers / float(ht_size))) ** int_n_tables
    return _SolverResult(int_n_tables, ht_size, mem_cap, fp_rate)


def optimal_size(num_kmers, mem_cap=None, fp_rate=None):
    """Pick solver variant by which constraint was given
    (khmer_args.py:208-223)."""
    if num_kmers is not None and mem_cap is not None and fp_rate is None:
        return estimate_optimal_with_K_and_M(num_kmers, mem_cap)
    if num_kmers is not None and mem_cap is None and fp_rate is not None:
        return estimate_optimal_with_K_and_f(num_kmers, fp_rate)
    raise TypeError("num_kmers and either mem_cap or fp_rate"
                    " must be defined.")


def graphsize_args_report(unique_kmers, fp_rate):
    """Tabulate suggested geometries (khmer_args.py:336-376)."""
    to_print = ['']
    to_print.append('number of unique k-mers: \t{0}'.format(unique_kmers))
    to_print.append('false positive rate: \t{:>.3f}'.format(fp_rate))
    to_print.append('')
    to_print.append('If you have expected false positive rate to achieve:')
    to_print.append('expected_fp\tnumber_hashtable(Z)\tsize_hashtable(H)\t'
                    'expected_memory_usage')
    for fp in range(1, 10):
        num_tables, table_size, mem_cap, fp = \
            optimal_size(unique_kmers, fp_rate=fp / 10.0)
        to_print.append('{:11.3f}\t{:19}\t{:17e}\t{:21e}'.format(
            fp, num_tables, table_size, mem_cap))
    mem_list = [1, 5, 10, 20, 50, 100, 200, 300, 400, 500, 1000, 2000, 5000]
    to_print.append('')
    to_print.append('If you have expected memory to use:')
    to_print.append('expected_memory_usage\tnumber_hashtable(Z)\t'
                    'size_hashtable(H)\texpected_fp')
    for mem in mem_list:
        num_tables, table_size, mem_cap, fp = \
            optimal_size(unique_kmers, mem_cap=mem * 1000000000)
        to_print.append('{:21e}\t{:19}\t{:17e}\t{:11.3f}'.format(
            mem_cap, num_tables, table_size, fp))
    return "\n".join(to_print)


def _check_fp_rate(args, desired_max_fp):
    """Validate/derive memory settings from -U/-M/--fp-rate
    (khmer_args.py:378-436)."""
    if not args.unique_kmers:
        return args

    if args.fp_rate:
        log_info("*** INFO: Overriding default fp {def_fp} with new fp:"
                 " {new_fp}", def_fp=desired_max_fp, new_fp=args.fp_rate)
        desired_max_fp = args.fp_rate

    if args.max_memory_usage:
        res = estimate_optimal_with_K_and_M(args.unique_kmers,
                                            args.max_memory_usage)
        if res.fp_rate > desired_max_fp:
            print("""
*** ERROR: The given restrictions yield an estimate false positive rate of {0},
*** which is above the recommended false positive ceiling of {1}!"""
                  .format(res.fp_rate, desired_max_fp), file=sys.stderr)
            if not getattr(args, 'force', False):
                print("NOTE: This can be overridden using the --force"
                      " argument", file=sys.stderr)
                print("*** Aborting...!", file=sys.stderr)
                sys.exit(1)
    else:
        res = estimate_optimal_with_K_and_f(args.unique_kmers,
                                            desired_max_fp)
        if args.max_tablesize and args.max_tablesize < res.htable_size:
            log_warn("\n*** Warning: The given tablesize is too small!")
            log_warn("*** Recommended tablesize is: {tsize:5g} bytes",
                     tsize=res.htable_size)
            log_warn("*** Current is: {tsize:5g} bytes",
                     tsize=args.max_tablesize)
            res = estimate_optimal_with_K_and_M(args.unique_kmers,
                                                args.max_tablesize)
            log_warn("*** Estimated FP rate with current config is: {fp}\n",
                     fp=res.fp_rate)
        else:
            if res.mem_use < 1e6:  # one megabyteish
                args.max_memory_usage = 1e6
            else:
                args.max_memory_usage = res.mem_use
            log_info("*** INFO: set memory ceiling automatically.")
            log_info("*** Ceiling is: {ceil:3g} bytes\n",
                     ceil=float(args.max_memory_usage))
            args.max_mem = res.mem_use
    return args


def check_conflicting_args(args, hashtype):
    """Warn/override table args when --loadgraph is given
    (khmer_args.py:226-277)."""
    if getattr(args, "quiet", None):
        configure_logging(args.quiet)

    loadgraph_table_conflicts = {"ksize": DEFAULT_K,
                                 "n_tables": DEFAULT_N_TABLES,
                                 "max_tablesize": DEFAULT_MAX_TABLESIZE}
    loadgraph_autoarg_conflicts = ("unique_kmers", "max_memory_usage")

    if getattr(args, "loadgraph", None):
        if getattr(args, "hash_function", 'twobit-exact') != 'twobit-exact':
            log_error('ERROR: cannot load different hash functions yet.')
            sys.exit(1)

        for key, value in loadgraph_table_conflicts.items():
            if getattr(args, key, value) != value:
                log_warn('''
*** WARNING: You are loading a saved k-mer countgraph from
*** {hashfile}, but have set k-mer table parameters.
*** Your values for ksize, n_tables, and tablesize
*** will be ignored.'''.format(hashfile=args.loadgraph))
                break

        for element in loadgraph_autoarg_conflicts:
            if getattr(args, element, None):
                log_warn("\n*** WARNING: You have asked that the graph size "
                         "be automatically calculated\n"
                         "*** (by using -U or -M).\n"
                         "*** But you are loading an existing graph!\n"
                         "*** Size will NOT be set automatically.")
                break

        infoset = None
        if hashtype in ('countgraph', 'smallcountgraph'):
            infoset = extract_countgraph_info(args.loadgraph)
        if infoset is not None:
            args.ksize = infoset.ksize
            args.n_tables = infoset.n_tables
            args.max_tablesize = infoset.table_size
            if infoset.ht_type == khmer.FILETYPES['SMALLCOUNT']:
                args.small_count = True


def check_argument_range(low, high, parameter_name):
    """argparse type factory enforcing low <= value < high."""

    def _in_range(value):
        value = int(value)
        if not low <= value < high:
            print_error("\n** ERROR: khmer only supports "
                        "%i <= %s < %i.\n" % (low, parameter_name, high))
            sys.exit(1)
        return value

    return _in_range


# ---------------------------------------------------------------------------
# parser builders
# ---------------------------------------------------------------------------


def build_graph_args(descr=None, epilog=None, parser=None, citations=None):
    """Shared args for Bloom-filter-based scripts (khmer_args.py:438-475)."""
    expert_help = '--help-expert' in sys.argv
    if expert_help:
        sys.argv.append('--help')

    if parser is None:
        parser = KhmerArgumentParser(description=descr, epilog=epilog,
                                     citations=citations)

    parser.add_argument('-k', '--ksize', type=int, default=DEFAULT_K,
                        help='k-mer size to use')
    help_ = ('number of tables to use in k-mer countgraph' if expert_help
             else argparse.SUPPRESS)
    parser.add_argument('--n_tables', '-N', type=int,
                        default=DEFAULT_N_TABLES, help=help_)
    parser.add_argument('-U', '--unique-kmers', type=float, default=0,
                        help='approximate number of unique kmers in the '
                             'input set')
    parser.add_argument('--fp-rate', type=float, default=None,
                        help="Override the automatic FP rate setting for "
                             "the current script")

    group = parser.add_mutually_exclusive_group()
    help_ = ('upper bound on tablesize to use; overrides '
             '--max-memory-usage/-M' if expert_help else argparse.SUPPRESS)
    group.add_argument('--max-tablesize', '-x', type=float,
                       default=DEFAULT_MAX_TABLESIZE, help=help_)
    group.add_argument('-M', '--max-memory-usage', type=memory_setting,
                       help='maximum amount of memory to use for data '
                            'structure')
    return parser


def build_counting_args(descr=None, epilog=None, citations=None):
    """Shared args for countgraph-based scripts (khmer_args.py:477-490)."""
    parser = build_graph_args(descr=descr, epilog=epilog,
                              citations=citations)
    parser.add_argument('--small-count', default=False, action='store_true',
                        help='Reduce memory usage by using a smaller counter'
                             ' for individual kmers.')
    parser.add_argument('-H', '--hash-function', type=str,
                        default='twobit-exact',
                        help='choose hash function to use: twobit-exact, '
                             'murmur')
    return parser


def build_nodegraph_args(descr=None, epilog=None, parser=None,
                         citations=None):
    """Shared args for nodegraph-based scripts (khmer_args.py:399-402)."""
    return build_graph_args(descr=descr, epilog=epilog, parser=parser,
                            citations=citations)


def add_loadgraph_args(parser):
    parser.add_argument('-l', '--loadgraph', metavar="filename", default=None,
                        help='load a precomputed k-mer graph from disk')


def calculate_graphsize(args, graphtype, multiplier=1.0):
    """Target size (buckets) of each table (khmer_args.py:504-521)."""
    if graphtype not in khmer._buckets_per_byte:
        raise ValueError('unknown graph type: ' + graphtype)
    if args.max_memory_usage:
        tablesize = float(multiplier) * (
            khmer._buckets_per_byte[graphtype] * args.max_memory_usage /
            args.n_tables)
    else:
        tablesize = args.max_tablesize
    return tablesize


def _check_n_tables(args):
    if hasattr(args, 'force'):
        if args.n_tables > 20:
            if not args.force:
                print_error("\n** ERROR: khmer only supports number "
                            "of tables <= 20.\n")
                sys.exit(1)
            else:
                log_warn("\n*** Warning: Maximum recommended number of "
                         "tables is 20, discarded by force nonetheless!\n")


def create_nodegraph(args, ksize=None, multiplier=1.0, fp_rate=0.01,
                     device=None):
    """Create a Nodegraph per the CLI args on `device`
    (khmer_args.py:436-447)."""
    args = _check_fp_rate(args, fp_rate)
    _check_n_tables(args)
    if ksize is None:
        ksize = args.ksize
    if ksize > 32:
        print_error("\n** ERROR: khmer only supports k-mer sizes <= 32.\n")
        sys.exit(1)
    tablesize = calculate_graphsize(args, 'nodegraph', multiplier)
    return khmer.Nodegraph(ksize, tablesize, args.n_tables, device=device)


def create_countgraph(args, ksize=None, multiplier=1.0, fp_rate=0.1,
                      device=None):
    """Create a Countgraph, or a SmallCountgraph under --small-count, per
    the CLI args on `device` (khmer_args.py:599-637)."""
    args = _check_fp_rate(args, fp_rate)
    _check_n_tables(args)
    if ksize is None:
        ksize = args.ksize
    if ksize > 32:
        print_error("\n** ERROR: khmer only supports k-mer sizes <= 32 for "
                    "graphs.\n")
        sys.exit(1)
    if getattr(args, 'hash_function', 'twobit-exact') != 'twobit-exact':
        print_error("\n** ERROR: graphs only support hash function (-H) "
                    "'twobit-exact'.")
        sys.exit(1)

    if getattr(args, 'small_count', False):
        tabletype, tableclass = 'smallcountgraph', khmer.SmallCountgraph
    else:
        tabletype, tableclass = 'countgraph', khmer.Countgraph

    tablesize = calculate_graphsize(args, tabletype, multiplier=multiplier)
    cg = tableclass(ksize, tablesize, args.n_tables, device=device)
    # NibbleStorage has no bigcount (khmer_tpu/khmer_args.py:472)
    if hasattr(args, 'bigcount') and tabletype == 'countgraph':
        cg.set_use_bigcount(args.bigcount)
    return cg


def create_counttable(args, ksize=None, multiplier=1.0, fp_rate=0.1,
                      device=None):
    """Create the table khmer_tpu's create_counttable makes for these CLI
    args (khmer_args.py:640-680), on `device`: a Countgraph, a Counttable
    for -H murmur (any k up to 255), or a SmallCountgraph under
    --small-count (which -H murmur refuses)."""
    args = _check_fp_rate(args, fp_rate)
    _check_n_tables(args)
    if ksize is None:
        ksize = args.ksize

    hash_function = getattr(args, 'hash_function', 'twobit-exact')
    if hash_function == 'twobit-exact':
        if ksize > 32:
            print_error("\n** ERROR: hash function 'twobit-exact' only "
                        "supports k-mer sizes <= 32.")
            print_error("** See -H/--hash-function for alternatives.")
            sys.exit(1)
    elif hash_function != 'murmur':
        print_error("\n** Error, unknown hash function")
        sys.exit(1)

    if getattr(args, 'small_count', False):
        if hash_function == 'murmur':
            print_error("\n** ERROR: hash function 'murmur' does not "
                        "support small counts yet.")
            sys.exit(1)
        tablesize = calculate_graphsize(args, 'smallcountgraph',
                                        multiplier=multiplier)
        return khmer.SmallCountgraph(ksize, tablesize, args.n_tables,
                                     device=device)

    if hash_function == 'murmur':
        tabletype, tableclass = 'counttable', khmer.Counttable
    else:
        tabletype, tableclass = 'countgraph', khmer.Countgraph
    tablesize = calculate_graphsize(args, tabletype, multiplier=multiplier)
    return tableclass(ksize, tablesize, args.n_tables, device=device)


def create_MQFGraph(args, ksize=None, multiplier=1.0, fp_rate=0.1,
                    device=None):
    """A QFCounttable (--mqf) or BufferedQFCounttable (--bmqf) sized from
    -U and --fp-rate (khmer_tpu/khmer_args.py:518-577, the sizing of the
    reference's khmer/khmer_args.py:548-598).  The filter is host-exact,
    as khmer_tpu's is: a sorted (key, count) dictionary, whose tables
    hash their reads on `device` (docs/PARITY.md N4/N5)."""
    del multiplier
    if ksize is None:
        ksize = args.ksize
    if ksize > 31:
        print_error("\n** ERROR: khmer only supports k-mer sizes <= 32.\n")
        sys.exit(1)
    if not args.unique_kmers:
        print_error("\n** ERROR: please supply unique  number of kmers.\n")
        sys.exit(1)

    size = int(math.ceil(math.log2(1.3 * args.unique_kmers)))

    if args.fp_rate:
        log_info("*** INFO: Overriding default fp {def_fp} with new fp:"
                 " {new_fp}", def_fp=fp_rate, new_fp=args.fp_rate)
        fp_rate = args.fp_rate

    p = int(math.ceil(math.log2(float(args.unique_kmers) / float(fp_rate))))
    p = min(p, ksize * 2)
    slot_size = p - size

    if slot_size < 2:
        print_error("\n** ERROR: too small slot size.\n")
        sys.exit(1)

    nslots = 2 ** size
    nslots += 10 * math.sqrt(nslots)
    nblocks = int((nslots + 63) / 64)
    block_size = 17
    bits_per_slot = slot_size + 2
    total_size = nblocks * (block_size + bits_per_slot * 8)
    total_size /= (1000.0 ** 3)

    if getattr(args, 'mqf', False):
        log_info("*** INFO: creating MQF of size {size} and slot "
                 "{slotsize}. Total Size ={totalSize}G",
                 size=size, slotsize=slot_size, totalSize=total_size)
        return khmer.QFCounttable(ksize, 2 ** size, slot_size,
                                  device=device)
    if getattr(args, 'bmqf', False):
        log_info("*** INFO: creating Buffered MQF of size {size} and slot "
                 "{slotsize}. Total Size ={totalSize}G",
                 size=size, slotsize=slot_size, totalSize=total_size)
        return khmer.BufferedQFCounttable(ksize, 2 ** size, slot_size,
                                          device=device)
    print_error("\n** ERROR: Unknown mqf type.\n")
    sys.exit(1)


def create_matching_nodegraph(countgraph):
    """Nodegraph with the same bucket counts as a countgraph
    (khmer_args.py:696-705)."""
    tablesizes = countgraph.hashsizes()
    return khmer.Nodegraph(countgraph.ksize(), 1, 1, primes=tablesizes,
                           device=countgraph.device)


def report_on_config(args, graphtype='countgraph'):
    """Log the derived configuration (khmer_args.py:708-738)."""
    check_conflicting_args(args, graphtype)
    if graphtype not in khmer._buckets_per_byte:
        raise ValueError('unknown graph type: ' + graphtype)

    tablesize = calculate_graphsize(args, graphtype)
    maxmem = args.n_tables * tablesize / khmer._buckets_per_byte[graphtype]
    log_info("\nPARAMETERS:")
    log_info(" - kmer size =     {ksize} \t\t(-k)", ksize=args.ksize)
    log_info(" - n tables =      {ntables} \t\t(-N)", ntables=args.n_tables)
    log_info(" - max tablesize = {tsize:5.2g} \t(-x)", tsize=tablesize)
    log_info("Estimated memory usage is {mem:.1f} Gb "
             "({bytes:.2g} bytes = {ntables} bytes x {tsize:5.2g} entries "
             "/ {div:d} entries per byte)", bytes=maxmem, mem=maxmem / 1e9,
             div=int(khmer._buckets_per_byte[graphtype]),
             ntables=args.n_tables, tsize=tablesize)
    log_info("-" * 8)

    if tablesize == DEFAULT_MAX_TABLESIZE and \
       not getattr(args, 'loadgraph', None):
        log_warn('''\

** WARNING: tablesize is default!
** You probably want to increase this with -M/--max-memory-usage!
** Please read the docs!
''')


def add_threading_args(parser):
    parser.add_argument('-T', '--threads', default=DEFAULT_N_THREADS,
                        type=int,
                        help='Number of simultaneous threads to execute')


def sanitize_help(parser):
    """Reflow help text and strip Sphinx markup (khmer_args.py:747-766)."""
    wrapper = textwrap.TextWrapper(width=79)
    parser.description = wrapper.fill(parser.description)
    if not parser.epilog:
        return parser
    cleanlog = parser.epilog.replace(':option:', '').replace(
        ':program:', '').replace('::', ':').replace('``', '"')
    newlog = prev_section = ""
    for section in cleanlog.split('\n\n'):
        if section.startswith('    '):
            newlog += section + '\n'
        else:
            if prev_section.startswith('    '):
                newlog += '\n'
            newlog += wrapper.fill(section) + '\n\n'
        prev_section = section
    parser.epilog = newlog
    return parser


def info(scriptname, algorithm_list=None):
    """Print version/citation banner to stderr (khmer_args.py:769-797)."""
    log_info("\n|| This is the script {name} in khmer.\n"
             "|| You are running khmer version {version}",
             name=scriptname, version=__version__)
    log_info("|| You are also using the khmer_tpu_torch (PyTorch/CUDA) "
             "runtime\n||")
    log_info("|| If you use this script in a publication, please "
             "cite EACH of the following:\n||")
    if algorithm_list is None:
        algorithm_list = []
    algorithm_list.insert(0, 'software')
    for alg in algorithm_list:
        log_info("||   * " + ALGORITHMS[alg])
    log_info("||\n|| Please see http://khmer.readthedocs.io/en/"
             "latest/citations.html for details.\n")
