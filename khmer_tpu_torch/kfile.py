"""File sanity checks and compressed output writers (the part of
khmer_tpu/kfile.py the scripts use;
parity: reference khmer/kfile.py)."""

import bz2
import errno
import gzip
import os
import sys
from stat import S_ISBLK, S_ISCHR, S_ISFIFO


def check_input_files(file_path, force):
    """Warn/exit when an input file is missing or empty
    (kfile.py:46-86)."""
    if file_path == "-":
        return
    try:
        mode = os.stat(file_path).st_mode
    except OSError:
        print("ERROR: Input file %s does not exist" % file_path,
              file=sys.stderr)
        if not force:
            print("NOTE: This can be overridden using the --force argument",
                  file=sys.stderr)
            print("Exiting", file=sys.stderr)
            sys.exit(1)
        return

    if S_ISBLK(mode) or S_ISFIFO(mode) or S_ISCHR(mode):
        return

    if os.stat(file_path).st_size == 0:
        print("ERROR: Input file %s is empty; exiting." % file_path,
              file=sys.stderr)
        if not force:
            print("NOTE: This can be overridden using the --force argument",
                  file=sys.stderr)
            sys.exit(1)


def check_file_writable(file_path):
    """Exit when file_path is not writable."""
    try:
        file_obj = open(file_path, "a")
    except IOError as error:
        if error.errno == errno.EACCES:
            print("ERROR: File %s does not have write " % file_path +
                  "permission; exiting", file=sys.stderr)
            sys.exit(1)
        else:
            print("ERROR: " + error.strerror, file=sys.stderr)
    else:
        file_obj.close()


def _free_space(path, _testhook_free_space=None):
    if _testhook_free_space is not None:
        return _testhook_free_space
    target = os.statvfs(os.path.dirname(os.path.realpath(path)))
    return target.f_frsize * target.f_bavail


def check_space(in_files, force, _testhook_free_space=None):
    """Exit when disk space looks insufficient for outputs
    (kfile.py:112-150)."""
    free_space = _free_space(in_files[0], _testhook_free_space)
    valid_files = [f for f in in_files if os.path.isfile(f)]
    total_size = sum(os.stat(f).st_size for f in valid_files)

    size_diff = total_size - free_space
    if size_diff > 0:
        message = "Not enough free space on disk for output files;"
        message += "\n       Need at least {:.1f} GB more.".format(
            size_diff / 1e9)
        message += "\n       Estimated Output size: {:.1f} GB".format(
            total_size / 1e9)
        message += "\n       Free space: {:.1f} GB".format(free_space / 1e9)
        if force:
            print("WARNING:", message, file=sys.stderr)
        else:
            print("ERROR: " + message, file=sys.stderr)
            print("NOTE: This can be overridden using the --force"
                  " argument", file=sys.stderr)
            sys.exit(1)


def check_space_for_graph(outfile_name, hash_size, force,
                          _testhook_free_space=None):
    """Exit when there is no space to write a graph of hash_size bytes
    (kfile.py:152-183)."""
    free_space = _free_space(outfile_name, _testhook_free_space)
    size_diff = hash_size - free_space
    if size_diff > 0:
        message = "Not enough free space on disk for saved graph files;"
        message += "\n       Need at least {:.1f} GB more.".format(
            size_diff / 1e9)
        message += "\n       Table size: {:.1f} GB".format(hash_size / 1e9)
        message += "\n       Free space: {:.1f} GB".format(free_space / 1e9)
        if force:
            print("WARNING:", message, file=sys.stderr)
        else:
            print("ERROR: " + message, file=sys.stderr)
            print("NOTE: This can be overridden using the --force"
                  " argument", file=sys.stderr)
            sys.exit(1)


def check_valid_file_exists(in_files):
    """Warn (stderr) about empty or missing input files."""
    for in_file in in_files:
        if in_file == "-":
            continue
        if os.path.exists(in_file):
            mode = os.stat(in_file).st_mode
            if os.stat(in_file).st_size > 0 or S_ISBLK(mode) or \
                    S_ISFIFO(mode):
                return
            print("WARNING: Input file %s is empty" % in_file,
                  file=sys.stderr)
        else:
            print("WARNING: Input file %s not found" % in_file,
                  file=sys.stderr)


def is_block(fthing):
    """True when the handle is stdout/stdin or a block/char device."""
    if fthing is sys.stdout or fthing is sys.stdin:
        return True
    mode = os.stat(fthing.name).st_mode
    return S_ISBLK(mode) or S_ISCHR(mode)


def describe_file_handle(fthing):
    if is_block(fthing):
        return "block device"
    return fthing.name


def add_output_compression_type(parser):
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--gzip", default=False, action="store_true",
                       help="Compress output using gzip")
    group.add_argument("--bzip", default=False, action="store_true",
                       help="Compress output using bzip2")


def get_file_writer(file_handle, do_gzip, do_bzip):
    """Wrap a binary handle in the requested compressor."""
    if do_gzip and do_bzip:
        raise ValueError("Cannot specify both bzip and gzip compression!")
    if do_gzip:
        return gzip.GzipFile(fileobj=file_handle, mode="w")
    if do_bzip:
        return bz2.open(file_handle, mode="w")
    return file_handle
