"""File sanity checks (the part of khmer_tpu/kfile.py the scripts use;
parity: reference khmer/kfile.py)."""

import errno
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
