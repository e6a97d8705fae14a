"""Global stderr logger with --quiet support (parity: reference
khmer/khmer_logger.py:41-78)."""

import sys

__QUIET = False


def configure_logging(quiet):
    global __QUIET
    __QUIET = quiet


def log_info(message, **kwargs):
    """Print the message to stderr unless in quiet mode."""
    if not __QUIET:
        if kwargs:
            message = message.format(**kwargs)
        print(message, file=sys.stderr)
        sys.stderr.flush()


def log_error(message, **kwargs):
    """Print the message to stderr always."""
    if kwargs:
        message = message.format(**kwargs)
    print(message, file=sys.stderr)
    sys.stderr.flush()


log_debug = log_info
log_warn = log_info
