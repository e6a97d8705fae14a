"""The deferred counter's constants, its stage timer and its combine.

Port of the parts of khmer_tpu/ops/deferred.py that the sharded consume
(khmer_tpu_torch/parallel/sharded.py) runs: the dead-lane patterns and
the total clamp (:73-78), the bucket constants (:113-115), the flush
window and buffer sizes (:97-111, :194-207), the stage timer (:141-191)
and the combines of a lane buffer (:270-325), over kernel K16.

Lanes are (key, weight, first): keys are int64 bit patterns of uint64
hashes (khmer_tpu_torch/_u64.py), SENTINEL marking a dead lane; weights
and first positions are int32 bit patterns of uint32.  A lane's first
position is its place in the consume's k-mer stream (reads in file
order, k-mers left to right), and a combine keeps each distinct key's
least one: the first-occurrence index of the reference's exact
sequential n_unique claim rule (khmer_tpu/ops/deferred.py docstring).
Positions are u32, so a consume of more than 2**32 k-mer occurrences
wraps, as khmer_tpu's does.

The single-device consume does not go through here: it is exact
through K2 a chunk (khmer_tpu_torch/hashtable.py).  khmer_tpu's
DeferredCounter and flush_table_ops(_dense) (:345-516) are not ported.
"""

import os
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

from khmer_tpu_torch import kernels
from khmer_tpu_torch.kernels.plain import (IDX_SENTINEL, SENTINEL,
                                           TOTAL_CLAMP)

__all__ = ["SENTINEL", "IDX_SENTINEL", "TOTAL_CLAMP", "MIN_BUCKET",
           "MIN_MERGE", "flush_slice", "default_max_cap", "stage",
           "combine_lanes", "combine_unit_lanes"]

# smallest buffer/bucket granule: one hash-kernel row of lanes
MIN_BUCKET = 1 << 14
# buffer sizing hint for the sharded consumer's per-shard cap
MIN_MERGE = 1 << 24


def _on_card(device):
    return torch.device(device).type == "cuda"


def flush_slice(device):
    """The largest routing and flush window, in lanes: 2**25 on the card,
    2**23 on the CPU."""
    return 1 << (25 if _on_card(device) else 23)


def _next_pow2(n):
    return 1 << max(int(n) - 1, 0).bit_length()


def default_max_cap(device):
    """Buffer ceiling in lanes (16 bytes a lane: key, weight, first):
    2**27 on the card, 2**23 on the CPU."""
    return 1 << (27 if _on_card(device) else 23)


# -- stage timing (KHMER_TPU_TIMING=1, or enable_timing()) ------------------

STAGE_TIMES = defaultdict(float)
STAGE_LANES = defaultdict(int)
_TIMING = [bool(os.environ.get("KHMER_TPU_TIMING"))]


def timing_enabled():
    return _TIMING[0]


def enable_timing(on=True):
    """Turn the stage timer on or off for this process."""
    _TIMING[0] = bool(on)


def reset_stage_times():
    STAGE_TIMES.clear()
    STAGE_LANES.clear()


class _StageHandle:
    __slots__ = ("sync",)

    def __init__(self, sync=None):
        self.sync = sync


@contextmanager
def stage(name, lanes=0, sync=None):
    """Add the wall time (and lanes) of the body to STAGE_TIMES[name]
    when timing is on; otherwise free.  In timing mode each stage waits
    for its own device work: the body sets `handle.sync` to a tensor
    made inside it, and the exit synchronises that tensor's device
    (every device when none is set), so the stage sums approach the
    device's wall while the untimed run keeps the host ahead."""
    if not _TIMING[0]:
        yield None
        return
    h = _StageHandle(sync)
    t0 = time.perf_counter()
    yield h
    if isinstance(h.sync, torch.Tensor):
        if h.sync.is_cuda:
            torch.cuda.synchronize(h.sync.device)
    elif torch.cuda.is_available():
        torch.cuda.synchronize()
    STAGE_TIMES[name] += time.perf_counter() - t0
    STAGE_LANES[name] += int(lanes)


if _TIMING[0] and os.environ.get("KHMER_TPU_TIMING_OUT"):
    import atexit as _atexit
    import json as _json

    def _dump_stage_times(path=os.environ["KHMER_TPU_TIMING_OUT"]):
        with open(path, "w") as f:
            _json.dump({"times_s": {k: round(v, 4)
                                    for k, v in STAGE_TIMES.items()},
                        "lanes": dict(STAGE_LANES)}, f)

    _atexit.register(_dump_stage_times)


# -- combines ----------------------------------------------------------------


def combine_lanes(keys, wgts, idx):
    """Combine the duplicate keys of a weighted lane buffer (K16): totals
    add (each weight clamped at TOTAL_CLAMP, the sum mod 2**32, clamped
    again), first positions take their minimum.  Returns (keys, totals,
    firsts, n_valid): the distinct live keys compacted to the front, in
    no specified order, SENTINEL lanes after; n_valid an int64 [1]
    tensor on the buffer's device."""
    return kernels.combine_lanes(keys, wgts, idx)


def combine_unit_lanes(keys, idx):
    """combine_lanes for a unit-weight (key, position) buffer: every live
    lane weighs 1, so a key's total is its occurrences, clamped."""
    w = (keys != SENTINEL).to(torch.int32)
    return kernels.combine_lanes(keys, w, idx)
