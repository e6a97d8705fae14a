"""Constants and device selection for khmer_tpu_torch.

Hashes are uint64 in khmer (``HashIntoType``, reference
include/oxli/oxli.hh:115).  PyTorch's CPU backend lacks most uint64
arithmetic, so the port carries every hash as the bit pattern of an
int64 tensor (see ``_u64``); the CUDA kernels read the same bytes as
``unsigned long long``.
"""

import torch

# Constants mirrored from reference include/oxli/oxli.hh:81-83,116
MAX_KCOUNT = 255
MAX_BIGCOUNT = 65535
KSIZE_MAX = 32  # for the exact 2-bit hash
DEFAULT_TAG_DENSITY = 40  # reference hashgraph.hh:63

BIN_DTYPE = torch.int32  # uint32 bin totals, as bit patterns


def resolve_device(device=None):
    """The torch.device an entry point runs on.  None means CUDA; a
    request for CUDA on a machine without a CUDA device raises instead
    of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "khmer_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device {!r}".format(device))
    return dev
