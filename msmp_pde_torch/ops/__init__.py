"""Hand-written CUDA kernels (csrc/) with their plain PyTorch versions,
registered as ``torch.library`` ops in the ``msmp`` namespace
(ops/library.py) when this package is imported.

The kernel functions count their launches in module globals of their
wrappers; ``LAUNCH_COUNTERS`` names them, and ``launch_counts`` and
``set_launch_counts`` read and set them by those names (a replayed CUDA
graph adds the launches its capture made, graphs.py)."""
from typing import Dict

from msmp_pde_torch.ops import library  # noqa: F401
from msmp_pde_torch.ops import lem_scan, mp_layer, mp_pair

# {name: (module, its launch counter)}; a stash variant is counted in its
# kernel's total too
LAUNCH_COUNTERS = {
    "lem_fwd": (lem_scan, "launches"),
    "lem_fwd_stash": (lem_scan, "stash_launches"),
    "lem_bwd": (lem_scan, "bwd_launches"),
    "mp_pair_fwd": (mp_pair, "launches"),
    "mp_pair_fwd_stash": (mp_pair, "stash_launches"),
    "mp_pair_bwd": (mp_pair, "bwd_launches"),
    "mp_layer_fwd": (mp_layer, "launches"),
    "mp_layer_bwd": (mp_layer, "bwd_launches"),
}


def launch_counts() -> Dict[str, int]:
    """{name: launches since the last reset} of every counter."""
    return {k: getattr(m, a) for k, (m, a) in LAUNCH_COUNTERS.items()}


def set_launch_counts(counts: Dict[str, int]):
    """Sets each counter that ``counts`` names."""
    for k, n in counts.items():
        m, a = LAUNCH_COUNTERS[k]
        setattr(m, a, n)
