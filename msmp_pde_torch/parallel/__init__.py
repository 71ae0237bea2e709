"""Data parallelism over a torch.distributed group (parallel/mesh.py)."""
from msmp_pde_torch.parallel.mesh import (  # noqa: F401
    dp_sharded_step,
    gather_in_order,
    gather_rows,
    init_distributed,
    shard_rows,
    wait_for_backend,
)
