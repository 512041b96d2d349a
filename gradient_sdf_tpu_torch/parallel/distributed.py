"""Multi-host entry point: join a process group, then a mesh over all ranks.

Port of `gradient_sdf_tpu/parallel/distributed.py`. Call `init()` once per
process, with explicit arguments or from torchrun's environment variables
(`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`, `RANK`, `LOCAL_RANK`,
`LOCAL_WORLD_SIZE`); then `global_mesh()` builds the (rays, blocks) mesh
over every rank, with the block axis across hosts (grid storage sharded
over hosts) and the ray axis across the ranks of a host.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from . import mesh as mesh_mod


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None, *, device="cuda",
         timeout_s: float = mesh_mod.DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group at `coordinator_address` ("host:port"; default
    `MASTER_ADDR:MASTER_PORT` through torch's `env://`, which also joins
    the store a torchrun agent keeps there) as rank `process_id` (default
    `RANK`) of `num_processes` (default `WORLD_SIZE`). Returns False, and
    does nothing, when no address is given or set: a single-process run."""
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    elif "MASTER_ADDR" in os.environ:
        init_method = "env://"
    else:
        return False
    world = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    mesh_mod.init_group(rank, world, local_rank, local_world, device,
                        init_method=init_method,
                        timeout_s=timeout_s)
    return True


def global_mesh(block_parallel: Optional[int] = None, device="cuda"):
    """(rays, blocks) mesh over all ranks. By default the block axis spans
    the hosts (`WORLD_SIZE // LOCAL_WORLD_SIZE`), host h's ranks forming
    column h, and the ray axis spans the ranks of a host; an explicit
    `block_parallel` takes `make_mesh`'s row-major layout."""
    import torch.distributed as dist

    n = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    hosts = max(1, n // local)
    if block_parallel is None:
        layout = np.arange(n).reshape(hosts, local).T
        return mesh_mod.make_mesh(n, hosts, device, layout=layout)
    return mesh_mod.make_mesh(n, block_parallel, device)
