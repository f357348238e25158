"""Multi-host bootstrap.

≙ the reference's MPI rank bootstrap + NCCL communicator setup
(/root/reference/src/fastertransformer/utils/mpi_utils.cc, nccl_utils.cc, and
the c10d-inherit hack th_op/gptneox/utils/nccl_inherit_utils.cc:8-68). Here
the entire rendezvous collapses into ``jax.distributed.initialize()`` — the
runtime wires every host's GPUs into one global device set, and GSPMD's
collectives run on NCCL.
"""
from __future__ import annotations

from typing import Optional

import jax

from ..utils.logger import get_logger

logger = get_logger(__name__)

_initialized = False


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the multi-host runtime. The coordinator address, process count
    and process id are given explicitly, as in bare-metal/MPI-style launches
    (the analog of the reference's mpirun path, docs/gpt_guide.md:471)."""
    global _initialized
    if _initialized:
        return
    kwargs = {}
    if coordinator_address:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    _initialized = True
    logger.info(
        "distributed: process %d/%d, %d local / %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )


def build_pod_mesh(tp: Optional[int] = None, dp: Optional[int] = None):
    """Mesh over every chip in the (possibly multi-host) run.

    Default: TP spans one host's chips (ICI-only collectives — the layer
    all-reduce never crosses DCN) and DP spans hosts, the layout the
    reference approximates with per-node TP + replica routing (SURVEY §2.4).
    """
    from .sharding import build_mesh

    n = jax.device_count()
    local = jax.local_device_count()
    if tp is None:
        tp = min(local, n)
    if dp is None:
        dp = n // tp
    return build_mesh(tp=tp, dp=dp)
