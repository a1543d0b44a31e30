"""Tensor and sequence parallelism over ``torch.distributed``: the process
groups of a named mesh, the collectives with their gradients, and the
parallel mixers and scans (the JAX package's ``parallel/``)."""

from si_mamba_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshAxis,
    global_host_concat,
    global_host_sum,
    make_mesh,
    maybe_initialize_distributed,
    per_process_batch,
)
