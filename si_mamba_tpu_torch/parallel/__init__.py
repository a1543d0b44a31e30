"""Data, tensor, sequence and pipeline parallelism over
``torch.distributed``: the process groups of a named mesh, the collectives
with their gradients, the draws over the global batch, and the parallel
mixers, scans and the pipelined stack (the JAX package's ``parallel/``)."""

from si_mamba_tpu_torch.parallel.mesh import (  # noqa: F401
    LOCAL_DATA,
    Mesh,
    MeshAxis,
    data_axis,
    global_host_concat,
    global_host_sum,
    make_mesh,
    maybe_initialize_distributed,
    per_process_batch,
    set_data_axis,
)
