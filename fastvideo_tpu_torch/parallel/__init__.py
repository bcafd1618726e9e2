"""Device mesh and collectives (port of fastvideo_tpu/parallel/).

One process per card. The mesh places each process on the (dp, sp, tp)
axes and holds a process group per axis; the layers call the collectives
on those groups themselves (JAX's GSPMD inserts them).

Mesh axes (the JAX package's order):

* ``dp``  — data parallel (batch). Outermost: may span hosts.
* ``sp``  — Ulysses sequence parallel inside one denoising step.
* ``tp``  — tensor parallel (text encoders / very large DiTs).
"""

from fastvideo_tpu_torch.parallel.mesh import (
    MeshConfig,
    get_mesh,
    get_sp_size,
    get_tp_size,
    get_dp_size,
    init_mesh,
    maybe_init_distributed,
    maybe_init_mesh,
    mesh_context,
    destroy_mesh,
    DP_AXIS,
    SP_AXIS,
    TP_AXIS,
)
from fastvideo_tpu_torch.parallel.shard import (
    param_spec,
    shard_state,
    state_specs,
)
from fastvideo_tpu_torch.parallel.ulysses import (
    local_head_parallel_attention,
    ulysses_attention,
    shard_seq,
    unshard_seq,
    pad_to_multiple,
    pad_rope_to,
    pad_tokens_to,
)

__all__ = [
    "param_spec",
    "shard_state",
    "state_specs",
    "local_head_parallel_attention",
    "MeshConfig",
    "init_mesh",
    "maybe_init_distributed",
    "maybe_init_mesh",
    "get_mesh",
    "get_sp_size",
    "get_tp_size",
    "get_dp_size",
    "mesh_context",
    "destroy_mesh",
    "DP_AXIS",
    "SP_AXIS",
    "TP_AXIS",
    "ulysses_attention",
    "shard_seq",
    "unshard_seq",
    "pad_to_multiple",
    "pad_rope_to",
    "pad_tokens_to",
]
