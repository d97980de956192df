"""Named meshes; context parallelism (ring attention, Ulysses) and expert
parallelism (MoE dispatch) over them."""

from .mesh import (AXIS_ORDER, Axis, Mesh, axis_size, create_mesh, get_mesh,
                   set_mesh, shift)
from .ring import local_attention, ring_attention
from .ulysses import heads_to_seq, seq_to_heads, ulysses_attention
from .moe import (RouterOutput, SortedRouting, expert_alltoall,
                  expert_alltoall_back, expert_replica_set, routed_experts,
                  sorted_combine, sorted_dispatch, topk_router,
                  topk_router_sorted)
