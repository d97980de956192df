"""Named meshes; context parallelism (ring attention, Ulysses), expert
parallelism (MoE dispatch), parameter placement over fsdp and tp, and the
pipeline schedules over them."""

from .mesh import (AXIS_ORDER, Axis, Mesh, axis_size, create_hybrid_mesh,
                   create_mesh, get_mesh, set_mesh, shift)
from .ring import local_attention, ring_attention
from .ulysses import heads_to_seq, seq_to_heads, ulysses_attention
from .moe import (RouterOutput, SortedRouting, expert_alltoall,
                  expert_alltoall_back, expert_replica_set, routed_experts,
                  sorted_combine, sorted_dispatch, topk_router,
                  topk_router_sorted)
from .sharding import (LOGICAL_RULES, Placement, copy_to_tp, gather_param,
                       placement, reduce_from_tp, rules_for_mesh,
                       vocab_parallel_embedding)
from .pipeline import (pipeline, pipeline_1f1b_value_and_grad,
                       pipeline_value_and_grad)
