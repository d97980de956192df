"""Context parallelism over named meshes: ring attention and Ulysses."""

from .mesh import (AXIS_ORDER, Axis, Mesh, axis_size, create_mesh, get_mesh,
                   set_mesh, shift)
from .ring import local_attention, ring_attention
from .ulysses import heads_to_seq, seq_to_heads, ulysses_attention
