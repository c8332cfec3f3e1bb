"""Fleet-scale hierarchical federation (port of ``repro.fleet``).

- ``topology``: :class:`Topology`, the client -> edge assignment;
- ``hierarchy``: the two-tier edge -> server merges (K9 on the card);
- ``sharding``: ``client_chunk``-bounded and device-sharded client maps.

``ProtocolConfig(topology=..., client_chunk=..., edge_codec=...)`` routes the
batched sync engine through this subsystem.
"""
from repro_torch.fleet.hierarchy import edge_moment_merge, edge_param_merge, server_combine
from repro_torch.fleet.sharding import (
    chunked_vmap,
    client_mesh,
    sharded_client_map,
    working_set_proxy,
)
from repro_torch.fleet.topology import Topology

__all__ = [
    "Topology", "chunked_vmap", "client_mesh", "edge_moment_merge", "edge_param_merge",
    "server_combine", "sharded_client_map", "working_set_proxy",
]
