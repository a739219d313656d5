"""repro_torch.fabric: routed CXL switch-fabric topologies for the tiered DES
(a copy of ``repro.fabric``).

The flat station layer models every tier as one queue directly off the
host.  Real disaggregated memory traverses switch fabrics, and per-hop
port queuing is where latency and unfairness actually live.  This package
adds the routed layer:

* :mod:`~repro_torch.fabric.topology` — :class:`FabricTopology` graphs (hosts,
  switches, device nodes, directed :class:`Link` edges with per-port
  queue capacity and service rates) and the named constructors
  :func:`direct`, :func:`single_switch`, :func:`spine_leaf`.
* :mod:`~repro_torch.fabric.routing` — a resolved :class:`Route` (ordered
  station path) per ``(host, tier)``, validated against the topology.
* :mod:`~repro_torch.fabric.control` — :func:`peredge_miku`, the MIKU ladder
  ensemble generalized from per-slow-tier to per-control-edge (device
  edges + port-bearing link edges; per-tier is the zero-link special
  case), and the :func:`edge_names` schedule it shares with
  ``TieredMemorySim(control_scope="edge")``.
* :mod:`~repro_torch.fabric.platforms` — Platform-A variants carrying a fabric
  (``A-direct``, ``A-spine`` are registered into ``PLATFORMS`` on
  import).

Attach a topology via ``PlatformModel.fabric``; the DES materializes each
port-bearing link as a hop station with its own entry limit and
head-of-line backpressure, and a platform whose links are all transparent
simulates bit-identically to a fabric-less one.
"""

from repro_torch.fabric.control import edge_names, peredge_miku
from repro_torch.fabric.platforms import (
    direct_platform,
    single_switch_platform,
    spine_leaf_platform,
)
from repro_torch.fabric.routing import Route, resolve_routes
from repro_torch.fabric.topology import (
    FabricTopology,
    Link,
    TopologyError,
    direct,
    single_switch,
    spine_leaf,
)

__all__ = [
    "FabricTopology",
    "Link",
    "Route",
    "TopologyError",
    "direct",
    "direct_platform",
    "edge_names",
    "peredge_miku",
    "resolve_routes",
    "single_switch",
    "single_switch_platform",
    "spine_leaf",
    "spine_leaf_platform",
]
