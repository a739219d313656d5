"""Route resolution: one ordered station path per ``(host, tier)`` pair (a
copy of ``repro.fabric.routing``).

A :class:`Route` is the full link path a request follows from its
workload's host to its target tier's device.  Only the *port-bearing*
links on the path become hop stations in the DES (:attr:`Route.hops`);
transparent links are pure attachment.  Routes are resolved eagerly at
:class:`~repro_torch.fabric.topology.FabricTopology` construction — BFS
shortest path, ties broken by link declaration order, so resolution is
deterministic for a given topology literal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["Route", "resolve_routes"]


@dataclasses.dataclass(frozen=True)
class Route:
    """The resolved path for ``host``-issued requests targeting ``tier``."""

    host: str
    tier: str
    #: Every link on the path, in traversal order (transparent included).
    links: Tuple = ()

    @property
    def hops(self) -> Tuple:
        """The port-bearing links only — the hop stations a request
        queues through (in order) before entering the tier's device."""
        return tuple(l for l in self.links if not l.is_transparent)

    @property
    def nodes(self) -> Tuple[str, ...]:
        """Node names along the path, ``host`` first, device last."""
        if not self.links:
            return (self.host, self.tier)
        return (self.links[0].src,) + tuple(l.dst for l in self.links)


def resolve_routes(topology) -> Dict[Tuple[str, str], Route]:
    """BFS-resolve a :class:`Route` for every ``(host, device)`` pair.

    Shortest path by link count; among equal-length paths the one using
    earlier-declared links wins (BFS expands links in declaration order).
    The topology validated reachability already, so every pair resolves.
    """
    adj: Dict[str, list] = {}
    for link in topology.links:
        adj.setdefault(link.src, []).append(link)
    routes: Dict[Tuple[str, str], Route] = {}
    for host in topology.hosts:
        # parent[node] = link used to first reach node
        parent: Dict[str, object] = {host: None}
        frontier = [host]
        while frontier:
            nxt = []
            for node in frontier:
                for link in adj.get(node, ()):
                    if link.dst not in parent:
                        parent[link.dst] = link
                        nxt.append(link.dst)
            frontier = nxt
        for dev in topology.devices:
            path = []
            node = dev
            while node != host:
                link = parent[node]
                path.append(link)
                node = link.src
            routes[(host, dev)] = Route(
                host=host, tier=dev, links=tuple(reversed(path))
            )
    return routes
