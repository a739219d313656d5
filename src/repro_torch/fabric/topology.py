"""Fabric topology graphs: hosts, switches, devices, directed port links (a
copy of ``repro.fabric.topology``).

A :class:`FabricTopology` is a small DAG describing how memory tiers hang
off hosts.  Nodes are **hosts** (where workload cores issue from),
**switches** (interior fan-in/fan-out points), and **devices** (one per
memory-tier name).  Directed :class:`Link` edges connect them; a link is
either *transparent* (pure attachment — wires with no modelled port) or
*port-bearing*, in which case it carries its own service rate, server
count, and a ToR-style queue-entry limit, and the DES materializes it as a
hop station on every route that crosses it.

The canonical flat platforms are the degenerate case: :func:`direct`
builds an all-transparent topology, every route has zero hop stations,
and the simulator's fabric machinery stays fully dormant — simulation
event chains are bit-identical to a fabric-less platform by construction.

Validation happens eagerly at construction: unknown endpoints, cycles,
tiers unreachable from a host, and zero-capacity ports (a link that names
a port but gives it no slots/queue/service) all raise
:class:`TopologyError` with the offending names in the message.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

from repro_torch.core.device_model import UnknownTierError

__all__ = [
    "Link",
    "FabricTopology",
    "TopologyError",
    "direct",
    "single_switch",
    "spine_leaf",
]


class TopologyError(ValueError):
    """A fabric topology failed structural validation (cycle, unreachable
    tier, dangling endpoint, duplicate name, or zero-capacity port)."""


@dataclasses.dataclass(frozen=True)
class Link:
    """One directed edge ``src -> dst`` of the fabric graph.

    ``port_slots == 0`` (the default) declares a *transparent* link: pure
    attachment, no modelled port, no hop station.  A *port-bearing* link
    sets all three of ``port_slots`` (parallel servers at the port),
    ``service_ns`` (per-cacheline service time — peak port bandwidth is
    ``port_slots * 64 / service_ns`` GB/s), and ``queue_entries`` (the
    port's ToR-style entry limit in cachelines; a full port exerts
    backpressure on upstream hops).  Mixing — some of the three set, some
    zero — is a :class:`TopologyError` (a "zero-capacity port").
    """

    name: str
    src: str
    dst: str
    port_slots: int = 0
    service_ns: float = 0.0
    queue_entries: int = 0

    @property
    def is_transparent(self) -> bool:
        """True when this link is pure attachment (no hop station)."""
        return (
            self.port_slots == 0
            and self.queue_entries == 0
            and self.service_ns == 0.0
        )


@dataclasses.dataclass(frozen=True)
class FabricTopology:
    """A validated routed fabric: hosts, switches, devices, directed links.

    ``devices`` are memory-tier names (they must cover every tier of the
    platform the topology is attached to).  Construction validates the
    graph (see module docstring) and eagerly resolves one :class:`Route`
    per ``(host, device)`` pair — shortest path, ties broken by link
    declaration order — so :meth:`route` is a dict lookup at sim-build
    time.
    """

    hosts: Tuple[str, ...]
    devices: Tuple[str, ...]
    switches: Tuple[str, ...] = ()
    links: Tuple[Link, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "hosts", tuple(self.hosts))
        object.__setattr__(self, "devices", tuple(self.devices))
        object.__setattr__(self, "switches", tuple(self.switches))
        object.__setattr__(self, "links", tuple(self.links))
        self._validate()
        # Frozen dataclass: cache derived tables via object.__setattr__
        # (eq/hash/pickle see only the declared fields, like PlatformModel).
        from repro_torch.fabric.routing import resolve_routes

        object.__setattr__(
            self,
            "_station_links",
            tuple(l for l in self.links if not l.is_transparent),
        )
        object.__setattr__(self, "_routes", resolve_routes(self))

    # -- validation -----------------------------------------------------------

    def _validate(self) -> None:
        nodes = self.hosts + self.switches + self.devices
        if len(set(nodes)) != len(nodes):
            raise TopologyError(f"duplicate node names in fabric: {nodes}")
        if not self.hosts:
            raise TopologyError("fabric topology declares no hosts")
        if not self.devices:
            raise TopologyError("fabric topology declares no devices")
        node_set = set(nodes)
        seen_links = set()
        for l in self.links:
            if l.name in seen_links:
                raise TopologyError(f"duplicate link name {l.name!r}")
            seen_links.add(l.name)
            for end in (l.src, l.dst):
                if end not in node_set:
                    raise TopologyError(
                        f"link {l.name!r} references unknown node {end!r}"
                    )
            if l.src in self.devices:
                raise TopologyError(
                    f"link {l.name!r} leaves device node {l.src!r}; "
                    "devices are sinks"
                )
            if l.dst in self.hosts:
                raise TopologyError(
                    f"link {l.name!r} enters host node {l.dst!r}; "
                    "hosts are sources"
                )
            if not l.is_transparent and (
                l.port_slots <= 0 or l.queue_entries <= 0
                or l.service_ns <= 0.0
            ):
                raise TopologyError(
                    f"link {l.name!r} declares a zero-capacity port "
                    f"(port_slots={l.port_slots}, "
                    f"queue_entries={l.queue_entries}, "
                    f"service_ns={l.service_ns}); a port-bearing link "
                    "needs all three positive, a transparent link all "
                    "three zero"
                )
        self._check_acyclic()
        self._check_reachable()

    def _adjacency(self) -> Dict[str, list]:
        adj: Dict[str, list] = {}
        for l in self.links:  # declaration order == tie-break order
            adj.setdefault(l.src, []).append(l)
        return adj

    def _check_acyclic(self) -> None:
        # Iterative DFS three-coloring over the directed graph; any back
        # edge is a cycle (backpressure chains must terminate at devices).
        adj = self._adjacency()
        color: Dict[str, int] = {}  # 1 = on stack, 2 = done
        for root in self.hosts + self.switches:
            if color.get(root):
                continue
            stack = [(root, iter(adj.get(root, ())))]
            color[root] = 1
            while stack:
                node, it = stack[-1]
                for link in it:
                    c = color.get(link.dst)
                    if c == 1:
                        raise TopologyError(
                            f"fabric topology has a cycle through link "
                            f"{link.name!r} ({link.src!r} -> {link.dst!r})"
                        )
                    if c is None:
                        color[link.dst] = 1
                        stack.append(
                            (link.dst, iter(adj.get(link.dst, ())))
                        )
                        break
                else:
                    color[node] = 2
                    stack.pop()

    def _check_reachable(self) -> None:
        adj = self._adjacency()
        for host in self.hosts:
            seen = {host}
            frontier = [host]
            while frontier:
                node = frontier.pop()
                for link in adj.get(node, ()):
                    if link.dst not in seen:
                        seen.add(link.dst)
                        frontier.append(link.dst)
            for dev in self.devices:
                if dev not in seen:
                    raise TopologyError(
                        f"tier {dev!r} is unreachable from host {host!r}"
                    )

    # -- queries --------------------------------------------------------------

    @property
    def station_links(self) -> Tuple[Link, ...]:
        """Port-bearing links in declaration order — the hop stations the
        DES materializes and the link control edges of per-edge MIKU."""
        return self._station_links

    @property
    def has_hops(self) -> bool:
        """True when any route can cross a port (non-degenerate fabric)."""
        return bool(self._station_links)

    def route(self, host: str, tier: str):
        """The resolved :class:`~repro_torch.fabric.routing.Route` for requests a
        ``host`` workload issues to ``tier`` (raises
        :class:`~repro_torch.core.device_model.UnknownTierError` on unknown
        names)."""
        if host not in self.hosts:
            raise UnknownTierError(
                host, self.hosts, kind="fabric host",
                known_desc="topology hosts",
            )
        if tier not in self.devices:
            raise UnknownTierError(
                tier, self.devices, kind="fabric device",
                known_desc="topology devices",
            )
        return self._routes[(host, tier)]


# -- named constructors -------------------------------------------------------


def direct(tiers: Sequence[str], host: str = "host0") -> FabricTopology:
    """The degenerate direct-attach topology: every tier hangs off ``host``
    over a transparent link.  Zero hop stations — a platform carrying this
    fabric simulates bit-identically to one carrying no fabric at all."""
    return FabricTopology(
        hosts=(host,),
        devices=tuple(tiers),
        links=tuple(
            Link(name=f"{host}-{t}", src=host, dst=t) for t in tiers
        ),
    )


def single_switch(
    tiers: Sequence[str],
    routed: Sequence[str],
    *,
    port_slots: int,
    service_ns: float,
    queue_entries: int,
    host: str = "host0",
    switch: str = "sw0",
) -> FabricTopology:
    """One host, one switch: each tier in ``routed`` sits behind its own
    port-bearing switch link (``{switch}-{tier}``); the rest attach
    transparently.  The minimal topology for port-queue-vs-ToR studies."""
    routed = tuple(routed)
    for t in routed:
        if t not in tiers:
            raise TopologyError(f"routed tier {t!r} not in tiers {tiers}")
    links = [Link(name=f"{host}-{switch}", src=host, dst=switch)]
    for t in tiers:
        if t in routed:
            links.append(Link(
                name=f"{switch}-{t}", src=switch, dst=t,
                port_slots=port_slots, service_ns=service_ns,
                queue_entries=queue_entries,
            ))
        else:
            links.append(Link(name=f"{host}-{t}", src=host, dst=t))
    return FabricTopology(
        hosts=(host,), devices=tuple(tiers), switches=(switch,),
        links=tuple(links),
    )


def _per_host(value, n: int, what: str) -> Tuple:
    """Broadcast a scalar (or validate a length-``n`` sequence) per host."""
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise TopologyError(
                f"{what} has {len(value)} entries for {n} hosts"
            )
        return tuple(value)
    return (value,) * n


def spine_leaf(
    tiers: Sequence[str],
    routed: Sequence[str],
    *,
    n_hosts: int = 2,
    uplink_slots=16,
    uplink_service_ns=18.0,
    uplink_queue=1024,
    spine_slots: int = 8,
    spine_service_ns: float = 36.0,
    spine_queue: int = 1024,
) -> FabricTopology:
    """A two-level fabric: ``host{i} -> leaf{i} -> spine -> tier`` for each
    tier in ``routed``, the rest attached transparently per host.

    Each host's leaf uplink (``uplink{i}``) and the shared per-tier spine
    downlink (``spine-{tier}``) are port-bearing; uplink parameters accept
    a scalar (broadcast) or a per-host sequence, so asymmetric fabrics — a
    narrow uplink on one host — are one argument away.  The shared spine
    downlink is where cross-host congestion lives.
    """
    routed = tuple(routed)
    for t in routed:
        if t not in tiers:
            raise TopologyError(f"routed tier {t!r} not in tiers {tiers}")
    slots = _per_host(uplink_slots, n_hosts, "uplink_slots")
    svc = _per_host(uplink_service_ns, n_hosts, "uplink_service_ns")
    queue = _per_host(uplink_queue, n_hosts, "uplink_queue")
    hosts = tuple(f"host{i}" for i in range(n_hosts))
    leaves = tuple(f"leaf{i}" for i in range(n_hosts))
    links = []
    for i, (h, leaf) in enumerate(zip(hosts, leaves)):
        links.append(Link(name=f"{h}-{leaf}", src=h, dst=leaf))
        links.append(Link(
            name=f"uplink{i}", src=leaf, dst="spine",
            port_slots=slots[i], service_ns=svc[i],
            queue_entries=queue[i],
        ))
    for t in tiers:
        if t in routed:
            links.append(Link(
                name=f"spine-{t}", src="spine", dst=t,
                port_slots=spine_slots, service_ns=spine_service_ns,
                queue_entries=spine_queue,
            ))
        else:
            for h in hosts:
                links.append(Link(name=f"{h}-{t}", src=h, dst=t))
    return FabricTopology(
        hosts=hosts, devices=tuple(tiers),
        switches=leaves + ("spine",), links=tuple(links),
    )
