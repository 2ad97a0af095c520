"""The federation fabric: N sync-service regions, one causal namespace.

A :class:`FederatedRegion` wraps one :class:`~automerge_tpu_torch.service
.server.SyncService` and federates its rooms with peer regions over
:class:`~.link.RegionLink` endpoints.  The inter-region protocol is the
UNCHANGED ``{docId, clock, changes?}`` sync protocol — each room's hub
simply gains one peer per remote region (``region:<name>``), and
hub-to-hub peering converges automatically because an advertisement IS
a clock reveal: whatever a partition ate, the next clock exchange
re-extracts from truth.  What the federation tier adds is everything
the WAN makes hard:

- partition tolerance (the link's degradation ladder + bounded
  buffering + probe/hello reconnect, ``link.py``);
- O(groups) causal metadata (one ordering token per (room, origin
  region) riding the wire manifest, ``causal.py``);
- region-aware placement (``placement.py``) and region-qualified
  lineage sites (``ServiceConfig.region``), so a change's hop chain
  names which region's replica made it visible;
- cross-region observability: per-link lag/state gauges and ladder
  transition counters exported on the owning service's Prometheus
  scrape (``amtpu_region_*``) and folded into its ``describe()``
  postmortem.

Local writes are ALWAYS accepted — the fabric never gates a room's
intra-region admission on remote reachability (rung one of the ladder);
a partition only delays remote visibility, bounded and observable.
"""

from __future__ import annotations

from ..resilience.chaos import wan_pair
from ..resilience.validation import validate_msg
from .causal import GroupClock
from .link import RegionLink


class FederatedRegion:
    """One region of the fabric: a SyncService plus its region links."""

    def __init__(self, svc, name: str = None, *, placement=None,
                 lag_threshold: int = 32, probe_every: int = 4,
                 max_buffer: int = 512, max_retries: int = 6):
        name = name or svc.config.region
        if not name:
            raise ValueError("a federated region needs a name (pass it "
                             "here or set ServiceConfig.region)")
        if svc.config.region is None:
            # region-qualify lineage sites for rooms created from now on
            svc.config.region = name
        self.svc = svc
        self.name = name
        self.placement = placement
        self.clock = GroupClock(name)
        self.links: dict = {}          # remote name -> RegionLink
        self._attached: set = set()    # room ids with region peers wired
        self._link_cfg = {"lag_threshold": lag_threshold,
                          "probe_every": probe_every,
                          "max_buffer": max_buffer,
                          "max_retries": max_retries}
        svc._federation = self

    # -- topology -------------------------------------------------------

    def link_to(self, remote: str, *, seed: int = 0) -> RegionLink:
        """This region's endpoint toward `remote` (transport wired
        separately — see :func:`connect_regions`)."""
        if remote in self.links:
            raise ValueError(f"{self.name} already linked to {remote}")
        link = RegionLink(self, remote, seed=seed, **self._link_cfg)
        self.links[remote] = link
        # rooms attached before this link existed need its peer too
        self._attached.clear()
        return link

    def _attach_rooms(self):
        """Wire every not-yet-attached room of the service into the
        fabric: install the group-token mint hook and add one hub peer
        per region link (add_peer re-advertises all docs — joining the
        fabric IS a clock reveal)."""
        for room_id, room in list(self.svc._rooms.items()):
            if room_id in self._attached:
                continue
            self._attached.add(room_id)
            room.hub.group_mint = \
                (lambda r=room_id: self.clock.mint(r))
            for remote, link in self.links.items():
                peer_id = f"region:{remote}"
                if peer_id not in room.hub._peers:
                    room.hub.add_peer(
                        peer_id,
                        (lambda m, r=room_id, ln=link: ln.ship(r, m)))

    def _reattach_peer(self, remote: str):
        """Heal-time re-advertisement: drop and re-add the remote's hub
        peer in every attached room.  remove_peer releases the matrix
        slot and reveal state; add_peer re-advertises every doc, so the
        post-partition delta is recomputed from the clocks both sides
        NOW hold — including snapshot bootstrap for a region that
        rejoined empty."""
        link = self.links[remote]
        peer_id = f"region:{remote}"
        for room_id in self._attached:
            room = self.svc._rooms.get(room_id)
            if room is None:
                continue
            hub = room.hub
            hub.remove_peer(peer_id)
            hub.add_peer(
                peer_id, (lambda m, r=room_id, ln=link: ln.ship(r, m)))
            # re-inject the remote's last GENUINE clock statements: heal
            # is a two-sided dance and the remote's fresh reveal may
            # have landed before this side's wipe — losing it would
            # deadlock the exchange (push-based sync needs the holder
            # to know the receiver's clock). The hub's own believed
            # clocks are NOT safe to carry: they advance optimistically
            # at send time while the frames may have died in the
            # partition buffer. A stale genuine clock only fattens the
            # delta; application dedups idempotently.
            injected = False
            for (r_id, doc_id), clock in link._last_reveal.items():
                if r_id == room_id:
                    hub.note_clock(peer_id, doc_id, clock)
                    injected = True
            if injected:
                hub.flush()

    def _deliver_msg(self, origin: str, room_id: str, msg):
        """Inbound from a region link: validate, ensure the room is in
        the fabric (reply path), hand to the room hub as the origin
        region's peer."""
        room = self.svc.room(room_id)   # creates lazily — a remote
        self._attach_rooms()            # region can introduce a room
        room.hub._receive(f"region:{origin}", validate_msg(msg),
                          validated=True)

    # -- driving --------------------------------------------------------

    def pump(self) -> int:
        """One federation round: attach any new rooms, then move every
        link (chaos edge, channel timers, probes, ladder)."""
        self._attach_rooms()
        return sum(link.pump() for link in self.links.values())

    def idle(self) -> bool:
        return all(link.idle() for link in self.links.values())

    # -- observability --------------------------------------------------

    def lag_table(self) -> dict:
        """``{remote: {"state": rung, "lag_tokens": n}}`` — the
        cross-region health view the soak and tests assert on."""
        return {remote: {"state": link.state,
                         "lag_tokens": link.lag()}
                for remote, link in self.links.items()}

    def describe(self) -> dict:
        """The federation block of ``SyncService.describe()``."""
        return {"region": self.name,
                "group_clock": {"minted": self.clock.stats["minted"],
                                "observed": self.clock.stats["observed"],
                                "stale": self.clock.stats["stale"],
                                "rooms": len(self.clock.table())},
                **({"placement_epoch": self.placement.epoch,
                    "placement": self.placement.table()}
                   if self.placement is not None else {}),
                "links": {r: ln.describe()
                          for r, ln in self.links.items()}}

    def families(self, prefix: str = "amtpu_region") -> list:
        """Prometheus families for the service scrape page: per-link
        lag/state gauges, ladder transition counters, ship/deliver and
        buffer counters, and the group-clock totals.  Cardinality is
        O(links) + O(transition kinds) — never per-room or per-change."""
        base = {"region": self.name}
        lag, up, state = [], [], []
        trans, shipped, delivered, dropped, revives = [], [], [], [], []
        for remote, link in self.links.items():
            lbl = {**base, "peer": remote}
            lag.append((lbl, link.lag()))
            up.append((lbl, 1 if link.state in ("ok", "lagged") else 0))
            state.append(({**lbl, "state": link.state}, 1))
            shipped.append((lbl, link.stats["shipped"]))
            delivered.append((lbl, link.stats["delivered"]))
            dropped.append((lbl, link.stats["buffer_dropped"]))
            revives.append((lbl, link.chan.stats["revives"]))
            for key, n in sorted(link.transitions.items()):
                frm, _, to = key.partition("->")
                trans.append(({**lbl, "from": frm, "to": to}, n))
        cs = self.clock.stats
        return [
            (f"{prefix}_lag_tokens", "gauge",
             "Cross-region replication lag in pending group tokens "
             "(un-acked + partition-buffered); zero at quiescence.",
             lag),
            (f"{prefix}_link_up", "gauge",
             "1 while the region link is on the healthy rungs "
             "(ok/lagged), 0 while partitioned or healing.", up),
            (f"{prefix}_link_state", "gauge",
             "Current degradation-ladder rung (one series per link, "
             "value 1, rung in the `state` label).", state),
            (f"{prefix}_transitions_total", "counter",
             "Degradation-ladder transitions per link and edge.", trans),
            (f"{prefix}_shipped_total", "counter",
             "Envelopes shipped to each peer region.", shipped),
            (f"{prefix}_delivered_total", "counter",
             "Envelopes delivered exactly-once from each peer region.",
             delivered),
            (f"{prefix}_buffer_dropped_total", "counter",
             "Partition-buffered payload envelopes dropped at the "
             "bounded buffer cap (recomputed from clocks at heal).",
             dropped),
            (f"{prefix}_channel_revives_total", "counter",
             "Reconnect epochs started per link (partition heals).",
             revives),
            (f"{prefix}_group_tokens_minted_total", "counter",
             "Ordering tokens minted by this region (one per (room, "
             "encode group) — O(groups), not O(peers)).",
             [(base, cs["minted"])]),
            (f"{prefix}_group_tokens_observed_total", "counter",
             "Fresh ordering tokens observed from peer regions.",
             [(base, cs["observed"])]),
        ]


def connect_regions(a: FederatedRegion, b: FederatedRegion, *,
                    profile: str = "cross_region", seed: int = 0):
    """Join two regions with a full-duplex WAN link: one RegionLink
    endpoint each, transported over a seeded asymmetric chaos pair
    (``resilience.chaos.WAN_PROFILES``).  Returns
    ``(a_link, b_link, fwd_chaos, rev_chaos)`` — tests and the soak
    drive partitions through the chaos edges' partition()/heal()."""
    a_link = a.link_to(b.name, seed=seed)
    b_link = b.link_to(a.name, seed=seed + 1)
    fwd, rev = wan_pair(b_link.on_raw, a_link.on_raw,
                        profile=profile, seed=seed)
    a_link.attach_transport(fwd)
    b_link.attach_transport(rev)
    return a_link, b_link, fwd, rev
