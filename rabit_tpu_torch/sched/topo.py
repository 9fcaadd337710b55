"""Pure peer-pattern math for the collective schedules.

Shared by BOTH sides of the wire: the tracker calls
:func:`extra_link_peers` when computing each rank's linkset (so every
schedule's peers are wired at rendezvous, exactly like the tree/ring
links), and the engine-side ``Schedule.applies`` checks call the same
functions to decide whether the links a schedule needs actually exist.
Keeping one source of truth here is what makes "new algorithms are
data, not code forks" safe: a schedule that needs a peer the tracker
did not hand out simply reports ``applies() == False`` and the dispatch
falls back, instead of dying on a missing link.

No engine/tracker imports — this module must stay import-cycle-free
(tracker → sched.topo, engine → sched → sched.topo).

PyTorch-port counterpart of :mod:`rabit_tpu.sched.topo`, copied whole.
"""
from __future__ import annotations


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    return 1 << (n.bit_length() - 1)


def is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


# ---------------------------------------------------------------------
# recursive halving/doubling (Rabenseifner-style)
# ---------------------------------------------------------------------
def halving_peers(rank: int, world: int) -> set[int]:
    """Peers rank talks to under recursive halving/doubling allreduce.

    Non-power-of-two worlds fold the ``world - m`` extra ranks into a
    pre/post step: extra rank ``r >= m`` talks only to its fold partner
    ``r - m``; core ranks exchange with every XOR partner ``r ^ d`` for
    ``d`` in the power-of-two ladder, plus their fold extra if any.
    """
    if world < 2:
        return set()
    m = pow2_floor(world)
    if rank >= m:
        return {rank - m}
    peers = set()
    d = m >> 1
    while d:
        peers.add(rank ^ d)
        d >>= 1
    if rank + m < world:
        peers.add(rank + m)
    return peers


# ---------------------------------------------------------------------
# Swing-style short-cut ring (distance-doubling over the ring order)
# ---------------------------------------------------------------------
def rho(h: int) -> int:
    """Swing step distance: 1, -1, 3, -5, 11, -21, ... — the partial
    sums of (-2)**i, so consecutive steps jump in alternating
    directions with doubling reach (Swing, PAPERS.md)."""
    return (1 - (-2) ** (h + 1)) // 3


def swing_peer(rank: int, world: int, step: int) -> int:
    """Peer of ``rank`` at Swing step ``step``: even ranks move
    ``+rho``, odd ranks ``-rho`` around the ring, which pairs every
    rank with exactly one partner per step (an involution for even
    worlds)."""
    d = rho(step)
    return (rank + d) % world if rank % 2 == 0 else (rank - d) % world


def swing_steps(world: int) -> int:
    """log2(world) for the power-of-two worlds Swing runs on."""
    return max(world.bit_length() - 1, 0)


def swing_peers(rank: int, world: int) -> set[int]:
    if not is_pow2(world) or world < 2:
        return set()
    return {swing_peer(rank, world, h) for h in range(swing_steps(world))}


# ---------------------------------------------------------------------
# hierarchical two-level (intra-host leader + cross-host leader ring)
# ---------------------------------------------------------------------
def group_leader(groups: list[int], gid: int,
                 demoted=()) -> int:
    """Leader of one group: the minimum rank NOT in ``demoted`` (the
    adaptive controller's straggler-demotion set — a persistently late
    rank must not anchor the cross-host leader ring).  Falls back to
    the plain minimum rank when the whole group is demoted: a degraded
    leader still beats no schedule at all, and every rank computes the
    same fallback."""
    demoted = frozenset(demoted)
    best: tuple[int, int] | None = None
    for rank, g in enumerate(groups):
        if g != gid:
            continue
        pref = (1 if rank in demoted else 0, rank)
        if best is None or pref < best:
            best = pref
    assert best is not None, f"group {gid} has no members"
    return best[1]


def group_leaders(groups: list[int], demoted=()) -> list[int]:
    """Leader of each group (see :func:`group_leader`), in ascending
    rank order.  One O(world) pass — this sits on the hierarchical
    schedule's per-dispatch ``applies()`` path: per group, keep the
    (not-demoted, rank)-minimal member, which IS "min non-demoted rank,
    else min rank"."""
    demoted = frozenset(demoted)
    best: dict[int, tuple[int, int]] = {}
    for rank, gid in enumerate(groups):
        pref = (1 if rank in demoted else 0, rank)
        cur = best.get(gid)
        if cur is None or pref < cur:
            best[gid] = pref
    return sorted(r for _d, r in best.values())


def group_members(groups: list[int], rank: int) -> list[int]:
    """Ranks sharing ``rank``'s group, ascending."""
    gid = groups[rank]
    return [r for r, g in enumerate(groups) if g == gid]


def hier_peers(rank: int, world: int, groups: list[int],
               demoted=()) -> set[int]:
    """Peers for the two-level schedule: members link to their group
    leader; leaders additionally link to their neighbors on the
    cross-host leader ring.  Only handed out for true multi-group
    topologies — with one group the schedule would degenerate to a
    star on rank 0, which scales worse than the tree it would replace.
    ``demoted`` excludes straggler-demoted ranks from leadership (the
    tracker passes the job's demotion set at rendezvous; the engine's
    ``applies()`` check passes the same set from its topology reply,
    so both sides agree on the links)."""
    if world < 2 or len(groups) != world or len(set(groups)) < 2:
        return set()
    members = group_members(groups, rank)
    leader = group_leader(groups, groups[rank], demoted)
    if rank != leader:
        return {leader}
    peers = {r for r in members if r != rank}
    leaders = group_leaders(groups, demoted)
    if len(leaders) > 1:
        li = leaders.index(rank)
        peers.add(leaders[(li - 1) % len(leaders)])
        peers.add(leaders[(li + 1) % len(leaders)])
    return peers


# ---------------------------------------------------------------------
# tracker-side union
# ---------------------------------------------------------------------
def extra_link_peers(rank: int, world: int,
                     groups: list[int] | None = None,
                     demoted=()) -> set[int]:
    """Union of every schedule's extra peers for one rank — what the
    tracker adds to the tree/ring linkset at rendezvous.  O(log world)
    extra links per rank (plus group-local links on leaders), so the
    handout stays sparse at scale.  ``demoted`` shifts the hierarchical
    leader links away from straggler-demoted ranks; the union ALSO
    keeps the undemoted leader links wired, so a later reinstatement
    epoch never meets a missing link."""
    peers = halving_peers(rank, world) | swing_peers(rank, world)
    if groups:
        peers |= hier_peers(rank, world, groups)
        if demoted:
            peers |= hier_peers(rank, world, groups, demoted)
    peers.discard(rank)
    return peers
