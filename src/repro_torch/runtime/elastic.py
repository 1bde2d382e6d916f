"""Elastic membership: who is in a replicated worker set (port of
``repro/runtime/elastic.py``'s ``MemberState`` and ``ElasticGroup``,
:34-115).

Members join, drain (stop taking new work while finishing what they
hold) and retire; every transition bumps a monotonic epoch and lands in an
append-only log, so two observers that replay the same calls agree on the
active set and its order.  The serving router builds replica lifecycle on
it.  The reference's ``elastic_remesh`` (re-placing a training state on a
new device mesh) needs a mesh and waits for the multi-device slice
(ROADMAP 1.11).
"""
from __future__ import annotations

import enum
from typing import Hashable


class MemberState(enum.Enum):
    ACTIVE = "active"        # in the placement set
    DRAINING = "draining"    # no new work; resident work departs/migrates
    RETIRED = "retired"      # left the group; id is never reused


#: legal lifecycle transitions (anything else raises)
_TRANSITIONS = {
    MemberState.ACTIVE: (MemberState.DRAINING, MemberState.RETIRED),
    MemberState.DRAINING: (MemberState.RETIRED,),
    MemberState.RETIRED: (),
}


class ElasticGroup:
    """Deterministic membership for an elastic worker set.

    Join order is the canonical iteration order: :meth:`active` returns ids
    sorted by join epoch, so a placement policy over it (round-robin
    cursors, least-pressure tie-breaks) replays exactly.  ``epoch`` grows
    on every transition; :attr:`transitions` is the append-only ``(epoch,
    member, old_state, new_state)`` log.
    """

    def __init__(self):
        self.epoch = 0
        self._states: dict[Hashable, MemberState] = {}
        self._join_epoch: dict[Hashable, int] = {}
        self.transitions: list[tuple] = []

    def _move(self, member: Hashable, new: MemberState) -> int:
        old = self._states.get(member)
        if new is MemberState.ACTIVE:
            if old is not None:
                raise ValueError(f"member {member!r} already joined "
                                 f"(state {old.name})")
        elif old is None:
            raise KeyError(f"member {member!r} never joined")
        elif new not in _TRANSITIONS[old]:
            raise ValueError(f"member {member!r}: illegal transition "
                             f"{old.name} -> {new.name}")
        self.epoch += 1
        self._states[member] = new
        self.transitions.append((self.epoch, member, old, new))
        return self.epoch

    def join(self, member: Hashable) -> int:
        """Add a member to the active set; returns its join epoch (the next
        placement decision already sees it)."""
        epoch = self._move(member, MemberState.ACTIVE)
        self._join_epoch[member] = epoch
        return epoch

    def drain(self, member: Hashable) -> int:
        """ACTIVE -> DRAINING: out of the placement set at once."""
        return self._move(member, MemberState.DRAINING)

    def retire(self, member: Hashable) -> int:
        """Leave the group for good (from ACTIVE or DRAINING)."""
        return self._move(member, MemberState.RETIRED)

    def state(self, member: Hashable) -> MemberState:
        return self._states[member]

    def is_active(self, member: Hashable) -> bool:
        return self._states.get(member) is MemberState.ACTIVE

    def active(self) -> tuple:
        """Active member ids in join order (the placement order)."""
        return tuple(sorted(
            (m for m, s in self._states.items()
             if s is MemberState.ACTIVE),
            key=self._join_epoch.__getitem__))

    def members(self) -> tuple:
        """All non-retired ids in join order (draining included)."""
        return tuple(sorted(
            (m for m, s in self._states.items()
             if s is not MemberState.RETIRED),
            key=self._join_epoch.__getitem__))
