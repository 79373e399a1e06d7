"""The tensor-parallel engine's lockstep (one process per rank).

The reference leads its mesh from one controller: one ``Engine`` whose
programs are ``shard_map``s. Here every rank of a model group builds its own
``Engine(mesh=...)`` and runs the same programs on its shard, so every rank
must make the same scheduling decisions step for step. Model rank 0 is the
leader: it takes ``submit``, ``cancel``, ``restore`` and
``reset_prefix_cache`` from its caller, records them instead of applying
them, and before each ``step()`` (or ``warmup()``) broadcasts the records to
the other ranks on the mesh's gloo side group (``broadcast_object_list``),
with its own clock reading. Every rank, the leader included, then applies the
same records in the same order and runs the same step; the other ranks do so
in ``Engine.follow()`` until the leader sends a stop. The page allocator, the
radix cache and the counter-keyed draws are deterministic, and every decision
that depends on time (``sjf`` aging, arrival order) reads the leader's clock
and arrival times, so the ranks agree.

A message is ``(action, now, ops, token_pieces)``: ``action`` one of
"step", "warmup", "stop"; ``ops`` a list of picklable records; the leader's
``token_pieces`` ride along once, the first time it has them (constrained
decoding selects tokens on the host, on every rank).
"""

from __future__ import annotations

import threading
from typing import List, Tuple

import torch.distributed as dist


class Lockstep:
    """The leader's record of calls since its last broadcast, and the
    broadcast itself. ``messages`` counts the messages sent or received."""

    def __init__(self, mesh):
        self.group = mesh.control
        self.src = mesh.leader
        self.is_leader = mesh.model.index == 0
        self.size = mesh.model.size
        self._ops: List[Tuple[tuple, object]] = []  # (record, the leader's local object)
        self._lock = threading.Lock()
        self._pieces_sent = False
        self.messages = 0
        self.stopped = False  # the leader has sent "stop"

    def record(self, op: tuple, local=None) -> None:
        """Queue one call (leader only); ``local`` is the object the leader
        applies it with (a Request), which is not sent."""
        with self._lock:
            self._ops.append((op, local))

    def pending(self) -> bool:
        with self._lock:
            return bool(self._ops)

    def _bcast(self, msg=None):
        box = [msg]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        self.messages += 1
        return box[0]

    def lead(self, action: str, now: float, token_pieces=None):
        """Leader: send ``action`` with the queued records; returns (action,
        now, [(record, local)], token_pieces to install or None)."""
        if self.stopped:
            raise RuntimeError("this tensor-parallel engine's followers were stopped")
        self.stopped = action == "stop"
        with self._lock:
            ops, self._ops = self._ops, []
        pieces = None
        if token_pieces is not None and not self._pieces_sent:
            pieces, self._pieces_sent = token_pieces, True
        if self.size > 1:
            self._bcast((action, now, [op for op, _ in ops], pieces))
        return action, now, ops, pieces

    def receive(self):
        """Follower: the leader's next message, in ``lead``'s form (no local
        objects)."""
        action, now, ops, pieces = self._bcast()
        return action, now, [(op, None) for op in ops], pieces
