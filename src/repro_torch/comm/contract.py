"""Declared collective-schedule contracts (``COMM_CONTRACT``).

Port of ``repro.comm.contract``.  The paper's headline claim is
*communication avoidance*: the 1.5D schedules move provably fewer words
than a 2D layout.  A refactor that silently adds an all-reduce, drops a
ring round, or widens a wire dtype destroys that property without failing
a single numeric test, so every module that posts collectives DECLARES
its schedule as data: ``comm.matmul1p5d``, ``comm.sparse1p5d`` and
``core.distributed`` each export ``COMM_CONTRACT``, a dict mapping the
entry-point function name to a :class:`CommContract`.

The reference verifies the declarations against the schedule it traces
out of a jaxpr (``repro.analysis.commpass``); that engine is not ported.
In the port the wrappers of ``comm.group`` announce every collective they
post to a watcher, and the tests hold the watched bytes of each product
equal to its contract's ``volume``.

Conventions (shared with ``core.costmodel.collective_wire_bytes``):
bytes-on-wire are counted per processor along the critical path, the
paper's W measure — a ppermute ships its payload once (zero if the
permutation is the identity), a ring all-gather over extent E ships
(E-1) input shards, a bandwidth-optimal all-reduce ships 2.(E-1)/E
payloads, an all-to-all ships (E-1)/E.  Counts are exact
:class:`fractions.Fraction`s, so the check is an equality.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


@dataclass(frozen=True)
class CommContract:
    """One entry point's declared collective schedule.

    Callable fields receive the entry's ``params`` dict (spread as
    keyword arguments), so a contract can be exact at any shape.
    """

    #: dotted name of the entry point this contract binds to (display)
    entry: str
    #: grid axes the schedule may bind; None = any
    axes: tuple[str, ...] | None = None
    #: collective primitive names the schedule may post (None = any)
    kinds: tuple[str, ...] | None = None
    #: expected ring length of every ppermute-bearing loop, as an int or
    #: ``params -> int`` (None = no round contract)
    rounds: int | Callable[..., int] | None = None
    #: dtypes allowed on the wire.  Literal dtype names plus two
    #: wildcards: "operand" (any dtype of the entry's operands — the
    #: solve dtype) and "mask" (``core.matops.MASK_DTYPE``, int8).
    #: None = no wire policy.
    wire: tuple[str, ...] | None = None
    #: expected total bytes-on-wire per invocation, as ``params ->
    #: Fraction|int`` (None = no volume contract)
    volume: Callable[..., object] | None = None
    #: human label of the schedule family, e.g. "ring+allgather"
    volume_class: str = ""
    #: free-form knobs
    extra: dict = field(default_factory=dict)

    def expected_rounds(self, params: dict) -> int | None:
        if self.rounds is None or isinstance(self.rounds, int):
            return self.rounds
        return int(self.rounds(**params))

    def expected_volume(self, params: dict):
        if self.volume is None:
            return None
        return self.volume(**params)
