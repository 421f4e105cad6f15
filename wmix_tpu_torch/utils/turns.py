"""Calls that take turns on the host, handing the turn on at device reads.

A chain reads its device in the middle of a package (the AGC limiter's
loop condition, exact NS's window countdown), and such a read waits until
the device has run everything queued before it.  `ShardedRecordChain`
runs one call per shard with `take_turns`: each call has a thread of its
own, but only the one holding the turn runs, in shard order, and a call
that reaches a read (`read_bool`) first hands the turn to the next.  So
every shard's work up to its next read is issued before any shard waits
on its device, the devices run side by side, and the threads never
contend for the interpreter.  Outside `take_turns`, `read_bool(t)` is
`bool(t)`.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

_local = threading.local()


class _Turns:
    def __init__(self, n: int):
        self.cv = threading.Condition()
        self.live = list(range(n))      # the calls still running, in order
        self.turn = 0

    def _wait_for_turn(self, me: int) -> None:
        self.cv.wait_for(lambda: self.turn == me)

    def pass_on(self, me: int) -> None:
        """Hand the turn to the next live call and wait until it is back."""
        with self.cv:
            i = self.live.index(me)
            self.turn = self.live[(i + 1) % len(self.live)]
            self.cv.notify_all()
            self._wait_for_turn(me)

    def leave(self, me: int) -> None:
        with self.cv:
            i = self.live.index(me)
            self.live.remove(me)
            if self.live:
                self.turn = self.live[i % len(self.live)]
            self.cv.notify_all()


def read_bool(t) -> bool:
    """`bool(t)` of a one-element tensor; inside `take_turns` the turn is
    handed on before the read."""
    turns = getattr(_local, "turns", None)
    if turns is not None:
        turns.pass_on(_local.me)
    return bool(t)


def take_turns(calls) -> list:
    """Run the zero-argument `calls`, each in a thread of its own, taking
    turns as the module docstring says; their results in order.  An
    exception of a call is raised once every call has ended."""
    turns = _Turns(len(calls))

    def run(i):
        with turns.cv:
            turns._wait_for_turn(i)
        _local.turns, _local.me = turns, i
        try:
            return calls[i]()
        finally:
            _local.turns = None
            turns.leave(i)

    with ThreadPoolExecutor(len(calls)) as pool:
        futures = [pool.submit(run, i) for i in range(len(calls))]
    return [f.result() for f in futures]
