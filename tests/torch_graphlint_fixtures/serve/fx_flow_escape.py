# -*- coding: utf-8 -*-
"""Seeded flowlint typed-escape regressions: untyped builtins escaping
declared serving roots (analysis/flowlint.py). The module literals
``FLOWLINT_ROOTS`` / ``FLOWLINT_CONTRACT`` stand in for the central
SERVING_ROOTS / TYPED_CONTRACT tables — the fixture is a standalone
universe. Each marked line is a production incident shape: the reference's
drive-found ``deque.remove`` untyped ValueError out of
``Scheduler.step`` is reproduced verbatim by ``Server.submit``."""

from collections import deque

FLOWLINT_ROOTS = ('Server.step', 'Server.submit', 'run_ok')
FLOWLINT_CONTRACT = ('TypedServeError',)


class TypedServeError(Exception):
    """The fixture universe's whole typed-failure contract."""


def _pop_head(table, key):
    if key not in table:
        raise KeyError(key)  # VIOLATION: typed-escape
    return table.pop(key)


def _drain(table):
    # One hop between the root and the raise: the chain must render
    # step -> _drain -> _pop_head (two hops, three frames).
    return _pop_head(table, 'head')


class Server:
    def __init__(self):
        self.pending = deque()
        self.table = {}

    def step(self):
        return _drain(self.table)

    def submit(self, req):
        self.pending.append(req)
        if req is None:
            # The reference's regression shape: deque.remove walks __eq__
            # over every queued request (numpy prompt fields make the
            # comparison itself blow up) and raises an untyped
            # ValueError when nothing matches.
            self.pending.remove(req)  # VIOLATION: typed-escape
        return len(self.pending)

    def refuse(self, req):
        # In-contract raise: never flagged.
        raise TypedServeError(req)


def _tail(xs):
    if not xs:
        # Deliberate, enumerable debt: the pragma keeps this VISIBLE
        # as an allowed record instead of silently dropping it.
        raise IndexError('empty')  # flowlint: allow[typed-escape]
    return xs[-1]


def run_ok(xs):
    return _tail(xs)
