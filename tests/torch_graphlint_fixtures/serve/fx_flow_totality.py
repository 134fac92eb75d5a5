# -*- coding: utf-8 -*-
"""Seeded flowlint handler-totality regressions: ``except`` clauses
that catch a TYPED serving error and then drop it on the floor — no
re-raise, no event/metric routing, no payload consumption
(analysis/flowlint.py). The local ``RejectedError`` shadows the real
one by NAME: handler-totality keys on the TOTALITY_BASES names plus
in-universe subclasses, so the fixture stays standalone."""


class RejectedError(Exception):
    def __init__(self, reason):
        super().__init__(reason)
        self.reason = reason


class QuotaError(RejectedError):
    """In-universe subclass: the totality closure must reach it."""


def swallow(op):
    try:
        op()
    except RejectedError:  # VIOLATION: handler-totality
        pass


def swallow_subclass(op):
    try:
        op()
    except QuotaError as e:  # VIOLATION: handler-totality
        print(e)


def reraise_is_total(op):
    try:
        op()
    except RejectedError:
        raise


def consume_payload_is_total(op, rejected):
    try:
        op()
    except RejectedError as e:
        rejected['last'] = e.reason


def emit_is_total(op, log):
    try:
        op()
    except RejectedError as e:
        log.emit('serve.reject', **_payload(e))


def _note_reject(log, e):
    log.emit('serve.reject', **_payload(e))


def transitive_route_is_total(op, log):
    # The emit lives one intra-package call away: the may-emit
    # fixpoint, not the handler body, is the enforcement surface.
    try:
        op()
    except RejectedError as e:
        _note_reject(log, e)


def untyped_catch_is_out_of_scope(op):
    # astlint owns generic silent-except hygiene; flowlint only judges
    # the TYPED serving contract.
    try:
        op()
    except ValueError:
        return None


def _payload(e):
    return {'reason': str(e)}
