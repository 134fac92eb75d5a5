# -*- coding: utf-8 -*-
"""Seeded protolint regressions: emit call sites that violate the
closed EVENT_SCHEMA vocabulary / required-field / typed-reject
contracts (obs/events.py, serve/admission.py). Each marked line is a
runtime ValueError waiting for an incident; protolint fails it at PR
time instead."""


def emit_unknown_kind(log, rid):
    log.emit('serve.launch', request_id=rid)  # VIOLATION: event-vocab


def emit_missing_fields(log, rid):
    log.emit('serve.admit', request_id=rid)  # VIOLATION: event-fields


def emit_untyped_reason(log, rid):
    log.emit('serve.reject', request_id=rid, tenant='t0',
             reason='because')               # VIOLATION: reject-reason


def emit_enum_without_value(log, rid, RejectReason):
    log.emit('serve.reject', request_id=rid, tenant='t0',
             reason=RejectReason.QUEUE_FULL)  # VIOLATION: reject-reason


def fine_complete_payloads(log, rid):
    log.emit('serve.admit', request_id=rid, slot=0, tenant='t0')
    log.emit('serve.reject', request_id=rid, reason='queue_full',
             tenant='t0')


def fine_forwarded_payload(log, rid, **fields):
    # **fields forwarding: statically incomplete, runtime validation
    # owns it — never judged.
    log.emit('serve.decode', request_id=rid, **fields)
