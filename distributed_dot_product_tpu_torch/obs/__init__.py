# -*- coding: utf-8 -*-
"""
Observability for the port's serving path, copied from
``distributed_dot_product_tpu/obs``: host-side spans (``spans``), the
schema-versioned JSONL event log (``events``) and the incident flight
recorder (``flight``). The reference's timeline, SLO, exporter, perf,
anomaly and doctor modules are not ported yet (ROADMAP).
"""

from distributed_dot_product_tpu_torch.obs.events import (  # noqa: F401
    EVENT_SCHEMA, SCHEMA_VERSION, EventLog, activate, emit, get_active,
    merge_events, open_from_env, read_events, remove_log, set_active,
    validate_file,
)
from distributed_dot_product_tpu_torch.obs.flight import (  # noqa: F401
    FlightRecorder, device_stats_snapshot, load_bundle,
)
from distributed_dot_product_tpu_torch.obs.spans import (  # noqa: F401
    SpanCollector, SpanRecord, collecting, enable, enabled,
    get_collector, span, spanned,
)
