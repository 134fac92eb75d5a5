# -*- coding: utf-8 -*-
"""
Observability for the port's serving path, copied from
``distributed_dot_product_tpu/obs``: host-side spans (``spans``), the
schema-versioned JSONL event log (``events``), the incident flight
recorder (``flight``), per-request timelines rebuilt from the log
(``timeline``), goodput-under-SLO accounting (``slo``), online anomaly
detection (``anomaly``), post-mortem diagnosis (``doctor``), critical-path
latency attribution (``critpath``), the Perfetto export (``trace``) and
the offline CLI (``python -m distributed_dot_product_tpu_torch.obs``).
The reference's exporter, devmon and perf modules are not ported yet
(ROADMAP §1 item 5).
"""

from distributed_dot_product_tpu_torch.obs.anomaly import (  # noqa: F401
    AnomalyWatchdog, EwmaZScore, RateOfChange, StaticThreshold, Watch,
    default_watches,
)
from distributed_dot_product_tpu_torch.obs.events import (  # noqa: F401
    EVENT_SCHEMA, SCHEMA_VERSION, EventLog, activate, emit, get_active,
    merge_events, open_from_env, read_events, remove_log, set_active,
    validate_file,
)
from distributed_dot_product_tpu_torch.obs.flight import (  # noqa: F401
    FlightRecorder, device_stats_snapshot, load_bundle,
)
from distributed_dot_product_tpu_torch.obs.slo import (  # noqa: F401
    SloReport, SloSpec, check_baseline, goodput,
)
from distributed_dot_product_tpu_torch.obs.spans import (  # noqa: F401
    SpanCollector, SpanRecord, collecting, enable, enabled,
    get_collector, span, spanned,
)
from distributed_dot_product_tpu_torch.obs.timeline import (  # noqa: F401
    Timeline, reconstruct, timeline,
)
