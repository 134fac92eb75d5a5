# -*- coding: utf-8 -*-
"""
Observability for the port's serving path, copied from
``distributed_dot_product_tpu/obs``: host-side spans (``spans``), the
schema-versioned JSONL event log (``events``), the incident flight
recorder (``flight``), per-request timelines rebuilt from the log
(``timeline``), goodput-under-SLO accounting (``slo``), online anomaly
detection (``anomaly``), post-mortem diagnosis (``doctor``), critical-path
latency attribution (``critpath``), the Perfetto export (``trace``), live
device-memory gauges and bounded ``torch.profiler`` captures
(``devmon``), the Prometheus exporter and its ``/metrics``, ``/healthz``,
``/profile`` and ``/dump`` endpoints (``exporter``), the program cost
and roofline accounting of every registered entrypoint with its
regression gate (``perf``; ``python -m
distributed_dot_product_tpu_torch.obs.perf snapshot|check|report``) and
the offline CLI (``python -m distributed_dot_product_tpu_torch.obs``).
"""

from distributed_dot_product_tpu_torch.obs.devmon import (  # noqa: F401
    CaptureInFlight, DeviceMonitor, ProfileCapture, device_stats_snapshot,
)
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
    FlightRecorder, load_bundle,
)
from distributed_dot_product_tpu_torch.obs.slo import (  # noqa: F401
    SloReport, SloSpec, check_baseline, goodput,
)
from distributed_dot_product_tpu_torch.obs.exporter import (  # noqa: F401
    MetricsServer, render_prometheus,
)
from distributed_dot_product_tpu_torch.obs.spans import (  # noqa: F401
    SpanCollector, SpanRecord, collecting, enable, enabled,
    get_collector, span, spanned,
)
from distributed_dot_product_tpu_torch.obs.timeline import (  # noqa: F401
    Timeline, reconstruct, timeline,
)


def graphlint_entrypoints():
    """Registration hook (``analysis/registry.py``): the serving engine's
    decode step run THROUGH a host-side span — the supported composition;
    its counts must equal the unspanned entry's
    (``serve.engine_decode``): a span adds no device work."""

    def spanned_decode(device):
        from distributed_dot_product_tpu_torch.analysis.registry import (
            HEAD_DIM,
        )
        from distributed_dot_product_tpu_torch.serve.engine import (
            KernelEngine, _engine_spec,
        )
        eng = KernelEngine(slots=2, t_max=16, head_dim=HEAD_DIM,
                           decode_impl='plain', cache_mode='slab',
                           device=device)
        return _engine_spec('obs.spanned_decode', eng,
                            wrap=lambda: span('obs.decode_dispatch'))

    return {'obs.spanned_decode': spanned_decode}
