# -*- coding: utf-8 -*-
"""
Continuous-batching serving for the PyTorch port, from
``distributed_dot_product_tpu/serve``: the :class:`KernelEngine` (a
greedy LM over the per-slot slab or paged KV cache and the fused decode
kernels K5 / K5p) and the :class:`Scheduler` that drives it (admission
with typed rejections, chunked prefill, the degradation ladder,
eviction, NaN quarantine with requeue, page-pressure preemption, the
stall watchdog and speculative decoding with the n-gram and draft-model
proposers of :mod:`.spec`); the scheduling policy (:mod:`.policy`:
priority classes, per-tenant fair share, deadline-aware eviction, the
TTFT-tuned prefill boost) and the seeded open-loop multi-tenant load
generator that drives the Scheduler on a virtual clock (:mod:`.loadgen`);
and disaggregated serving (:mod:`.replica`, :mod:`.router`): a prefill
pool handing prompts' KV pages to decode replicas behind a
:class:`Router` with prefix-affinity placement, liveness probes, stream
recovery and page-integrity healing, which ``run_trace`` drives like one
Scheduler; seeded replica chaos on it (:class:`ChaosSchedule`) and the
closed-loop controller (:mod:`.control`: watchdog-driven watermark and
queue-bound actuation, elastic decode scaling with drain).

Usage::

    engine = KernelEngine(slots=8, t_max=4096, cache_mode='paged')
    with Scheduler(engine, ServeConfig(queue_limit=64,
                                       max_new_tokens=256)) as sched:
        req = sched.submit(prompt)
        sched.run_until_idle()
        sched.results[req.id].tokens
"""

from distributed_dot_product_tpu_torch.serve.admission import (  # noqa: F401
    AdmissionController, RejectedError, RejectReason, Request,
    RequestResult,
)
from distributed_dot_product_tpu_torch.serve.control import (  # noqa: F401
    ControlConfig, Controller,
)
from distributed_dot_product_tpu_torch.serve.engine import (  # noqa: F401
    KernelEngine, PageCorruptionError,
)
from distributed_dot_product_tpu_torch.serve.errors import (  # noqa: F401
    ServeContractError, UnknownReplicaError,
)
from distributed_dot_product_tpu_torch.serve.health import (  # noqa: F401
    HealthMonitor, Liveness, Readiness,
)
from distributed_dot_product_tpu_torch.serve.loadgen import (  # noqa: F401
    Arrival, ChaosSchedule, LoadGenConfig, LoadResult, TenantSpec,
    VirtualClock, default_tenants, generate_trace, load_trace, run_load,
    run_trace, save_trace,
)
from distributed_dot_product_tpu_torch.serve.policy import (  # noqa: F401
    PolicyConfig, SchedulingPolicy, TenantPolicy,
)
from distributed_dot_product_tpu_torch.serve.replica import (  # noqa: F401
    DecodeReplica, PrefillPool, PrefixHandle, ReplicaPool, TopologyConfig,
    maybe_init_distributed, parse_topology,
)
from distributed_dot_product_tpu_torch.serve.router import (  # noqa: F401
    Router, RouterConfig, build_serving,
)
from distributed_dot_product_tpu_torch.serve.scheduler import (  # noqa: F401
    Scheduler, ServeConfig,
)
from distributed_dot_product_tpu_torch.serve.spec import (  # noqa: F401
    DraftEngineProposer, NgramProposer, Proposer, make_draft_engine,
    ngram_propose,
)
