# -*- coding: utf-8 -*-
"""
Continuous-batching serving for the PyTorch port, from
``distributed_dot_product_tpu/serve``: the :class:`KernelEngine` (a
greedy LM over the per-slot slab or paged KV cache and the fused decode
kernels K5 / K5p) and the :class:`Scheduler` that drives it (admission
with typed rejections, chunked prefill, the degradation ladder,
eviction, NaN quarantine with requeue, page-pressure preemption and the
stall watchdog).

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
from distributed_dot_product_tpu_torch.serve.engine import (  # noqa: F401
    KernelEngine, PageCorruptionError,
)
from distributed_dot_product_tpu_torch.serve.errors import (  # noqa: F401
    ServeContractError,
)
from distributed_dot_product_tpu_torch.serve.health import (  # noqa: F401
    HealthMonitor, Liveness, Readiness,
)
from distributed_dot_product_tpu_torch.serve.scheduler import (  # noqa: F401
    Scheduler, ServeConfig,
)
