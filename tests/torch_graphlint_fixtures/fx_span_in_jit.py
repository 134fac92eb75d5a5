"""Seeded span-in-jit regression: an obs span inside a compiled function
(reads the host clock at TRACE time — the recorded span describes
compilation, not execution). Spans wrap host-side dispatch only."""
import torch

from distributed_dot_product_tpu_torch.obs import span, spanned


@torch.compile
def spanned_step(x):
    with span('step'):           # VIOLATION: clock-in-jit
        return x * 2


@torch.compile
def decorated_body(x):
    y = spanned('inner')(lambda v: v + 1)(x)   # VIOLATION
    return y


def fine_host_span(step, x):
    with span('dispatch'):       # outside compile: NOT flagged
        return step(x)
