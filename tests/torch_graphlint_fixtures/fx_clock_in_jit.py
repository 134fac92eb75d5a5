"""Seeded clock-in-jit regression: a wall-clock read inside a compiled
function (bakes a constant into the compiled program)."""
import time

import torch
import torch.nn.functional as F  # noqa: F401


@torch.compile
def stamped_step(x):
    t = time.time()              # VIOLATION: clock-in-jit (line 11)
    return x + torch.tensor(t, dtype=torch.float32)


def fine_host_timing(fn, x):
    start = time.perf_counter()  # outside compile: NOT flagged
    out = fn(x)
    return out, time.perf_counter() - start
