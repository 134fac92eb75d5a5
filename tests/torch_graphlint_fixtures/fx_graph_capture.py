"""Seeded clock-in-jit regression, port only: a wall-clock read inside a
CUDA-graph capture (read once, at capture time, and replayed)."""
import time

import torch


def captured_step(static_x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        t = time.perf_counter()  # VIOLATION: clock-in-jit
        static_x.add_(1)
    return g, t


def fine_around_replay(g):
    start = time.perf_counter()  # outside the capture: NOT flagged
    g.replay()
    return time.perf_counter() - start
