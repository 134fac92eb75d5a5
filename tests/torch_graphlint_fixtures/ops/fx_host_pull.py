"""Seeded host-pull regressions: host conversions of torch-derived values
in a hot-path ('ops/') module."""
import torch


def pulls_float(x):
    total = torch.sum(x)
    return float(total)          # VIOLATION: host-pull (line 8)


def pulls_item(x):
    return (x * 2).item()        # VIOLATION: host-pull (line 12)


def fine_static_config(scale):
    # float() on a static kwarg is NOT flagged (no jnp derivation).
    return torch.tensor(float(scale))
