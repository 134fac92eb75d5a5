"""Seeded traced-bool-branch regression: python `if` on a traced
predicate in a hot-path module."""
import torch


def branches_on_traced(x):
    if torch.any(x > 0):           # VIOLATION: traced-bool-branch (line 7)
        return x * 2
    return x


def fine_identity_check(mask):
    m = torch.as_tensor(mask)
    if m is not None:            # identity check: NOT flagged
        return m
    return None
