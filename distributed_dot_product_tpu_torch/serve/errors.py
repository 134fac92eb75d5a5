# -*- coding: utf-8 -*-
"""
Typed narrowing of a builtin exception on the serving host surface,
copied from ``distributed_dot_product_tpu/serve/errors.py`` (its
router-only ``UnknownReplicaError`` comes with the router).
"""

__all__ = ['ServeContractError']


class ServeContractError(ValueError):
    """The caller broke a serving-surface contract (an unsupported
    argument combination, a mis-shaped batch, a paged-only feature on
    a slab engine). A subclass of ValueError so existing callers'
    ``except ValueError`` handlers keep working."""
