# -*- coding: utf-8 -*-
"""
Typed narrowings of builtin exceptions on the serving host surface,
copied from ``distributed_dot_product_tpu/serve/errors.py``: every
exception leaving ``Scheduler.step/submit``, ``Router.step/submit`` or
``KernelEngine.step/prefill/verify_step`` carries a type the operator can
dispatch on, while the subclasses keep existing ``except ValueError`` /
``except KeyError`` callers working.
"""

__all__ = ['ServeContractError', 'UnknownReplicaError']


class ServeContractError(ValueError):
    """The caller broke a serving-surface contract (an unsupported
    argument combination, a mis-shaped batch, a paged-only feature on
    a slab engine). A subclass of ValueError so existing callers'
    ``except ValueError`` handlers keep working."""


class UnknownReplicaError(KeyError):
    """A replica name that is not (or no longer) a pool member. A
    subclass of KeyError so existing ``except KeyError`` callers keep
    working; ``str()`` renders the message without KeyError's repr
    quoting."""

    def __str__(self):
        return self.args[0] if self.args else ''
