# -*- coding: utf-8 -*-
"""
Static analysis of the port, counterpart of
``distributed_dot_product_tpu/analysis``. Ported so far: the central
entrypoint registry (:mod:`.registry`) that ``obs/perf.py`` runs. The
reference's linters (its jaxpr rules, retrace sentinel and AST engines)
are still to come; the registry keeps the fields they read.

This ``__init__`` stays import-light: the layer modules import nothing
from here at module level.
"""
