# -*- coding: utf-8 -*-
"""Seeded flowlint shard-ownership regressions: host code re-deriving
the ``pages_per_shard + 1`` contiguous-ownership stride instead of
going through the ShardedPageTable helpers (analysis/flowlint.py).
The contiguous layout has exactly one home — models/decode.py."""


def leaky_global_page(cache, shard, page):
    return shard * (cache.pages_per_shard + 1) + page  # VIOLATION: shard-ownership


def leaky_owner(cache, gpage):
    return gpage // (cache.pages_per_shard + 1)  # VIOLATION: shard-ownership


def owned_global_page(cache, shard, page):
    return cache.gpage(shard, page)


def owned_owner(cache, gpage):
    return cache.page_shard(gpage)
