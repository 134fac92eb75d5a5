# -*- coding: utf-8 -*-
"""Dependency-free version info of the port: its own copy of the
reference package's ``VERSION_INFO`` (``distributed_dot_product_tpu/
_version.py``), re-exported by the package."""

VERSION_INFO = (0, 1, 0, 'dev0')
__version__ = '.'.join(map(str, VERSION_INFO[:3])) + (
    '.' + VERSION_INFO[3] if len(VERSION_INFO) > 3 else '')
