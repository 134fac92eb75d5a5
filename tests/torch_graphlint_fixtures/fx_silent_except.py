"""Seeded silent-except regression: a broad handler that neither
re-raises nor logs."""


def swallows(fn):
    try:
        return fn()
    except Exception:            # VIOLATION: silent-except (line 8)
        pass


def fine_logged(fn, log):
    try:
        return fn()
    except Exception as e:
        log.warning('fn failed: %s', e)
        return None


def fine_pragma(fn):
    try:
        return fn()
    except Exception:  # graphlint: allow[silent-except] fixture demo
        return None
