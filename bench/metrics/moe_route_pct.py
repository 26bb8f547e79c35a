"""moe_route_pct: the device time under the program's ranges
``moe_dispatch`` and ``moe_combine`` (models/moe.py), their backwards
(``IndexPutBackward0``, ``IndexSelectBackward0``) charged to them, as a
share of the traced window. None where neither range ran."""

RANGES = (("moe_dispatch", "IndexPutBackward0"), ("moe_combine", "IndexSelectBackward0"))


def read(ctx):
    spent = sum(ctx.trace.range_s(name, backward) for name, backward in RANGES)
    if spent <= 0 or ctx.trace.window_s <= 0:
        return None
    return 100.0 * spent / ctx.trace.window_s
