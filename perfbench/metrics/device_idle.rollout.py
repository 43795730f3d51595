"""The share of the profiled span (first device start to last device end)
in which no operation ran on the device."""


def read(ctx):
    p = ctx.profile
    if not p or p['span_s'] <= 0:
        return None
    return 100.0 * (1.0 - p['busy_s'] / p['span_s'])
