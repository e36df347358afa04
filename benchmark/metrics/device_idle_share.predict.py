"""Device idle share of serving: 1 - the union of the device's activities
over the traced requests' wall time, in %."""


def read(ctx):
    red = ctx.get("trace")
    if red is None or red["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])
