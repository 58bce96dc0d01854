"""certified_solves_per_s (host clock): the lanes certified at the
configuration's tolerance in every batch of the window, over the window's
seconds (the window ends with the last batch, after a synchronise)."""
SOURCE = "host_clock"


def read(ctx):
    if ctx.kind != "batch":
        return None
    return sum(u["certified"] for u in ctx.units) / ctx.window_s
