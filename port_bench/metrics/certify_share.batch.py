"""certify_share.batch (program span): the certify stages' synchronised
host spans over the batches' walls, in %, over the traced run's batches
outside the profiled ones (all of them if every batch was profiled)
(layer: certify)."""
SOURCE = "program_span"


def read(ctx):
    n = ctx.profile["units"] if ctx.profile else 0
    units = ctx.units[n:] or ctx.units
    wall = sum(u["wall_s"] for u in units)
    cert = sum(u["spans"].get("certify", 0.0) for u in units)
    return 100.0 * cert / wall if wall > 0 and cert > 0 else None
