"""setup_s (host clock): from the process's start to the window's start:
imports, the card's initialisation, the kernels' build or load, the
problem's build (the race car's cold solve) and the warm-up of the cell's
shapes."""
SOURCE = "host_clock"


def read(ctx):
    return ctx.setup_s
