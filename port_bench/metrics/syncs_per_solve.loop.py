"""syncs_per_solve.loop (program counter): the program's sync counter per
batch.solve root span, one a step, over the traced run's steps outside
the profiled ones (layer: host dispatch)."""
from port_bench.pb import program_spans

SOURCE = "program_counter"
program_spans.start()


def read(ctx):
    return program_spans.per_unit(program_spans.reduce(), "sync",
                                 ("batch.solve",), "batch.solve")
