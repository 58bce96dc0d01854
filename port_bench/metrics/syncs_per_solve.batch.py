"""syncs_per_solve.batch (program counter): the program's sync counter over
the batch.solve root and its certify (the refine.solve roots, and the
program's blocking reads that the certify's stage glue makes outside them,
each a sync root), per batch, over the traced run's batches outside the
profiled ones (layer: host dispatch)."""
from port_bench.pb import program_spans

SOURCE = "program_counter"
program_spans.start()


def read(ctx):
    return program_spans.per_unit(program_spans.reduce(), "sync",
                                 ("batch.solve", "refine.solve", "sync"),
                                 "batch.solve")
