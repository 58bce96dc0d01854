"""qp_share.batch (program span): the boxADMM solves (qp.solve spans) over
the batch.solve and refine.solve root spans, in %, host time of the traced
run's batches outside the profiled ones (layer: QP)."""
from port_bench.pb import program_spans

SOURCE = "program_span"
program_spans.start()


def read(ctx):
    return program_spans.share(program_spans.reduce(), ("qp.solve",),
                              ("batch.solve", "refine.solve"))
