"""derivatives_share.batch (program span): the model's derivatives (the
spans sqp.hessian, sqp.derivatives and refine.derivatives) over the
batch.solve and refine.solve root spans, in %, host time of the traced
run's batches outside the profiled ones (layer: model derivatives)."""
from port_bench.pb import program_spans

SOURCE = "program_span"
program_spans.start()


def read(ctx):
    return program_spans.share(
        program_spans.reduce(),
        ("sqp.hessian", "sqp.derivatives", "refine.derivatives"),
        ("batch.solve", "refine.solve"))
