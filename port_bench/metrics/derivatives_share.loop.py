"""derivatives_share.loop (program span): the model's derivatives (the
spans sqp.hessian and sqp.derivatives) over the batch.solve root spans,
in %, host time of the traced run's steps outside the profiled ones
(layer: model derivatives)."""
from port_bench.pb import program_spans

SOURCE = "program_span"
program_spans.start()


def read(ctx):
    return program_spans.share(program_spans.reduce(),
                              ("sqp.hessian", "sqp.derivatives"),
                              ("batch.solve",))
