"""refine_share.batch (program span): the certify's Newton-KKT refinements
(refine.solve root spans) over the batch.solve and refine.solve root
spans, in %, host time of the traced run's batches outside the profiled
ones; the in-program twin of certify_share.batch, without the harness's
stage glue (layer: certify)."""
from port_bench.pb import program_spans

SOURCE = "program_span"
program_spans.start()


def read(ctx):
    return program_spans.share(program_spans.reduce(), ("refine.solve",),
                              ("batch.solve", "refine.solve"))
