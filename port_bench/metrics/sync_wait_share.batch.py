"""sync_wait_share.batch (program span): the host's blocking reads of the
device (sync spans) over the batch.solve and refine.solve root spans, in
%, host time of the traced run's batches outside the profiled ones (layer:
host dispatch)."""
from port_bench.pb import program_spans

SOURCE = "program_span"
program_spans.start()


def read(ctx):
    return program_spans.share(program_spans.reduce(), ("sync",),
                              ("batch.solve", "refine.solve"))
