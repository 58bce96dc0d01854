"""sync_wait_share.loop (program span): the host's blocking reads of the
device (sync spans) over the batch.solve root spans, in %, host time of
the traced run's steps outside the profiled ones (layer: host dispatch)."""
from port_bench.pb import program_spans

SOURCE = "program_span"
program_spans.start()


def read(ctx):
    return program_spans.share(program_spans.reduce(), ("sync",),
                              ("batch.solve",))
