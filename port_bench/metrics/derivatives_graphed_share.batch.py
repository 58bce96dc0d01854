"""derivatives_graphed_share.batch (program counter): the model's
derivative evaluations on the card replayed from a CUDA graph, over those
replayed or run eager (the program's counters derivatives.replay and
derivatives.eager; captures count in neither), in %, over the batch.solve
roots and the certify's refine.solve roots of the traced run's batches
outside the profiled ones (layer: model derivatives).  Nothing where the
program has no such counters."""
from port_bench.pb import program_spans

SOURCE = "program_counter"
program_spans.start()


def read(ctx):
    roots = program_spans.reduce()
    if not roots:
        return None
    picked = [r["counts"] for r in roots
              if r["name"] in ("batch.solve", "refine.solve")]
    replay = sum(c.get("derivatives.replay", 0) for c in picked)
    eager = sum(c.get("derivatives.eager", 0) for c in picked)
    return 100.0 * replay / (replay + eager) if replay + eager else None
