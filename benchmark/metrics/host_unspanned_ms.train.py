"""Host ms per training step outside the step's spans: the wall of a step
run without the profiler less the time under its outermost spans (forward,
backward, update, reduce, light), which leaves Trainer.train_step's own
glue, its maintenance, the loop and the sync closing the stretch."""
from cellkit import host_spans

host_spans.arm()


def read(ctx):
    return host_spans.unspanned_ms(ctx)
