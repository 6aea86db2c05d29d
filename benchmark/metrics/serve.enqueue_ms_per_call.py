"""The host's time to run a served program's graph (the exported module's
call, which queues its kernels): the program's ``serve.enqueue`` spans, one
a program call, over their number, in ms.

Read from a traced run, the value includes the profiler's own cost of
every operation and kernel launch the call makes, so it grows with the
launches a call makes (about 1.3 times the untraced host time on the
H100's host). Fewer launches a call lower it by more than they lower the
untraced time: compare it only with itself, and take a gain from the
end-to-end metric."""

LAYER = 'serving export engine/serve.py'
UNIT = 'ms'
MOVES = 'decode_images_per_s'


def read(summary):
    spans = [e - s for n, s, e in summary['spans'] if n == 'serve.enqueue']
    if not spans:
        return None
    return sum(spans) / 1e6 / len(spans)
