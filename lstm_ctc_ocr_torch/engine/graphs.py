"""CUDA graphs of the port's programs: the K-step train dispatches
(``engine/train.py:make_train_chunk``) and the served decode programs
(``engine/serve.py:ExportedDecoder``).

A capture records kernels without running them, and a replay runs them
without running the Python that launched them. So the Python counters that
a launch moves, the kernel wrappers' ``launches`` and the counts of
``utils/profiler.py``, would move once at the capture and never at a
replay. :func:`capture` takes what the capture's own work counted aside
(``utils/profiler.py:capture_counts``) into the :class:`Graph`, whose
:meth:`Graph.replay` adds it, as an eager call would.
"""

from __future__ import annotations

import torch

from ..utils.profiler import capture_counts, count


class Graph:
    """One captured program: its static inputs and outputs, and the
    kernel launches a replay makes (``(wrapper, count)``), which the
    wrappers' Python counters do not see, and the counts of
    ``utils/profiler.py`` its capture made (``{name: n}``), which a replay
    adds while a trace records."""

    def __init__(self, graph, inputs, outputs, launches, counts):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.launches, self.counts = launches, counts

    def replay(self):
        self.graph.replay()
        for wrapper, n in self.launches:
            wrapper.launches += n
        for name, n in self.counts.items():
            count(name, n)


def capture(fn, inputs, stream, pool, what):
    """Run ``fn()``, which reads ``inputs``, once on the side stream
    ``stream`` (the warm-up that sets up cuBLAS, cuDNN and the kernels'
    one-time attributes; its work is real), then capture it as a CUDA
    graph on ``stream`` from the memory pool ``pool``, without running it:
    ``(the warm-up's outputs, the Graph of inputs and fn's outputs)``. A
    capture that fails raises ``RuntimeError`` naming ``what``."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode='thread_local'), \
                capture_counts() as tally:
            outputs = fn()
    except RuntimeError as e:
        raise RuntimeError(
            'capturing {} failed (an op in it synchronises with the host or '
            'copies from it): {}'.format(what, e)) from e
    return out, Graph(graph, inputs, outputs, list(tally.launches.items()),
                      dict(tally))
