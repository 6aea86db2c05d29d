"""The host's own time in a served request: the ``serve.decode_images``
span less the ``serve.program_run`` spans inside it (resizing, grouping,
padding, ids to strings), averaged over the traced requests, in ms."""

LAYER = 'serving export engine/serve.py'
UNIT = 'ms'
MOVES = 'decode_p95_ms'


def read(summary):
    rows = summary.get('host_spans') or []
    req = [i for i, r in enumerate(rows) if r[0] == 'serve.decode_images']
    if not req:
        return None
    inner = {}
    for name, s, e, parent in rows:
        if name == 'serve.program_run' and parent >= 0:
            inner[parent] = inner.get(parent, 0) + (e - s)
    own = [(rows[i][2] - rows[i][1]) - inner.get(i, 0) for i in req]
    return sum(own) / len(own) / 1e6
