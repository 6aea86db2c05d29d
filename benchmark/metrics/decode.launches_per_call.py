"""Device kernels the profiler saw over the decode calls traced (the live
decode step a request, or each served program call)."""

LAYER = 'eval driver and decoders engine/test.py ops/beam.py ops/decoder.py'
UNIT = 'launches/call'
MOVES = 'decode_images_per_s'


def read(summary):
    calls = summary['counts'].get('calls')
    if not calls or not summary['kernels']:
        return None
    return len(summary['kernels']) / len(calls)
