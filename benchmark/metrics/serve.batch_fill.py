"""Images asked for over the rows the served programs computed (each call
computes the exported batch), over the traced requests."""

LAYER = 'serving export engine/serve.py'
UNIT = '%'
MOVES = 'decode_images_per_s'


def read(summary):
    c = summary['counts']
    if not c.get('rows'):
        return None
    return 100.0 * c['images'] / c['rows']
