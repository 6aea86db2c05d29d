"""The model's forward FLOPs of the images asked for in the traced decode
calls (at each image's own width, ``flops.py``) over the traced window's
seconds times the card's dense peak in the compute type."""

from benchmark import flops

LAYER = 'model step models/crnn.py models/layers.py'
UNIT = '%'
MOVES = 'decode_images_per_s'


def read(summary):
    c = summary['counts']
    if not c.get('calls') or not summary['window_s']:
        return None
    work = sum(flops.model_flops(w, c['num_hid'], c['nclasses'])
               for call in c['calls'] for w in call)
    return 100.0 * work / (summary['window_s'] * flops.PEAK_FLOPS[c['dtype']])
