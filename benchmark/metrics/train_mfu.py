"""The model's FLOPs of the traced steps (forward and backward, at each
row's own width, ``flops.py``) over the traced window's seconds times the
card's dense peak in the compute type."""

from benchmark import flops

LAYER = 'model step models/crnn.py models/layers.py'
UNIT = '%'
MOVES = 'train_images_per_s'


def read(summary):
    c = summary['counts']
    if not c.get('widths') or not summary['window_s']:
        return None
    work = sum(flops.model_flops(w, c['num_hid'], c['nclasses'], train=True)
               for w in c['widths'])
    return 100.0 * work / (summary['window_s'] * flops.PEAK_FLOPS[c['dtype']])
