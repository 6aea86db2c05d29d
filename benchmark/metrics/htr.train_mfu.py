"""The handwriting model's FLOPs of the traced steps (forward and
backward, at each row's own width, ``flops_htr.py``) over the traced
window's seconds times the card's dense peak in the compute type."""

from benchmark import flops, flops_htr

LAYER = 'HTR model step models/htr.py models/layers.py'
UNIT = '%'
MOVES = 'train_images_per_s'


def read(summary):
    c = summary['counts']
    if not c.get('widths') or not summary['window_s']:
        return None
    d = flops_htr.dims(c)
    work = sum(flops_htr.model_flops(w, d['num_hid'], d['num_layers'],
                                     d['nclasses'], d['height'], train=True)
               for w in c['widths'])
    return 100.0 * work / (summary['window_s']
                           * flops.PEAK_FLOPS[c['dtype']])
