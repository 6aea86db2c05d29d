"""The share of the traced window in which no kernel, copy or fill ran on
the card."""

LAYER = 'device'
UNIT = '%'
MOVES = 'decode_images_per_s'


def read(summary):
    if not summary['window_s'] or not summary['busy_s']:
        return None
    return 100.0 * (1.0 - summary['busy_s'] / summary['window_s'])
