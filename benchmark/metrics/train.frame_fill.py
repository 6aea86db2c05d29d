"""The sum of the traced rows' own widths over rows times the store's
width: the share of the conv stack's columns that hold an image."""

LAYER = 'device store data/device_store.py'
UNIT = '%'
MOVES = 'train_images_per_s'


def read(summary):
    c = summary['counts']
    if not c.get('widths'):
        return None
    return 100.0 * sum(c['widths']) / (len(c['widths']) * c['store_width'])
