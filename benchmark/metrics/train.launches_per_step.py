"""Device kernels the profiler saw over the optimizer steps traced."""

LAYER = 'solver dispatch engine/train.py'
UNIT = 'launches/step'
MOVES = 'train_images_per_s'


def read(summary):
    steps = summary['counts'].get('steps')
    if not steps or not summary['kernels']:
        return None
    return len(summary['kernels']) / steps
