"""The readings a cell's comparison limits are set from, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds S1 S2 ... \
        [--controls 3] [--seconds 3] [--out FILE]

For every seed it runs the cell (set-up, a short window at the cell's own
load, the comparison) and prints one JSON line with the program's numbers.
For the first ``--controls`` seeds it also puts in the program's place,
and reads the same numbers of:

* ``fp8``: the control, the reference computed in float8 e4m3 with a
  per-tensor scale, the precision below the configurations' bfloat16 (for
  the decode cells read at every frame, without decoding:
  ``judge.frame_gaps``);
* the faults the cell can have: a training step that leaves the state
  unchanged (``frozen``) and a loss over half the batch (``half``); a
  decoded token altered where it is produced (``token``).

Nothing here is run by the benchmark's own runs. Lines go to stdout and,
with ``--out``, to that file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import common, harness  # noqa: E402

FAULTS = {'train_store': ('frozen', 'half'),
          'decode_live': ('token',), 'serve_exported': ('token',)}


def readings(name, seeds, controls, seconds, device, emit, work=None,
             config=None):
    """Run the cell on each seed and ``emit`` a dict of readings a seed."""
    w0, c0 = common.load_cell(name)
    work, config = work or w0, config or c0
    driver = harness.load_module('traffic', work['kind'])
    for i, seed in enumerate(seeds):
        ctx = harness.Context(name, work, config, seed, seconds, False,
                              device)
        t = time.time()
        out = harness.run_cell(ctx, driver, time.time())
        row = {'cell': name, 'seed': seed, 'attempted': out['attempted'],
               'failed': out['failed'],
               'program': {n: v for n, v, _ in out['checks']},
               'values': out['values'], 'seconds': time.time() - t,
               'look': ctx.records.get('look')}
        if i < controls:
            for produce in ('fp8',) + FAULTS[work['kind']]:
                ctx.produce = produce
                row[produce] = {n: v for n, v, _ in
                                driver.check(ctx, out['state'])}
        emit(row)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--controls', type=int, default=3)
    p.add_argument('--seconds', type=float, default=3.0)
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(line + '\n')
    readings(args.workload, args.seeds, args.controls, args.seconds,
             torch.device('cuda', 0), emit)
    return 0


if __name__ == '__main__':
    sys.exit(main())
