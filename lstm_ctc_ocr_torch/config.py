"""Three-tier config: code defaults <- YAML file <- ``--set`` overrides.

The port's own copy of ``lstm_ctc_ocr_tpu/config.py``: the same key set and
default values (so every tracked ``lstm/*.yml`` merges unchanged), the same
recursive *typed* merge (unknown key -> KeyError, type mismatch ->
ValueError, int -> float allowed), the same ``cfg_from_list`` override rules
and the same charset codec (chars encoded 1..len(CHARSET), 0 is the blank).

Two differences from the JAX package:

* a config is an object the caller makes (:func:`default_cfg`) and passes,
  not a module-level global, so two evaluations in one process (or two
  tests) cannot leak settings into each other;
* YAML files are read by :func:`load_yaml`, a reader for the subset the
  tracked configs use, because PyYAML is not a dependency of the port.

Keys the port does not read yet (training, data backends, parallelism) are
kept with their defaults so that every config file still merges.
"""

from __future__ import annotations

import os
import os.path as osp
import re
from ast import literal_eval


class AttrDict(dict):
    """A dict whose items are also attributes; nested dicts convert on set."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        for k, v in dict(d or {}, **kwargs).items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, AttrDict):
            value = AttrDict(value)
        super().__setitem__(key, value)

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __delattr__(self, key):
        del self[key]


ROOT_DIR = osp.abspath(osp.join(osp.dirname(__file__), '..'))


def default_cfg() -> AttrDict:
    """A fresh config holding every default of the JAX package's config."""
    charset = '0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ'
    c = AttrDict()
    c.GPU_ID = 1
    c.GPU_USAGE = 0.9
    c.OFFSET_TIME_STEP = -1        # conv5 VALID shrinks T by 1: T = W//4 - 1
    c.POOL_SCALE = 4               # two (2,2) pools halve the width twice
    c.IMG_SHAPE = [32, 100]
    c.IMG_HEIGHT = 32
    c.MAX_CHAR_LEN = 6
    c.BLANK_TOKEN = 0
    c.CHARSET = charset
    c.NCLASSES = len(charset) + 2  # 64: only 0..62 are ever decoded
    c.MIN_LEN = 4
    c.MAX_LEN = 6
    c.FONT = 'fonts/DejaVuSerif.ttf'
    c.NCHANNELS = 1
    c.NUM_FEATURES = c.IMG_HEIGHT * c.NCHANNELS
    c.NET_NAME = 'lstm'
    c.TRAIN = AttrDict(
        SOLVER='Adam', TXT='annotation_train.txt', WEIGHT_DECAY=0.0005,
        LEARNING_RATE=0.01, MOMENTUM=0.9, GAMMA=0.1, STEPSIZE=50000,
        DISPLAY=10, LOG_IMAGE_ITERS=100, NUM_EPOCHS=2000,
        NUM_HID=512,               # BiLSTM: 2 directions x NUM_HID//2 units
        NUM_LAYERS=2, BATCH_SIZE=64, SNAPSHOT_ITERS=5000,
        SNAPSHOT_PREFIX='lstm', SNAPSHOT_INFIX='', GRAD_CLIP=10.0,
        DTYPE='bfloat16',          # compute dtype; parameters stay f32
        NUM_WORKERS=12, LOSS_MIN_SNAPSHOT=0.015, STEPS_PER_DISPATCH=1)
    c.VAL = AttrDict(TXT='annotation_val.txt', VAL_STEP=1000, NUM_EPOCHS=1000,
                     BATCH_SIZE=128, PRINT_NUM=5)
    c.RNG_SEED = 3
    c.ROOT_DIR = ROOT_DIR
    c.TEST = AttrDict(BATCH_SIZE=1)  # >1: bucket-grouped batched eval
    c.EXP_DIR = 'default'
    c.LOG_DIR = 'default'
    c.SPACE_INDEX = 0
    c.SPACE_TOKEN = ''
    # every batch is right-padded to the smallest width bucket that fits
    c.BUCKETS = [64, 96, 128, 160, 192, 224, 256]
    c.CTC_IMPL = 'jax'
    c.CONV_IMPL = 'xla'
    c.LSTM_IMPL = 'pallas'
    c.DECODER = 'greedy'           # 'greedy' | 'beam' (beam not ported yet)
    c.BEAM_WIDTH = 16
    c.BEAM_MERGE_REPEATED = False
    # 'batch': BN uses batch statistics at eval too (reference quirk);
    # 'moving': BN uses the checkpoint's bn_state moving statistics
    c.BN_EVAL = 'batch'
    c.BN_MOMENTUM = 0.99
    c.DATA_BACKEND = 'synth'
    c.TRANSFER_DTYPE = 'uint8'
    c.DATA_DEVICE = 'auto'
    c.DATA_DEVICE_MAX_MB = 2048
    c.DATA_DEVICE_LAYOUT = 'auto'
    c.PARALLEL = 'auto'
    c.RENDERER = 'captcha'
    c.RECORDS_PATH = './data/train_4_6.records'
    c.RECORDS_CACHE_RESIZED = True
    c.MP_START = 'fork'
    c.POOL_SIZE = 20000
    c.POOL_REFRESH = 2
    c.PROFILE_DIR = ''
    c.PROFILE_START = 20
    c.PROFILE_STEPS = 10
    return c


def get_encode_decode_dict(cfg):
    """Char<->id maps: chars at 1..len(CHARSET), blank/space at 0."""
    encode_maps = {}
    decode_maps = {}
    for i, char in enumerate(cfg.CHARSET, 1):
        encode_maps[char] = i
        decode_maps[i] = char
    encode_maps[cfg.SPACE_TOKEN] = cfg.SPACE_INDEX
    decode_maps[cfg.SPACE_INDEX] = cfg.SPACE_TOKEN
    return encode_maps, decode_maps


def get_output_dir(cfg, weights_filename=None):
    """Checkpoint dir ``<ROOT>/output/<EXP_DIR>[/<weights>]``, created."""
    outdir = osp.abspath(osp.join(cfg.ROOT_DIR, 'output', cfg.EXP_DIR))
    if weights_filename is not None:
        outdir = osp.join(outdir, weights_filename)
    os.makedirs(outdir, exist_ok=True)
    return outdir


def merge_a_into_b(a, b):
    """Recursive typed merge of dict ``a`` into AttrDict ``b``.

    Every key of ``a`` must exist in ``b`` (KeyError) with the same type
    (ValueError; an int may stand for a float)."""
    if not isinstance(a, dict):
        return
    for k, v in a.items():
        if k not in b:
            raise KeyError('{} is not a valid config key'.format(k))
        if type(b[k]) is not type(v):
            if isinstance(b[k], float) and isinstance(v, int) \
                    and not isinstance(v, bool):
                v = float(v)
            elif isinstance(b[k], dict) and isinstance(v, dict):
                pass
            else:
                raise ValueError('Type mismatch ({} vs. {}) for config key: {}'
                                 .format(type(b[k]), type(v), k))
        if isinstance(v, dict):
            try:
                merge_a_into_b(v, b[k])
            except (KeyError, ValueError):
                print('Error under config key: {}'.format(k))
                raise
        else:
            b[k] = v


def cfg_from_file(filename, cfg):
    """Merge a YAML config file into ``cfg``."""
    with open(filename, 'r') as f:
        merge_a_into_b(load_yaml(f.read()), cfg)


def cfg_from_list(cfg_list, cfg):
    """Set keys of ``cfg`` from a flat ``[K, V, K, V, ...]`` list; each V is
    a Python literal, or a plain string when it does not parse as one."""
    if len(cfg_list) % 2:
        raise ValueError('--set takes key/value pairs, got {}'.format(cfg_list))
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = k.split('.')
        d = cfg
        for subkey in key_list[:-1]:
            if subkey not in d:
                raise KeyError('{} is not a valid config key'.format(k))
            d = d[subkey]
        subkey = key_list[-1]
        if subkey not in d:
            raise KeyError('{} is not a valid config key'.format(k))
        try:
            value = literal_eval(v)
        except (ValueError, SyntaxError):
            value = v
        if isinstance(d[subkey], float) and isinstance(value, int):
            value = float(value)
        if type(value) is not type(d[subkey]):
            raise ValueError('type {} does not match original type {} for {}'
                             .format(type(value), type(d[subkey]), k))
        d[subkey] = value


def load_cfg(yml=None, overrides=()):
    """Defaults, then the YAML file (if any), then ``--set`` overrides."""
    cfg = default_cfg()
    if yml:
        cfg_from_file(yml, cfg)
    if overrides:
        cfg_from_list(list(overrides), cfg)
    return cfg


# --- the YAML subset of the tracked configs ------------------------------------

_INT_RE = re.compile(r'^[-+]?[0-9]+$')
_FLOAT_RE = re.compile(
    r'^[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?$')


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that is not inside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in '\'"':
            quote = ch
        elif ch == '#' and (i == 0 or line[i - 1] in ' \t'):
            return line[:i]
    return line


def _scalar(text: str):
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in '\'"':
        body = s[1:-1]
        if s[0] == "'":
            return body.replace("''", "'")
        return literal_eval(s)            # double quotes: backslash escapes
    if s[:1] in ('&', '*', '!', '|', '>', '{', '%', '@', '`'):
        raise ValueError('unsupported YAML value: {!r}'.format(s))
    if s in ('', '~', 'null', 'Null', 'NULL'):
        return None
    if s in ('true', 'True', 'TRUE'):
        return True
    if s in ('false', 'False', 'FALSE'):
        return False
    if _INT_RE.match(s):
        return int(s)
    if _FLOAT_RE.match(s) and any(ch.isdigit() for ch in s):
        return float(s)
    if s.startswith('[') and s.endswith(']'):
        inner = s[1:-1].strip()
        return [_scalar(p) for p in inner.split(',')] if inner else []
    return s


def load_yaml(text: str) -> dict:
    """Parse the YAML subset the tracked ``lstm/*.yml`` files use.

    Block mappings nested by indentation, plain/quoted scalars (ints,
    floats, strings, booleans, null), one-line flow lists of scalars and
    ``#`` comments. Anything else (block lists, anchors, multi-line
    scalars, flow mappings, tabs) raises ValueError.
    """
    root: dict = {}
    stack = []                            # (indent, mapping), innermost last
    pending = None                        # (indent, mapping, key) of 'key:'
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(' '))
        body = line.strip()
        if '\t' in line or body.startswith(('-', '&', '*', '{', '|', '>', '?')):
            raise ValueError('unsupported YAML at line {}: {!r}'
                             .format(lineno, raw))
        if pending is not None:
            p_indent, parent, key = pending
            pending = None
            if indent > p_indent:
                parent[key] = {}
                stack.append((indent, parent[key]))
            else:
                parent[key] = None
        if not stack:
            stack.append((indent, root))
        while len(stack) > 1 and stack[-1][0] > indent:
            stack.pop()
        if stack[-1][0] != indent:
            raise ValueError('bad indentation at line {}: {!r}'
                             .format(lineno, raw))
        mapping = stack[-1][1]
        key, sep, rest = body.partition(':')
        if not sep or (rest and not rest.startswith(' ')):
            raise ValueError('expected "key: value" at line {}: {!r}'
                             .format(lineno, raw))
        key = _scalar(key)
        if rest.strip():
            mapping[key] = _scalar(rest)
        else:
            pending = (indent, mapping, key)
    if pending is not None:
        pending[1][pending[2]] = None
    return root
