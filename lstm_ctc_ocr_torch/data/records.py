"""Labels from dataset filenames (counterpart of
``parse_label_from_filename`` in the JAX package's ``data/records.py``; the
serialized record format is not ported yet)."""

from __future__ import annotations

import os
import re
from typing import Optional

_LABEL_RE = re.compile(r'^\d+_([0-9a-zA-Z]+)\.(png|jpg|jpeg|bmp)$',
                       re.IGNORECASE)


def parse_label_from_filename(fname: str) -> Optional[str]:
    """``{idx}_{label}.png`` -> label, or None for any other name."""
    m = _LABEL_RE.match(os.path.basename(fname))
    return m.group(1) if m else None
