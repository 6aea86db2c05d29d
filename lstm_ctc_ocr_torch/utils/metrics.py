"""Evaluation metrics (the port's copy of the JAX package's
``utils/metrics.py``).

``accuracy_calculation`` is the exact-match sequence accuracy: the
reference and the decoded id sequences are stripped of ``ignore_value``
(blank/pad 0) before comparing, and the first ``print_num`` pairs
(``cfg.VAL.PRINT_NUM``) are printed for eyeballing.
"""

from __future__ import annotations

import numpy as np


def _strip(seq, ignore_value):
    return [int(i) for i in seq if int(i) != ignore_value]


def accuracy_calculation(original_seq, decoded_seq, ignore_value=0,
                         verbose=True, print_num=5):
    if len(original_seq) != len(decoded_seq):
        print('accuracy_calculation: got {} reference sequences but {} '
              'decoded ones — batch mismatch, returning 0'
              .format(len(original_seq), len(decoded_seq)))
        return 0
    count = 0
    for i, origin_label in enumerate(original_seq):
        decoded_label = _strip(decoded_seq[i], ignore_value)
        origin_label = _strip(origin_label, ignore_value)
        if verbose and i < print_num:
            print('seq {:>4}: origin: {} decoded: {}'.format(
                i, origin_label, decoded_label))
        if origin_label == decoded_label:
            count += 1
    return count * 1.0 / len(original_seq)


def restore_labels(label_vec, label_len):
    """Unflatten a warp-ctc style flat label vector into per-example lists."""
    labels = []
    vec = list(np.asarray(label_vec).tolist())
    for l_len in np.asarray(label_len).tolist():
        labels.append(vec[:int(l_len)])
        vec = vec[int(l_len):]
    return labels


def merge_labels(labels, ignore=0):
    """Flatten per-example label lists, stripping trailing ``ignore``
    padding."""
    label_lst = []
    for l in labels:
        l = list(l)
        while l and l[-1] == ignore:
            l = l[:-1]
        label_lst.extend(l)
    return np.array(label_lst)
