"""FCN segmentation label helpers: the port's counterpart of the JAX
package's ``utils/segmentation.py``.

One-hot labels with a mask-out class (the last entry of ``class_labels``
gets no channel), the valid-entry selection, the 500-FG / 1000-total pixel
subsampler and the masked softmax cross entropy that feeds an FCN loss. They
are dead code on the OCR path, kept because they are part of the JAX
package's public utility surface.

As in the JAX package, selection is a mask and not a gather, so every
shape is static: :func:`valid_softmax_cross_entropy` is the cross entropy
averaged over the valid pixels, and :func:`valid_entries_indices` pads the
valid coordinates to a static ``size``. The subsampler ranks each class's
pixels by i.i.d. uniform priorities drawn from an explicit
``torch.Generator`` (on the annotation's device). It keeps a uniform sample
of the same size as the JAX draw, but not the same pixels: the two
frameworks' random bits differ.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def labels_from_annotation(annotation: torch.Tensor,
                           class_labels: Sequence[int]) -> torch.Tensor:
    """[..., H, W] int annotation -> [..., H, W, num_classes] f32 one-hot,
    num_classes = ``len(class_labels) - 1``; the mask-out value (the last
    entry) gets no channel. Single images and batches alike."""
    valid = torch.as_tensor(list(class_labels[:-1]),
                            device=annotation.device)
    return (annotation[..., None] == valid).to(torch.float32)


# the reference's batch entry point: broadcasting makes it the same function
labels_from_annotation_batch = labels_from_annotation


def valid_mask(annotation: torch.Tensor,
               class_labels: Sequence[int]) -> torch.Tensor:
    """Boolean mask of the entries not equal to the mask-out class."""
    return annotation != class_labels[-1]


def valid_entries_indices(annotation: torch.Tensor,
                          class_labels: Sequence[int],
                          size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(indices [size, ndim] int32, count)``: the coordinates of the valid
    entries in row-major order, zero-padded (or cut) to the static ``size``,
    and how many entries are valid. ``indices[:count]`` is the exact
    selection where ``count <= size``."""
    mask = valid_mask(annotation, class_labels)
    found = torch.nonzero(mask)[:size].to(torch.int32)
    idx = found.new_zeros((size, mask.dim()))
    idx[:found.shape[0]] = found
    return idx, mask.sum(dtype=torch.int32)


def subsample_fg_bg(generator: torch.Generator, annotation: torch.Tensor,
                    num_fg: int = 500, num_total: int = 1000,
                    disabled_value: int = 255) -> torch.Tensor:
    """Keep at most ``num_fg`` foreground (== 1) pixels and at most
    ``num_total - kept_fg`` background (== 0) ones, a uniform sample of
    each class drawn with ``generator``; the surplus becomes
    ``disabled_value``. Other values pass through; an annotation under both
    caps comes back unchanged."""
    flat = annotation.reshape(-1)
    n = flat.shape[0]

    def ranked_keep(is_class, cap):
        # each class pixel's position in a random order of its class; ranks
        # are int64 whatever the annotation's dtype (uint8 would wrap)
        pri = torch.rand(n, generator=generator, device=flat.device)
        pri = torch.where(is_class, pri, torch.full_like(pri, float('inf')))
        rank = torch.empty(n, dtype=torch.int64, device=flat.device)
        rank[torch.argsort(pri)] = torch.arange(n, device=flat.device)
        return is_class & (rank < cap)

    is_fg = flat == 1
    keep_fg = ranked_keep(is_fg, num_fg)
    n_fg_kept = min(int(is_fg.sum()), num_fg)
    is_bg = flat == 0
    keep_bg = ranked_keep(is_bg, num_total - n_fg_kept)
    disabled = (is_fg & ~keep_fg) | (is_bg & ~keep_bg)
    out = torch.where(disabled, torch.full_like(flat, disabled_value), flat)
    return out.reshape(annotation.shape)


def valid_softmax_cross_entropy(annotation: torch.Tensor,
                                logits: torch.Tensor,
                                class_labels: Sequence[int],
                                reduce: str = 'mean') -> torch.Tensor:
    """Softmax cross entropy over the valid pixels, in f32: their sum
    (``reduce='sum'``) or their mean (the count at least 1).
    ``annotation`` [..., H, W] ints, ``logits`` [..., H, W, num_classes]."""
    labels = labels_from_annotation(annotation, class_labels)
    mask = valid_mask(annotation, class_labels)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    per_pixel = -(labels * logp).sum(dim=-1)
    per_pixel = torch.where(mask, per_pixel, torch.zeros_like(per_pixel))
    if reduce == 'sum':
        return per_pixel.sum()
    return per_pixel.sum() / mask.sum(dtype=torch.float32).clamp(min=1.0)


def get_valid_logits_and_labels(generator: torch.Generator,
                                annotation: torch.Tensor,
                                logits: torch.Tensor,
                                class_labels: Sequence[int]):
    """Subsample FG/BG, then ``(labels, logits, mask)`` for a masked cross
    entropy: multiply or select with ``mask`` instead of indexing."""
    sampled = subsample_fg_bg(generator, annotation)
    labels = labels_from_annotation(sampled, class_labels)
    return labels, logits, valid_mask(sampled, class_labels)
