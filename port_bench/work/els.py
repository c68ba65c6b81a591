"""The sweeps of one ELS machine call: at every step, one sweep per bank
chunk of all b x h x w query rows, with one weight row for all seeds
(unconditional, or one label) or one per seed (a label each: K5)."""

from __future__ import annotations

import numpy as np

from ..roofline import Sweep, bound, chunks, split_family


def sweeps(config: dict, admitted, seed_labels) -> list:
    """`admitted(label)`: bool [n] numpy, the bank images the weights admit
    for a seed of that label (None: unconditional); `seed_labels`: the
    call's labels, one per seed (None entries when unconditional)."""
    h = w = config["image_size"]
    c = config["channels"]
    n = config["num_images"]
    b = len(seed_labels)
    per_seed = seed_labels[0] is not None
    adm = np.stack([admitted(lab) for lab in seed_labels])  # [b, n]
    scales = config["scales"]
    out = []
    for i in range(len(scales) - 1, 0, -1):
        k = scales[i]
        per_img, spans = chunks(n, h, w, k, config["target_block"])
        for i0, i1 in spans:
            a = adm[:, i0:i1]
            if per_seed:
                P = (i1 - i0) * per_img
                sec = bound(b * h * w, P, k * k * c, c, config["precision"], S=b,
                            pairs=a.mean(), rows=a.any(axis=0).mean())
            else:
                P = int(a[0].sum()) * per_img
                sec = bound(b * h * w, P, k * k * c, c, config["precision"]) if P else 0.0
            out.append(Sweep(split_family(config["precision"], per_seed), sec))
    return out
