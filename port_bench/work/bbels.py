"""The sweeps of one bbELS machine call: at every step, per group of seeds
with one label (all seeds when unconditional), the center region's sweep
per bank chunk of b x (h-2p) x (w-2p) query rows over the valid patches,
and the border regions in fp32: 2p row bands of b x (w-2p) queries over
n x (w-2p) windows each, 2p column bands likewise, 4p^2 corners of b
queries over n windows."""

from __future__ import annotations

from collections import Counter

from ..roofline import Sweep, bound, chunks, split_family


def sweeps(config: dict, admitted, seed_labels) -> list:
    """See `work.els.sweeps`."""
    h = w = config["image_size"]
    c = config["channels"]
    n = config["num_images"]
    scales = config["scales"]
    out = []
    for label, b in Counter(seed_labels).items():
        adm = admitted(label)
        for i in range(len(scales) - 1, 0, -1):
            k = scales[i]
            p, d = k // 2, k * k * c
            hc, wc = h - 2 * p, w - 2 * p
            per_img, spans = chunks(n, h, w, k, config["target_block"])
            for i0, i1 in spans:
                P = int(adm[i0:i1].sum()) * per_img
                out.append(Sweep(split_family(config["precision"], False),
                                 bound(b * hc * wc, P, d, c, config["precision"]) if P else 0.0))
            na = int(adm.sum())
            if p and na:
                sec = (2 * p * bound(b * wc, na * wc, d, c, "highest")
                       + 2 * p * bound(b * hc, na * hc, d, c, "highest")
                       + 4 * p * p * bound(b, na, d, c, "highest"))
                out.append(Sweep("border", sec))
    return out
