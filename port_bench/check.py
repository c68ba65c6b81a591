"""The comparison that decides `correct`: the samples the timed path wrote,
held against the plain reference.

Once the window has closed and the program is freed, a sample of the
window's sample indices, drawn from the seed, is judged: each one's saved
seed and label against the pipeline's rule (bit for bit), and its saved
machine output against the reference's run of the same seed and label
over the same bank, made again from the seed. Every index of the window
must have its files. The numbers, each with its limit from
`limits/<cell>.json`:

- `sample_gap`: the largest over the sample of max |out - ref| /
  max(max |ref|, 1);
- `seed_mismatch`, `label_mismatch`: entries of the saved seeds and labels
  that differ from the rule's draws;
- `missing_samples`: indices of the window without their files.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import inputs
from .reference import machine as ref_machine

CHECK_STREAM = 0x5EED  # the sample's own stream beside the pipeline's [seed, j]


def sample_indices(seed: int, written: int, count: int) -> list:
    """`count` of the indices [0, written), drawn from the seed."""
    rng = np.random.default_rng([seed, CHECK_STREAM])
    return sorted(rng.choice(written, size=min(count, written), replace=False).tolist())


def load_saved(path_noext: str):
    path = path_noext + ".npy"
    return np.load(path) if os.path.exists(path) else None


def gap(out: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(out - ref).max() / max(float(np.abs(ref).max()), 1.0))


def judge(config: dict, traffic: dict, seed: int, out_dir: str, written: int,
          device, *, outputs: dict | None = None) -> tuple[dict, dict]:
    """(the numbers compared by name, {sampled index: (its gap, whether
    its seed and label are the rule's)}). `outputs` (index -> array)
    judges other outputs than the saved ones, as a control does; the saved
    seeds and labels are judged all the same."""
    size, c = config["image_size"], config["channels"]
    cond, nl = traffic["conditional"], traffic["nlabels"]
    missing = 0
    for j in range(written):
        stem = f"{j:04d}"
        need = ["seeds", traffic["idealname"]] + (["labels"] if cond else [])
        missing += any(not os.path.exists(os.path.join(out_dir, sub, stem + ".npy"))
                       for sub in need)
    images, labels = inputs.synthetic_bank(seed, config["num_images"], size, c,
                                           config["num_classes"], device)
    seed_bad = label_bad = 0
    per_sample = {}
    for j in sample_indices(seed, written, traffic["check_samples"]):
        stem = f"{j:04d}"
        x, lab = inputs.draw(seed, j, size, c, cond, nl)
        saved = load_saved(os.path.join(out_dir, "seeds", stem))
        bad_seed = x.size if saved is None or saved.shape != x.shape else int((saved != x).sum())
        bad_label = 0
        if cond:
            saved_lab = load_saved(os.path.join(out_dir, "labels", stem))
            bad_label = int(saved_lab is None or int(saved_lab.reshape(-1)[0]) != lab)
        out = (outputs or {}).get(j)
        if out is None:
            out = load_saved(os.path.join(out_dir, traffic["idealname"], stem))
        ref = ref_machine.sample(x, lab, images, labels, config, config["dots"]).cpu().numpy()
        g = np.inf if out is None or out.shape != ref.shape else gap(out, ref)
        per_sample[j] = (g if np.isfinite(g) else np.inf, bad_seed == 0 and bad_label == 0)
        seed_bad += bad_seed
        label_bad += bad_label
    del images, labels
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"sample_gap": max((g for g, _ in per_sample.values()), default=0.0),
            "seed_mismatch": seed_bad, "label_mismatch": label_bad,
            "missing_samples": missing}, per_sample


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits, {name: {"value", "limit"}})."""
    checks = {k: {"value": v, "limit": limits[k]["limit"]} for k, v in numbers.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
