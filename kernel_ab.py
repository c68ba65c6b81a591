"""Per-launch times of the flash-score kernels on one card in one call; a
helper of chip_smoke.py, whose data, timer and port each run imports.

    python3 kernel_ab.py ROOT [ROOT ...]    A/B of checkouts
    python3 kernel_ab.py --k2-variants      K2's recorded design variants
    python3 kernel_ab.py --splits           K1 and K2 at each split size

A/B: each ROOT (a checkout's root directory) runs in its own process, in the
order given (for example parent, change, change, parent), imports that
checkout's chip_smoke.py and port, and builds its kernels into its own
build directory. Each times, with chip_smoke's `cuda_ms` (CUDA events, 5
launches after a warm-up), K1 ('highest'), K2 ('high') and the 'default'
kernel at chip_smoke's main shapes: M = 8192 query rows (8 noised 32x32x3
seeds, t = 0.5), one full 65536-row chunk of a synthetic CIFAR10-shaped
bank, c = 3, k in {3, 9, 13, 17}; and K2 at the bbELS center's query count
(the valid windows, M = 8 (33 - k)^2). Prints the card's name and power
limit, one JSON line per ROOT, and a table of each key's times in ROOT
order.

--k2-variants: copies this checkout's port and chip_smoke.py into
build/k2_variants/NAME/ for each entry of K2_VARIANTS, applies its edits to
K2's main loop (`ops/csrc/flash_score_split_rows.cuh`), builds them in
parallel, and times K2 in each (k = 3, 9, 17 and the bbELS center at
k = 17), with the count of ptxas's wgmma serialisation notes (C7514).

--splits: K1 and K2 of this checkout at k in {3, 5, 9, 17} with every
chunk cut into splits of each SPLIT_SIZES rows (`flash_score.SPLIT_ROWS`),
K2 also at the bbELS center; the best of two timings each.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

KS = (3, 9, 13, 17)
HERE = Path(__file__).resolve().parent
K2_LOOP = "convolutional_diffusion_tpu_torch/ops/csrc/flash_score_split_rows.cuh"
# name -> (old, new) text edits of K2_LOOP; "shipped" is the loop as it is
K2_VARIANTS = {
    "shipped": [],
    # the same loop on unswizzled 8-row x 16-byte core matrices
    "unswizzled": [
        ("return r * 64 + ((ch ^ ((r >> 1) & 3)) << 4);",
         "return (r >> 3) * SBO + ch * 128 + (r & 7) * 16;"),
        ("((uint64_t)1 << 16) |\n         ((uint64_t)(SBO >> 4) << 32) | ((uint64_t)2 << 62);",
         "((uint64_t)(128 >> 4) << 16) |\n         ((uint64_t)(SBO >> 4) << 32);"),
        ("plane * S::Q + ks * 32", "plane * S::Q + ks * 256"),
        ("wc * 8 * SBO + ks * 32", "wc * 8 * SBO + ks * 256"),
    ],
    # ablations (wrong numbers, timing only): the hi.hi sum a plain add, no
    # cross-term products, no hi.hi product; and one ring slot fewer
    "no_twosum": [("      acc_hh[i] = two_sum(acc_hh[i], h[i], err);\n      h[i] = err;",
                   "      acc_hh[i] = __fadd_rn(acc_hh[i], h[i]);\n      h[i] = 0.f;\n"
                   "      (void)err;")],
    "no_cross": [("    wgmma64(acc_x, qdesc(st, 0, ks), kdesc(st, 1, ks), 1);\n"
                  "    wgmma64(acc_x, qdesc(st, 1, ks), kdesc(st, 0, ks), 1);\n", "")],
    "no_hh": [("    wgmma64(hn, qdesc(nst, 0, nks), kdesc(nst, 0, nks), 0);\n", "")],
    "stages4": [("constexpr int STAGES = 5;", "constexpr int STAGES = 4;")],
}
SPLIT_SIZES = (65536, 16384, 8192, 4096)


def _problem(cs, k: int, gen, images):
    """chip_smoke's main shapes at k: (queries, bbELS center queries, the
    sweep's other arguments after the query norms)."""
    import torch

    beta = cs.cosine_noise_schedule(0.5)
    at, bt = torch.sqrt(1.0 - beta), torch.sqrt(beta)
    g = cs.bank_geometry(images.shape[0], 32, 32, 3, k, cs.TARGET_BLOCK)
    p, ctr, pn = cs.chunk_patches(images[: g.cs], k)
    w = torch.full((p.shape[0],), 1.0 / p.shape[0], device="cuda")
    x = at.item() * images[:8] + bt.item() * torch.randn(
        images[:8].shape, generator=gen, device="cuda")
    xq = cs.extract_patches(cs.pad_image(x, k // 2, "circular"), k).reshape(-1, g.d)
    xc = cs.extract_patches(x, k).reshape(-1, g.d).contiguous()
    return xq, xc, (p, pn, ctr, w, at, bt)


def _setup(root: str):
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch

    ds = cs.synthetic_dataset(num_samples=1200, image_size=32, num_channels=3, seed=0)
    images = torch.from_numpy(ds.images).cuda()
    return cs, images, torch.Generator(device="cuda").manual_seed(0)


def _ms(cs, q, rest, precision: str, best_of: int = 1) -> float:
    args = (q, (q * q).sum(-1), *rest)
    return min(cs.cuda_ms(lambda: cs.fs.flash_score_update(
        *args, cs.empty_state(q.shape[0], 3), precision=precision), 5)
        for _ in range(best_of))


def one(root: str) -> dict:
    cs, images, gen = _setup(root)
    out = {}
    for k in KS:
        xq, xc, rest = _problem(cs, k, gen, images)
        for prec in ("highest", "high", "default"):
            out[f"{prec} k={k}"] = _ms(cs, xq, rest, prec)
        out[f"bbELS center high k={k}"] = _ms(cs, xc, rest, "high")
    return out


def one_k2(root: str) -> dict:
    cs, images, gen = _setup(root)
    out = {}
    for k in (3, 9, 17):
        xq, xc, rest = _problem(cs, k, gen, images)
        out[f"K2 k={k}"] = _ms(cs, xq, rest, "high", best_of=2)
        if k == 17:
            out[f"K2 bbELS center k={k}"] = _ms(cs, xc, rest, "high", best_of=2)
    return out


def splits() -> None:
    cs, images, gen = _setup(str(HERE))
    for k in (3, 5, 9, 17):
        xq, xc, rest = _problem(cs, k, gen, images)
        for rows in SPLIT_SIZES:
            cs.fs.SPLIT_ROWS = rows
            n = len(cs.fs.split_plan(rest[0].shape[0], "high"))
            print(f"[splits] k={k} d={xq.shape[1]}: {n} splits of {rows} rows: K1 "
                  f"{_ms(cs, xq, rest, 'highest', 2):.3f} ms, K2 "
                  f"{_ms(cs, xq, rest, 'high', 2):.3f} ms, K2 at the bbELS center's "
                  f"M={xc.shape[0]} {_ms(cs, xc, rest, 'high', 2):.3f} ms", flush=True)


def _run(mode: str, root: str) -> dict | None:
    res = subprocess.run([sys.executable, __file__, mode, root], capture_output=True, text=True)
    line = next((x for x in res.stdout.splitlines() if x.startswith("RESULT ")), None)
    if res.returncode != 0 or line is None:
        print(res.stdout + res.stderr, file=sys.stderr)
        return None
    return json.loads(line[len("RESULT "):])


def _table(tag: str, names, runs) -> None:
    for name, r in zip(names, runs):
        print(f"[{tag}] {name}: {json.dumps(r)}", flush=True)
    for key in runs[0]:
        print(f"[{tag}] {key}: " + " / ".join(f"{r[key]:.3f}" for r in runs) + " ms", flush=True)


def k2_variants() -> int:
    roots, builds = [], []
    for name, edits in K2_VARIANTS.items():
        root = HERE / "build" / "k2_variants" / name
        if root.exists():
            shutil.rmtree(root)
        shutil.copytree(HERE / "convolutional_diffusion_tpu_torch",
                        root / "convolutional_diffusion_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(HERE / "chip_smoke.py", root / "chip_smoke.py")
        src = root / K2_LOOP
        text = src.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                print(f"[k2] variant {name}: edit does not apply: {old!r}", file=sys.stderr)
                return 1
            text = text.replace(old, new)
        src.write_text(text)
        roots.append(root)
        builds.append(subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
             "from convolutional_diffusion_tpu_torch.ops import _build; "
             "print(_build.build('flash_score_bf16x3').log.count('C7514'))", str(root)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, b in zip(K2_VARIANTS, builds):
        log, _ = b.communicate()
        if b.returncode != 0:
            print(f"[k2] variant {name} failed to build:\n{log}", file=sys.stderr)
            return 1
        print(f"[k2] {name}: ptxas wgmma serialisation notes (C7514): {log.split()[-1]}",
              flush=True)
    runs = [_run("--one-k2", str(r)) for r in roots]
    if any(r is None for r in runs):
        return 1
    _table("k2", list(K2_VARIANTS), runs)
    return 0


def main(argv) -> int:
    if len(argv) > 1 and argv[0] in ("--one", "--one-k2"):
        fn = one if argv[0] == "--one" else one_k2
        print("RESULT " + json.dumps(fn(argv[1])), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    if argv == ["--k2-variants"]:
        return k2_variants()
    if argv == ["--splits"]:
        splits()
        return 0
    runs = [_run("--one", root) for root in argv]
    if not argv or any(r is None for r in runs):
        return 1
    _table("ab", argv, runs)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
