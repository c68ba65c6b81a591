"""Per-launch times of the flash-score kernels on one card in one call; a
helper of chip_smoke.py, whose data, timer and port each run imports.

    python3 kernel_ab.py ROOT [ROOT ...]    A/B of checkouts
    python3 kernel_ab.py --k2-variants      K2's recorded design variants
    python3 kernel_ab.py --k1-variants      K1's recorded design variants
    python3 kernel_ab.py --splits           K1 and K2 at each split size
    python3 kernel_ab.py --k1-wide          K1's per-row and wide sums at equal d

A/B: each ROOT (a checkout's root directory) runs in its own process, in the
order given (for example parent, change, change, parent), imports that
checkout's chip_smoke.py and port, and builds its kernels into its own
build directory. Each times, with chip_smoke's `cuda_ms` (CUDA events, 5
launches after a warm-up), at chip_smoke's main shapes: M = 8192 query rows
(8 noised 32x32 seeds, t = 0.5), one full chunk of a synthetic
CIFAR10-shaped bank (65536 rows at c = 3):
  - K1 ('highest'), K2 ('high') and the 'default' kernel, c = 3, in the
    strategy 'auto' takes ('vpu'), k in {3, 9, 13, 17}; K2 also at the
    bbELS center's query count (the valid windows, M = 8 (33 - k)^2);
  - 'default' 'inbank' (the ELS module's variant at k <= 5), k in {3, 5};
  - 'mxu' on a 16-channel bank (what 'auto' takes at c = 16) in the three
    kernels, k in {3, 9, 17};
  - the bf16 exponential after fp32 dots, 'mxu', c = 3, k = 9;
  - K6's masked instantiation (a mask that skips nothing): K1 at k = 17,
    'mxu' c = 16 in K1 and K2 at k = 3;
  - K5, per-seed weights as the conditional path has them: 8 seeds of 1024
    rows, each admitting the images of one label (labels 0 .. 7;
    `chip_smoke.per_seed_weights`), in the three kernels at k in {3, 9, 17}
    ('vpu' at c = 3, 'inbank' at 'default' and k = 3, and 'mxu' on the
    16-channel bank).
Every key also records a digest of m from one call from the empty state:
m is the row max of the logits, so equal digests across ROOTs mean the
kernels' logits are the same bits on every row. The K5 and K6 keys also
record digests of s1 and s2: equal digests mean the same state, bit for
bit. Prints the card's name and power limit, one JSON line per ROOT, a
table of each key's times in ROOT order and, per key and digest, whether
the digests agree in every ROOT.

--k2-variants: copies this checkout's port and chip_smoke.py into
build/k2_variants/NAME/ for each entry of K2_VARIANTS, applies its edits to
the warp-specialised loop of K2's per-row sums
(`ops/csrc/flash_score_split_ws.cuh`), builds them in parallel, prints the
count of ptxas's wgmma serialisation notes (C7514, C7515) and each main-loop
instantiation's registers and spills, and times K2 in each (k = 3, 9, 17;
the 32x32 bbELS center at k = 17; the 64x64 bbELS center, 4 seeds, at
k = 3 and 27 over a random 65536-row chunk), the variants in turn and then
in reverse order. `--one-k2 ROOT` times one checkout so.

--k1-variants: the same for K1's main loop (`ops/csrc/flash_score.cu`,
K1_VARIANTS), timing K1 unmasked, under a mask that skips nothing (the
list walk of K6) and with K5's label-filtered weights, at k in {3, 9, 17}
('vpu', c = 3) and k in {9, 17} ('mxu', c = 16), with the digests of one
call each.

--splits: K1 and K2 of this checkout at k in {3, 5, 9, 17} with every
chunk cut into splits of each SPLIT_SIZES rows (`flash_score.SPLIT_ROWS`),
K2 also at the bbELS center; the best of two timings each.

--k1-wide: K1 of this checkout in its two fp32-exp2 epilogues on the same
inputs, an 8-channel bank at k in {9, 17}: 'vpu' (the per-row sums) and
'mxu' (the wide sums); the best of two timings each.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

KS = (3, 9, 13, 17)
HERE = Path(__file__).resolve().parent
K2_LOOP = "convolutional_diffusion_tpu_torch/ops/csrc/flash_score_split_ws.cuh"
# name -> (old, new) text edits of K2_LOOP (the warp-specialised loop of
# K2's per-row sums); "shipped" is the loop as it is
K2_VARIANTS = {
    "shipped": [],
    # registers: a producer of 40, consumers of 232
    "regs232": [("PRODUCER_REGS = 24, CONSUMER_REGS = 240",
                 "PRODUCER_REGS = 40, CONSUMER_REGS = 232")],
    # ablations (wrong numbers, timing only): the hi.hi sum a plain add, no
    # cross-term products, no hi.hi products; and a ring slot fewer or more
    "no_twosum": [("      S[32 * h + i] = two_sum(S[32 * h + i], H[i], err);",
                   "      S[32 * h + i] = __fadd_rn(S[32 * h + i], H[i]);\n      err = 0.f;")],
    "no_cross": [("        wgmma128(X, qd(cur, 0, ks), kd(cur, 1, ks, 0), 1);\n"
                  "        wgmma128(X, qd(cur, 1, ks), kd(cur, 0, ks, 0), 1);\n", "")],
    "no_hh": [("    wgmma64_zero(H, qd(s, 0, ks), kd(s, 0, ks, h));\n", ""),
              ("        wgmma64_zero(H, qd(ns, 0, nks), kd(ns, 0, nks, 0));\n", "")],
    "stages4": [("constexpr int STAGES = 5;", "constexpr int STAGES = 4;")],
    "stages6": [("constexpr int STAGES = 5;", "constexpr int STAGES = 6;")],
}
K1_LOOP = "convolutional_diffusion_tpu_torch/ops/csrc/flash_score.cu"
# name -> (old, new) text edits of K1_LOOP; "shipped" is the loop as it is
K1_VARIANTS = {
    "shipped": [],
    # the per-row epilogue's staged copies with one index pair per copy, as
    # the wide epilogues keep
    "copy_pairs": [("    if constexpr (EPI == PER_ROW) {\n      const bool fin",
                    "    if constexpr (false) {\n      const bool fin")],
    # every block writes its walked tiles, the 1-D walks' too
    "walked_always": [("  if (LIST && walked != nullptr && tid == 0)",
                       "  if (walked != nullptr && tid == 0)")],
}
SPLIT_SIZES = (65536, 16384, 8192, 4096)


def _problem(cs, k: int, gen, images):
    """chip_smoke's main shapes at k: (queries, bbELS center queries, the
    sweep's other arguments after the query norms)."""
    import torch

    beta = cs.cosine_noise_schedule(0.5)
    at, bt = torch.sqrt(1.0 - beta), torch.sqrt(beta)
    c = images.shape[-1]
    g = cs.bank_geometry(images.shape[0], 32, 32, c, k, cs.TARGET_BLOCK)
    p, ctr, pn = cs.chunk_patches(images[: g.cs], k)
    w = torch.full((p.shape[0],), 1.0 / p.shape[0], device="cuda")
    x = at.item() * images[:8] + bt.item() * torch.randn(
        images[:8].shape, generator=gen, device="cuda")
    xq = cs.extract_patches(cs.pad_image(x, k // 2, "circular"), k).reshape(-1, g.d)
    xc = cs.extract_patches(x, k).reshape(-1, g.d).contiguous()
    return xq, xc, (p, pn, ctr, w, at, bt)


def _setup(root: str, channels=(3,)):
    sys.path.insert(0, root)
    import chip_smoke as cs
    import torch

    sets = {c: cs.synthetic_dataset(num_samples=1200, image_size=32, num_channels=c, seed=0)
            for c in channels}
    images = {c: torch.from_numpy(ds.images).cuda() for c, ds in sets.items()}
    labels = {c: torch.from_numpy(ds.labels.astype("int64")).cuda() for c, ds in sets.items()}
    return cs, images, torch.Generator(device="cuda").manual_seed(0), labels


def _per_seed(cs, rest, labels, k: int, images):
    """rest with K5's weights: 8 seeds, seed s admitting the images of label
    s in the chunk (`chip_smoke.per_seed_weights`)."""
    g = cs.bank_geometry(images.shape[0], 32, 32, images.shape[-1], k, cs.TARGET_BLOCK)
    w = cs.per_seed_weights(labels[: g.cs], list(range(8)), g)
    return (*rest[:3], w, *rest[4:])


def _call(cs, q, rest, precision: str, **kw):
    """One sweep from the empty state, as the ELS module calls it."""
    p, pn, ctr, w, at, bt = rest
    if kw.get("v_strategy") == "inbank":
        ctr = None
    return lambda: cs.fs.flash_score_update(q, (q * q).sum(-1), p, pn, ctr, w, at, bt,
                                            cs.empty_state(q.shape[0], rest[2].shape[1]),
                                            precision=precision, **kw)


def _ms(cs, q, rest, precision: str, best_of: int = 1, **kw) -> float:
    fn = _call(cs, q, rest, precision, **kw)
    return min(cs.cuda_ms(fn, 5) for _ in range(best_of))


def _digest(cs, q, rest, precision: str, state: bool = False, **kw) -> dict:
    """Digests of m after one call from the empty state (the logits' row
    max) on every row, and with `state` of s1 and s2 too."""
    out = _call(cs, q, rest, precision, **kw)()
    return {name: hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]
            for name, x in zip(("m", "s1", "s2"), out if state else out[:1])}


def one(root: str) -> dict:
    cs, images, gen, labels = _setup(root, channels=(3, 16))
    out, bits = {}, {}

    def row(key, q, rest, precision, state=False, **kw):
        out[key] = _ms(cs, q, rest, precision, **kw)
        for name, dg in _digest(cs, q, rest, precision, state, **kw).items():
            bits[f"{key} {name}"] = dg

    for k in sorted(set(KS) | {5}):
        xq, xc, rest = _problem(cs, k, gen, images[3])
        if k in KS:
            for prec in ("highest", "high", "default"):
                row(f"{prec} k={k}", xq, rest, prec)
            row(f"bbELS center high k={k}", xc, rest, "high")
        if k in (3, 5):
            row(f"default inbank k={k}", xq, rest, "default", v_strategy="inbank",
                inbank_cols=(cs.center_index(k, 3).start, 3))
        if k == 9:
            row(f"highest bf16-exp mxu k={k}", xq, rest, "highest", fast_exp=True,
                v_strategy="mxu")
        if k == 17:  # K6: a mask that skips nothing (the masked instantiation)
            row(f"highest k={k} masked", xq, rest, "highest", state=True,
                prune_mask=_no_skip(cs, xq, rest))
        if k in (3, 9, 17):  # K5: label-filtered per-seed weights
            r5 = _per_seed(cs, rest, labels[3], k, images[3])
            for prec in ("highest", "high", "default"):
                row(f"{prec} k5 k={k}", xq, r5, prec, state=True, rows_per_seed=1024)
            if k == 3:  # what the ELS module takes there at 'default'
                row(f"default inbank k5 k={k}", xq, r5, "default", state=True,
                    rows_per_seed=1024, v_strategy="inbank",
                    inbank_cols=(cs.center_index(k, 3).start, 3))
    for k in (3, 9, 17):
        xq, _, rest = _problem(cs, k, gen, images[16])
        for prec in ("highest", "high", "default"):
            row(f"{prec} mxu c=16 k={k}", xq, rest, prec)
        if k == 3:
            for prec in ("highest", "high"):
                row(f"{prec} mxu c=16 k={k} masked", xq, rest, prec, state=True,
                    prune_mask=_no_skip(cs, xq, rest))
        r5 = _per_seed(cs, rest, labels[16], k, images[16])
        for prec in ("highest", "high", "default"):
            row(f"{prec} mxu c=16 k5 k={k}", xq, r5, prec, state=True, rows_per_seed=1024)
    return {"ms": out, "digest": bits}


def _no_skip(cs, q, rest):
    """An all-zero prune mask of the sweep: every tile walked, through the
    masked (K6) instantiation."""
    import torch

    return torch.zeros(cs.fs.prune_grid(q.shape[0], rest[0].shape[0]), dtype=torch.int32,
                       device="cuda")


def _random(cs, M: int, P: int, d: int):
    """Queries [M, d] and the sweep's other arguments over a random chunk of
    P rows (timing only: the kernels' work does not depend on the values)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(M + d)
    beta = cs.cosine_noise_schedule(0.5)
    p = torch.randn(P, d, generator=gen, device="cuda")
    ctr = torch.randn(P, 3, generator=gen, device="cuda")
    w = torch.full((P,), 1.0 / P, device="cuda")
    q = torch.randn(M, d, generator=gen, device="cuda")
    return q, (p, (p * p).sum(-1), ctr, w, torch.sqrt(1.0 - beta), torch.sqrt(beta))


def one_k2(root: str) -> dict:
    cs, images, gen, _ = _setup(root)
    out = {}
    for k in (3, 9, 17):
        xq, xc, rest = _problem(cs, k, gen, images[3])
        out[f"K2 k={k}"] = _ms(cs, xq, rest, "high", best_of=2)
        if k == 17:
            out[f"K2 bbELS center k={k}"] = _ms(cs, xc, rest, "high", best_of=2)
    for k in (3, 27):  # the 64x64 bbELS centre: 4 seeds of (65 - k)^2 windows
        q, rest = _random(cs, 4 * (65 - k) ** 2, 65536, 3 * k * k)
        out[f"K2 bbELS64 center k={k}"] = _ms(cs, q, rest, "high", best_of=2)
    return {"ms": out, "digest": {}}


def one_k1(root: str) -> dict:
    cs, images, gen, labels = _setup(root, channels=(3, 16))
    out, bits = {}, {}
    for c, ks in ((3, (3, 9, 17)), (16, (9, 17))):
        for k in ks:
            xq, _, rest = _problem(cs, k, gen, images[c])
            r5 = _per_seed(cs, rest, labels[c], k, images[c])
            for tag, r, kw in (("", rest, {}),
                               (" masked", rest, dict(prune_mask=_no_skip(cs, xq, rest))),
                               (" k5", r5, dict(rows_per_seed=1024))):
                key = f"K1 c={c} k={k}{tag}"
                out[key] = _ms(cs, xq, r, "highest", best_of=2, **kw)
                for name, dg in _digest(cs, xq, r, "highest", True, **kw).items():
                    bits[f"{key} {name}"] = dg
    return {"ms": out, "digest": bits}


def splits() -> None:
    cs, images, gen, _ = _setup(str(HERE))
    for k in (3, 5, 9, 17):
        xq, xc, rest = _problem(cs, k, gen, images[3])
        for rows in SPLIT_SIZES:
            cs.fs.SPLIT_ROWS = rows
            cs.fs.sweep_plan.cache_clear()  # its plans were made at the old SPLIT_ROWS
            M, d = xq.shape
            n = len(cs.fs.sweep_plan("high", None, "vpu", 3, M, M, rest[0].shape[0], d).splits)
            print(f"[splits] k={k} d={xq.shape[1]}: {n} splits of {rows} rows: K1 "
                  f"{_ms(cs, xq, rest, 'highest', 2):.3f} ms, K2 "
                  f"{_ms(cs, xq, rest, 'high', 2):.3f} ms, K2 at the bbELS center's "
                  f"M={xc.shape[0]} {_ms(cs, xc, rest, 'high', 2):.3f} ms", flush=True)


def k1_wide() -> None:
    cs, images, gen, _ = _setup(str(HERE), channels=(8,))
    for k in (9, 17):
        xq, _, rest = _problem(cs, k, gen, images[8])
        ms = {s_: _ms(cs, xq, rest, "highest", 2, v_strategy=s_) for s_ in ("vpu", "mxu")}
        print(f"[k1-wide] k={k} d={xq.shape[1]} M={xq.shape[0]} P={rest[0].shape[0]} c=8: "
              f"'vpu' {ms['vpu']:.3f} ms, 'mxu' {ms['mxu']:.3f} ms", flush=True)


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


def _bits(names, digests) -> None:
    for key in digests[0]:
        same = len({d[key] for d in digests}) == 1
        print(f"[ab-bits] {key}: digests of one call from the empty state "
              + ("equal in every ROOT" if same else
                 "DIFFER: " + ", ".join(f"{n} {d[key]}" for n, d in zip(names, digests))),
              flush=True)


def variants(tag: str, table: dict, loop: str, kernel: str, mode: str) -> int:
    """Copy this checkout's port and chip_smoke.py into build/<tag>_variants/
    NAME/ per entry of `table`, apply its edits to `loop`, build `kernel` in
    every copy in parallel (printing ptxas's wgmma serialisation notes and
    each main-loop instantiation's registers and spills), then time each
    copy with `mode` (one process each)."""
    roots, builds = [], []
    for name, edits in table.items():
        root = HERE / "build" / f"{tag}_variants" / name
        if root.exists():
            shutil.rmtree(root)
        shutil.copytree(HERE / "convolutional_diffusion_tpu_torch",
                        root / "convolutional_diffusion_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(HERE / "chip_smoke.py", root / "chip_smoke.py")
        src = root / loop
        text = src.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                print(f"[{tag}] variant {name}: edit does not apply: {old!r}", file=sys.stderr)
                return 1
            text = text.replace(old, new)
        src.write_text(text)
        roots.append(root)
        builds.append(subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
             "import chip_smoke as cs; from convolutional_diffusion_tpu_torch.ops import _build; "
             f"log = _build.build({kernel!r}).log; t = cs.ptxas_table(log); "
             "print('C751x notes', log.count('(C7514)') + log.count('(C7515)')); "
             "[print(e, r, st, ld) for (_, r, st, ld, _), e in "
             "zip(t, cs.demangle([x[0] for x in t])) if 'rows_kernel' in e]", str(root)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, b in zip(table, builds):
        log, _ = b.communicate()
        if b.returncode != 0:
            print(f"[{tag}] variant {name} failed to build:\n{log}", file=sys.stderr)
            return 1
        for line in log.splitlines():
            words = line.split()
            if line.startswith("C751x"):
                print(f"[{tag}] {name}: ptxas wgmma serialisation notes (C7514, C7515): "
                      f"{words[-1]}", flush=True)
            elif "rows_kernel" in line:
                print(f"[{tag}] {name} {' '.join(words[:-3])}: {words[-3]} registers, spill "
                      f"stores {words[-2]} bytes, loads {words[-1]} bytes", flush=True)
    order = list(table) + list(table)[::-1]
    runs = [_run(mode, str(HERE / "build" / f"{tag}_variants" / name)) for name in order]
    if any(r is None for r in runs):
        return 1
    _table(tag, order, [r["ms"] for r in runs])
    _bits(order, [r["digest"] for r in runs])
    return 0


def main(argv) -> int:
    modes = {"--one": one, "--one-k2": one_k2, "--one-k1": one_k1}
    if len(argv) > 1 and argv[0] in modes:
        print("RESULT " + json.dumps(modes[argv[0]](argv[1])), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    if argv == ["--k2-variants"]:
        return variants("k2", K2_VARIANTS, K2_LOOP, "flash_score_bf16x3", "--one-k2")
    if argv == ["--k1-variants"]:
        return variants("k1", K1_VARIANTS, K1_LOOP, "flash_score", "--one-k1")
    if argv == ["--splits"]:
        splits()
        return 0
    if argv == ["--k1-wide"]:
        k1_wide()
        return 0
    runs = [_run("--one", root) for root in argv]
    if not argv or any(r is None for r in runs):
        return 1
    _table("ab", argv, [r["ms"] for r in runs])
    _bits(argv, [r["digest"] for r in runs])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
