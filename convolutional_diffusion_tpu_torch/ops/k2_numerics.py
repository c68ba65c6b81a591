"""Numerics of the 'high' tier on an NVIDIA GPU: what the tensor core
returns, and how far each flash-score implementation is from float64.

    python3 -m convolutional_diffusion_tpu_torch.ops.k2_numerics

1. mma rounding — one warp-level mma.sync m16n8k16 (bf16 in, fp32
   accumulate; `csrc/mma_probe.cu`) on random bf16 operands: among the
   results whose exact sum is not a float32, the share equal to the exact
   sum rounded to nearest (RN) and rounded toward zero (RZ), with a zero and
   with a large accumulator. This is why the plain 'high' and 'default'
   versions round each product step toward zero (`flash_score._split_dot`).
   The same for one warpgroup wgmma.mma_async m64n8k16 (bf16 operands in
   shared memory, no swizzle), with a zero accumulator (scale-d false) and
   with a large one, for both readings of the descriptor's byte offsets:
   whether the asynchronous product would keep K2's exact hi.hi sum.
2. float64 reference — K1, K2 and their plain versions at the main path's
   widths (8 seeds x 32x32x3, c = 3, 4096 bank rows of one CIFAR10 chunk)
   against the same sweep in float64, over the exact bf16x3 split ("split")
   and over the fp32 inputs ("full"): max relative error of the log total
   weight m + log s1 and of the posterior mean s2/s1.

Needs a CUDA device and nvcc; builds its kernels into build/torch_kernels/.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from ..data import synthetic_dataset
from ..schedules import cosine_noise_schedule
from ..scores.bank import chunk_patches
from . import _build
from . import flash_score as fs
from .patches import extract_patches, pad_image


def phase_mma(rs) -> None:
    probe = _build.load("mma_probe")
    n = 3000
    bf = lambda x: torch.from_numpy(x).float().to(torch.bfloat16)  # noqa: E731
    for name, draw in (("normal", lambda sh: rs.normal(size=sh)),
                       ("uniform(-1,1)", lambda sh: rs.uniform(-1, 1, sh))):
        a, b = bf(draw((n, 16, 16))), bf(draw((n, 16, 8)))
        exact = torch.einsum("nik,nkj->nij", a.double(), b.double())
        for cname, c in (("C = 0", torch.zeros(n, 16, 8)),
                         ("C ~ 40 N(0,1)",
                          torch.from_numpy(rs.normal(size=(n, 16, 8)) * 40).float())):
            d = torch.empty_like(c).cuda()
            args = [a.cuda().contiguous(), b.transpose(1, 2).cuda().contiguous(),
                    c.cuda().contiguous(), d]
            if probe(*(x.data_ptr() for x in args), n) != 0:
                raise SystemExit("mma probe launch failed")
            s = exact + c.double()
            got = d.cpu().double()
            inexact = s.float().double() != s
            k = int(inexact.sum())
            rn = int(((got == s.float().double()) & inexact).sum())
            rz = int(((got == fs._rz32(s.clone())) & inexact).sum())
            print(f"[mma] {name}, {cname}: {k} of {s.numel()} sums not float32; "
                  f"result == RN {rn / k:.3f}, == RZ {rz / k:.3f}", flush=True)


def phase_wgmma(rs) -> None:
    probe = _build.load("wgmma_probe")
    n = 400
    bf = lambda x: torch.from_numpy(x).float().to(torch.bfloat16)  # noqa: E731
    a, b = bf(rs.normal(size=(n, 64, 16))), bf(rs.normal(size=(n, 8, 16)))
    exact = torch.einsum("nik,njk->nij", a.double(), b.double())
    for cname, c, use_c in (("from zero (scale-d false)", torch.full((n, 64, 8), 7.0), 0),
                            ("C ~ 40 N(0,1)",
                             torch.from_numpy(rs.normal(size=(n, 64, 8)) * 40).float(), 1)):
        s = exact + (c.double() if use_c else 0.0)
        inexact = s.float().double() != s
        k = int(inexact.sum())
        for lbo, sbo in ((128, 256), (256, 128)):
            d = torch.empty(n, 64, 8, device="cuda")
            args = [a.cuda().contiguous(), b.cuda().contiguous(), c.cuda().contiguous(), d]
            if probe(*(x.data_ptr() for x in args), n, lbo, sbo, use_c) != 0:
                raise SystemExit("wgmma probe launch failed")
            got = d.cpu().double()
            close = float(((got - s).abs() <= 1e-5 * s.abs().clamp(min=1)).double().mean())
            rn = int(((got == s.float().double()) & inexact).sum())
            rz = int(((got == fs._rz32(s.clone())) & inexact).sum())
            print(f"[wgmma] {cname}, descriptor lbo {lbo} sbo {sbo}: {close:.3f} of the "
                  f"results within 1e-5 of the exact sum; {k} of {s.numel()} sums not "
                  f"float32: result == RN {rn / max(k, 1):.3f}, == RZ {rz / max(k, 1):.3f}",
                  flush=True)


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / max(a.abs().max(), b.abs().max(), 1)).item()


def phase_reference(gen) -> None:
    ds = synthetic_dataset(num_samples=256, image_size=32, num_channels=3, seed=0)
    imgs = torch.from_numpy(ds.images).cuda()
    P = 4096
    for k, t in ((17, 0.05), (9, 0.05), (17, 0.5)):
        p, ctr, pn = (x[:P].contiguous() for x in chunk_patches(imgs, k))
        beta = cosine_noise_schedule(t)
        at, bt = torch.sqrt(1 - beta), torch.sqrt(beta)
        x = at.item() * imgs[:8] + bt.item() * torch.randn(
            imgs[:8].shape, generator=gen, device="cuda")
        xq = extract_patches(pad_image(x, k // 2, "circular"), k).reshape(-1, k * k * 3)
        qn = (xq * xq).sum(-1)
        M = xq.shape[0]
        w = torch.full((P,), 1.0 / P, device="cuda")
        args = (xq, qn, p, pn, ctr, w, at, bt)

        def empty():
            return (torch.full((M,), fs.NEG_INF, device="cuda"),
                    torch.zeros(M, device="cuda"), torch.zeros(M, 3, device="cuda"))

        runs = {}
        for prec, kern in (("highest", "K1"), ("high", "K2")):
            runs[kern] = fs.flash_score_update(*args, empty(), precision=prec)
            runs[f"plain {prec}"] = fs.flash_score_update_plain(*args, empty(), precision=prec)
        a, b = at.double().item(), bt.double().item()
        qh, ql = (v.double() for v in fs._split_bf16(xq))
        kh, kl = (v.double() for v in fs._split_bf16(p))
        dots = {"split": qh @ kh.T + qh @ kl.T + ql @ kh.T,
                "full": xq.double() @ p.double().T}
        refs = {}
        for name, dt in dots.items():
            logit = (-(qn.double()[:, None] - 2 * a * dt + a * a * pn.double()[None])
                     / (2 * b * b) + torch.log(w.double())[None])
            refs[name] = (torch.logsumexp(logit, 1), torch.softmax(logit, 1) @ ctr.double())
        print(f"[reference] k={k} t={t} M={M} P={P}", flush=True)
        for name, (m, s1, s2) in runs.items():
            lse = m.double() + torch.log(s1.double())
            mean = s2.double() / s1.double()[:, None]
            print("[reference]   " + f"{name:14s}" + "  ".join(
                f"vs float64 {rn}: lse rel {rel(lse, r[0]):.2e}, mean rel {rel(mean, r[1]):.2e}"
                for rn, r in refs.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_numerics: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_mma(np.random.RandomState(1))
    phase_wgmma(np.random.RandomState(2))
    phase_reference(torch.Generator(device="cuda").manual_seed(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
