"""Where the time of the warp-specialised kernels goes, on the card:

    python -m tsdiff_tpu_torch.ops.wg_profile [N]

Builds ``csrc/packed_score.cu``, ``csrc/packed_score_int8.cu``,
``csrc/condensed_score.cu`` and ``csrc/schnet_stack.cu`` with ``-DWG_PROFILE``
(into their own build directories), launches each warp-specialised kernel
once at its path's shapes (the packed kernels B1 and B5 at M=8 members, B=100
graphs; the dense kernel B2 at B=100 graphs, one model; B3's ``wgmma``
forward, one launch for the 7 blocks, and B3 backward's ``wgmma`` row kernel
through one backward call, so its 7 launches, one per block, add up, both at
the training batch, B=200; H=256, L=7, bfloat16, N=24
unless given) on seeded random weights and inputs, and prints the ``clock64``
cycles one lane of consumer warpgroup 0 of CTA 0 spent in each part of the
kernel, as a share of its whole time.  The two consumer warpgroups run in
step, so this is close to the CTA's own time line.  A barrier inside the node
products or the aggregation counts in both slots.  The machine these kernels
are measured on runs no profiler; this is its stand-in.  The slots are
``csrc/wg_pipeline.cuh::Prof``; in B2 "stores of kept results" is the wait
for the bulk copy that brings a kept tile back from its global scratch, and
"node products" includes the head's ``h_i * h_j``; in B3's forward, as in
B2's blocks, it is each block's xh product and node update.  In B3's row kernel
"ea tile waits" also holds pass 2's waits for the w tiles, "aggregation" also
pass 2's dxh sums, "node products" the whole node stage between the passes
(with its barriers), and "first layer" the da2 tile build and da1's column
sums.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys

import torch

SLOTS = ("ring waits", "wgmma dispatch", "wgmma waits", "epilogues", "barriers", "ea tile waits",
         "aggregation", "node products", "stores of kept results", "first layer",
         "quantization", "whole consumer")


def random_case(M, B, N, H, L, seed, device, V=100):
    """Seeded float32 weights in ``ops.packed_score.W_ORDER`` layout and inputs."""
    from tsdiff_tpu_torch.ops import packed_score as ps

    g = torch.Generator().manual_seed(seed)
    K = N // 2
    mat = lambda *shape: torch.randn(*shape, generator=g) / math.sqrt(shape[-1])
    vec = lambda *shape: 0.1 * torch.randn(*shape, generator=g)
    w = dict(
        table=torch.randn(M, V, H, generator=g), dw0=torch.randn(M, H, generator=g),
        db0=vec(M, H), dw1=mat(M, H, H), db1=vec(M, H), c0r=mat(M, H, H), c0p=mat(M, H, H),
        c0b=vec(M, H), c1w=mat(M, H, H), c1b=vec(M, H), f1w=mat(M, L, H, H), f1b=vec(M, L, H),
        f2w=mat(M, L, H, H), f2b=vec(M, L, H), l1w=mat(M, L, H, H), l2w=mat(M, L, H, H) / N,
        l2b=vec(M, L, H), ow=mat(M, L, H, H), ob=vec(M, L, H), g0h=mat(M, H, H),
        g0e=mat(M, H, H), g0b=vec(M, H), g1w=mat(M, H // 2, H), g1b=vec(M, H // 2),
        g2w=mat(M, H // 2), g2b=vec(M, 1),
    )
    w = {k: w[k].to(device).contiguous() for k in ps.W_ORDER}
    z = torch.randn(M, B, N, H, generator=g).to(device, torch.bfloat16)
    d = (0.8 + 4 * torch.rand(B, K, N, generator=g)).to(device)
    cmask = (torch.rand(B, K, N, generator=g) < 0.8).float().to(device)
    types = [torch.randint(0, 26, (B, K, N), generator=g, dtype=torch.int32).to(device)
             for _ in range(4)]
    return w, z, d, cmask, types


def dense_case(B, N, H, L, seed, device):
    """Seeded bfloat16 dense-kernel weights (image included) and inputs: a
    random symmetric edge set, distances on it, four embedding tensors."""
    from tsdiff_tpu_torch.ops import condensed_score as cs

    w32, z, _, _, _ = random_case(1, B, N, H, L, seed, device)
    w = cs.with_wg_image({k: w32[k][0].to(torch.bfloat16).contiguous() for k in cs.W_ORDER})
    g = torch.Generator().manual_seed(seed + 1)
    m = torch.triu(torch.rand(B, N, N, generator=g) < 0.7, 1)
    m = m | m.transpose(1, 2)
    d = torch.where(m, 0.8 + 4 * torch.rand(B, N, N, generator=g), torch.ones(B, N, N))
    embs = [torch.randn(B, N, N, H, generator=g).to(device, torch.bfloat16) for _ in range(4)]
    return w, z[0].contiguous(), d.to(device), m.float().to(device), embs


def stack_case(B, N, H, L, seed, device):
    """Seeded bfloat16 stack weights (flax layout), node states, edge
    features, a cutoff mask, the block inputs of the plain forward and a
    cotangent."""
    from tsdiff_tpu_torch.ops import schnet_stack as ss

    g = torch.Generator().manual_seed(seed)
    mat = lambda *shape: torch.randn(*shape, generator=g) / math.sqrt(shape[-2])
    vec = lambda *shape: 0.1 * torch.randn(*shape, generator=g)
    w = dict(f1w=mat(L, H, H), f1b=vec(L, H), f2w=mat(L, H, H), f2b=vec(L, H),
             l1w=mat(L, H, H), l2w=mat(L, H, H) / N, l2b=vec(L, H), ow=mat(L, H, H),
             ob=vec(L, H))
    w = {k: w[k].to(device, torch.bfloat16).contiguous() for k in ss.W_KEYS}
    h = torch.randn(B, N, H, generator=g).to(device, torch.bfloat16)
    ea = torch.randn(B, N * N, H, generator=g).to(device, torch.bfloat16)
    c = (torch.rand(B, N * N, generator=g) < 0.7).to(device, torch.bfloat16)
    cot = torch.randn(B, N, H, generator=g).to(device, torch.bfloat16)
    _, hs = ss.schnet_stack_fwd_reference(w, h, ea, c)
    return w, h, ea, c, hs, cot


def quantize_stacked(w32: dict) -> dict:
    """Stacked float32 weights as the int8 op's bfloat16 weights, images included."""
    from tsdiff_tpu_torch.ops import packed_score_int8 as p8

    out = {k: v.to(torch.bfloat16).contiguous() for k, v in w32.items() if k not in p8.QUANTIZED}
    scales = []
    for k in p8.SCALED:
        q, s = zip(*(p8._quant_tensor(t, per_layer=False) for t in w32[k]))
        out[k] = torch.stack(q).contiguous()
        scales.append(torch.stack(s))
    out["scales"] = torch.stack(scales, dim=1).contiguous()
    for k in ("f1w", "f2w"):
        q, s = zip(*(p8._quant_tensor(t, per_layer=True) for t in w32[k]))
        out[k], out[k + "_s"] = torch.stack(q).contiguous(), torch.stack(s).contiguous()
    return p8.with_wg_images_int8(out)


def read_profile(lib, entry: str, launch) -> list[int]:
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * len(SLOTS))()
    launch()                       # warm-up
    torch.cuda.synchronize()
    if fn(buf, 1) != 0:
        raise RuntimeError(f"{entry}: reset failed")
    launch()
    torch.cuda.synchronize()
    if fn(buf, 0) != 0:
        raise RuntimeError(f"{entry}: read failed")
    return list(buf)


def main(argv: list[str]) -> None:
    if not torch.cuda.is_available():
        sys.exit("wg_profile needs an NVIDIA GPU (CUDA is not available)")
    from tsdiff_tpu_torch.ops import _build
    from tsdiff_tpu_torch.ops import condensed_score as cs
    from tsdiff_tpu_torch.ops import packed_score as ps
    from tsdiff_tpu_torch.ops import packed_score_int8 as p8
    from tsdiff_tpu_torch.ops import schnet_stack as ss

    N = int(argv[0]) if argv else 24
    M, B, H, L = 8, 100, 256, 7
    _build.extra_flags = ("-DWG_PROFILE",)
    _build.build(["packed_score", "packed_score_int8", "condensed_score", "schnet_stack"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; M={M} B={B} N={N} H={H} L={L} bfloat16")
    dev = torch.device("cuda")
    w32, z, d, cmask, types = random_case(M, B, N, H, L, seed=N, device=dev)
    wb = ps.with_wg_images({k: v.to(torch.bfloat16).contiguous() for k, v in w32.items()})
    w8 = quantize_stacked(w32)
    wd, zd, dd, cd, embs = dense_case(B, N, H, L, seed=N + 1, device=dev)
    sw, sh, sea, sc, shs, scot = stack_case(200, N, H, L, seed=N + 2, device=dev)
    image, ea_img = ss.stack_wg_operands(sw, sh, sea, sc)
    cases = (
        ("packed_score (B1)", ps._kernel_lib(), "packed_score_profile",
         lambda: ps.packed_score(wb, z, d, cmask, *types, num_blocks=L)),
        ("packed_score_int8 (B5)", p8._kernel_lib(), "packed_score_int8_profile",
         lambda: p8.packed_score_int8(w8, z, d, cmask, *types, num_blocks=L)),
        ("condensed_score (B2), one model", cs._kernel_lib(), "condensed_score_profile",
         lambda: cs.condensed_score(wd, zd, dd, cd, *embs, num_blocks=L)),
        ("schnet_fwd_wg_kernel (B3 forward), B=200, its 7 blocks in one launch",
         ss._kernel_lib(), "schnet_stack_profile",
         lambda: ss.schnet_stack_fwd(sw, sh, sea, sc, image=image, ea_img=ea_img)),
        ("schnet_bwd_rows_wg_kernel (B3 backward), B=200, its 7 launches",
         ss._kernel_lib(), "schnet_stack_profile",
         lambda: ss.schnet_stack_bwd(sw, sea, sc, shs, scot, image=image, ea_img=ea_img)),
    )
    for name, lib, entry, launch in cases:
        cycles = read_profile(lib, entry, launch)
        total = cycles[-1]
        if total == 0:
            raise RuntimeError(f"{name}: no cycles recorded (did the warp-specialised kernel run?)")
        print(f"{name}: {total} cycles of one consumer lane of CTA 0")
        for slot, c in zip(SLOTS[:-1], cycles[:-1]):
            print(f"  {slot:24s} {c:10d}  {c / total:.4f}")
        print(f"  {'not attributed':24s} {total - sum(cycles[:-1]):10d}  "
              f"{1 - sum(cycles[:-1]) / total:.4f}")


if __name__ == "__main__":
    main(sys.argv[1:])
