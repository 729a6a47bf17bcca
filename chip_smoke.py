"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. card: name and power limit, CUDA and nvcc versions;
2. build: compile the port's CUDA kernels from ``tsdiff_tpu_torch/csrc``;
3. kernels against their plain PyTorch versions at the main path's shapes:
   the 8 trained campaign members and 100 synthetic reactions with a
   jittered geometry, in the N=24 bucket in float32 (TF32 off) and bfloat16
   and in the N=16 bucket in bfloat16; errors, times (CUDA events) and the
   bound of each kernel;
4. main path: the port's sampling CLI on 200 synthetic reactions with the 8
   members, bf16, fused packed score, ``ld`` over the 5000-step schedule
   walked in 625 model calls; checks that every model call went through the
   kernel, that positions are finite and that the mean D-MAE is plausible;
5. profile: 20 sampling steps at N=24 under torch.profiler, split into the
   score kernel, the other kernels and the device's idle share.

The second-to-last lines are a JSON object of per-kernel numbers and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT_DIR = os.path.join(ROOT, "artifacts", "seeds", "ckpts")
# the 8 members of the 10k-reaction campaign (artifacts/campaign_10k)
MEMBER_SEEDS = (106, 101, 104, 102, 108, 103, 109, 105)
OUT_DIR = os.path.join(ROOT, ".scratch", "chip_smoke")  # gitignored

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 without them
PEAK_BYTES = 3.35e12

# kernel vs plain version, as a fraction of the output's largest magnitude:
# float32 only reorders float32 sums; bfloat16 rounds at the same points in
# both, but a reordered float32 sum can flip a rounding by one bf16 ulp
# (2^-8) and such flips propagate through the 7 blocks
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 3e-3)}  # (max, mean)
# mean D-MAE of the main path: the JAX package measured 0.4365 for `ld` at
# 625 respaced steps (4 members, artifacts/respacing_curve.json) and 0.4465
# at 5000 steps (8 members, artifacts/campaign_10k); over 200 reactions the
# mean's standard error is ~0.03, and a broken score gives D-MAE > 1
DMAE_BOUND = 0.6


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def sh(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_card() -> str:
    import torch

    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from tsdiff_tpu_torch.ops import _build

    print(f"[card] {sh([_build.find_nvcc(), '--version']).splitlines()[-1]}")
    return smi.splitlines()[0]


def phase_build() -> None:
    from tsdiff_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.build(["packed_score"])
    print(f"[build] packed_score.cu built in {time.monotonic() - t0:.1f} s")
    for line in _build.build_info["packed_score"]["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}")


def load_members(dtype, device):
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.convert import params_from_jax
    from tsdiff_tpu_torch.models import CondenseEncoderEpsNetwork
    from tsdiff_tpu_torch.train import load_checkpoint, select_params

    members = []
    for seed in MEMBER_SEEDS:
        ck = load_checkpoint(os.path.join(CKPT_DIR, f"seed{seed}_best.ckpt"))
        model = CondenseEncoderEpsNetwork.from_config(Config(ck["config"]).model, dtype=dtype)
        model.load_state_dict(params_from_jax(select_params(ck, False)[0]))
        members.append(model.to(device).eval())
    return members


def kernel_batch(n_bucket: int, seed: int):
    """100 synthetic reactions in the ``n_bucket`` bucket, with a jittered
    geometry, on the card."""
    import numpy as np
    import torch

    from tsdiff_tpu_torch.core.graph import from_numpy_graphs
    from tsdiff_tpu_torch.data.synthetic import _bend_table, make_reaction

    rng = np.random.default_rng(seed)
    table = _bend_table()
    graphs = []
    while len(graphs) < 100:
        g = make_reaction(rng, table)
        if n_bucket - 8 < len(g["atom_type"]) <= n_bucket:
            graphs.append(g)
    batch = from_numpy_graphs(graphs, max_nodes=n_bucket, device="cuda")
    jitter = torch.from_numpy(rng.normal(scale=0.2, size=batch.pos.shape).astype(np.float32))
    pos = (batch.pos + jitter.to("cuda")) * batch.node_mask[..., None]
    return batch, pos


def phase_kernels() -> dict:
    import torch

    from tsdiff_tpu_torch.core.packed import eq_transform_packed
    from tsdiff_tpu_torch.diffusion.ensemble import stack_params
    from tsdiff_tpu_torch.ops import packed_score as ps

    result = {}
    # the main path runs bf16 at the N=16 and N=24 buckets; N=24 also in f32
    for n_bucket, dname in ((24, "float32"), (24, "bfloat16"), (16, "bfloat16")):
        dtype = getattr(torch, dname)
        batch, pos = kernel_batch(n_bucket, seed=1234 + n_bucket)
        members = load_members(dtype, torch.device("cuda"))
        model = members[0]
        pp = model.precompute_packed_pairs(batch.bond_mat, batch.node_mask)
        info = model.build_packed_pair_info(pos, batch.node_mask, pp)
        z = torch.stack([m.node_states(batch.atom_type, batch.r_feat, batch.p_feat,
                                       batch.node_mask) for m in members]).contiguous()
        w = stack_params([m.kernel_weights() for m in members])
        args = (w, z, info.d_in.contiguous(), info.cmask.contiguous(),
                pp.type_r_in, pp.type_p_in, pp.type_r_out, pp.type_p_out)
        L = model.num_convs

        def kernel():
            return ps.packed_score(*args, num_blocks=L)

        def plain():
            return ps.packed_score_reference(*args, num_blocks=L)

        out = kernel()
        ref = plain()
        torch.cuda.synchronize()
        err = (out - ref).abs()
        scale = ref.abs().max().item()
        eq_k = eq_transform_packed(out.mean(0), pos, info.m_eq, info.d_out)
        eq_r = eq_transform_packed(ref.mean(0), pos, info.m_eq, info.d_out)
        eq_err = (eq_k - eq_r).abs().max().item()
        eq_scale = eq_r.abs().max().item()
        tol_max, tol_mean = TOL[dname]
        tag = f"packed_score N={n_bucket} {dname}"
        print(f"[kernels] {tag} out {tuple(out.shape)}: max|ref| {scale:.6g} "
              f"max abs err {err.max().item():.6g} (rel {err.max().item() / scale:.3g}, "
              f"tol {tol_max}) mean abs err {err.mean().item():.6g} (rel "
              f"{err.mean().item() / scale:.3g}, tol {tol_mean}); node_eq max abs err "
              f"{eq_err:.6g} of max|ref| {eq_scale:.6g}")
        if not torch.isfinite(out).all():
            fail(f"{tag}: non-finite output")
        if err.max().item() > tol_max * scale or err.mean().item() > tol_mean * scale:
            fail(f"{tag}: kernel disagrees with the plain version")
        if eq_err > tol_max * eq_scale:
            fail(f"{tag}: node_eq disagrees with the plain version")

        iters = 20 if dtype == torch.bfloat16 else 3
        ms = cuda_time_ms(kernel, iters)
        plain_ms = cuda_time_ms(plain, 3, warmup=1)
        cost = ps.packed_score_cost(w, z, L)
        t_ops = cost["flops"] / PEAK_FLOPS[dname] * 1e3
        t_bytes = cost["bytes"] / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"[kernels] {tag}: {ms:.4f} ms/launch (kernel), {plain_ms:.4f} ms "
              f"(plain), bound {bound_ms:.4f} ms by {bound_by} ({cost['flops']:.4g} flop, "
              f"{cost['bytes']:.4g} bytes), {cost['flops'] / ms / 1e9:.4g} TFLOP/s achieved, "
              f"library_ms null (no single PyTorch call computes this function)")
        result[(n_bucket, dname)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                         bound_by=bound_by, max_abs_err=err.max().item())
        del members, z, w, args, out, ref
        torch.cuda.empty_cache()
    return result


def phase_profile(n_steps: int = 20) -> None:
    """Where a sampling step's time goes: ``n_steps`` ld steps of the 8-member
    bf16 ensemble on 100 reactions of the N=24 bucket under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tsdiff_tpu_torch.diffusion.ensemble import make_packed_ensemble_eps_fn
    from tsdiff_tpu_torch.diffusion.sampler import SamplingSettings, dynamic_sampling
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.train import load_checkpoint

    batch, pos = kernel_batch(24, seed=99)
    members = load_members(torch.bfloat16, torch.device("cuda"))
    cfg = Config(load_checkpoint(os.path.join(CKPT_DIR, "seed106_best.ckpt"))["config"]).model
    schedule = DiffusionSchedule.from_config(cfg)
    settings = SamplingSettings(n_steps=n_steps)
    gen = torch.Generator(device="cuda").manual_seed(0)
    node_eq_fn = make_packed_ensemble_eps_fn(members, batch)
    dynamic_sampling(node_eq_fn, schedule, pos, batch.node_mask, settings, generator=gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        dynamic_sampling(node_eq_fn, schedule, pos, batch.node_mask, settings, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernel_us = other_us = 0.0
    n_other = 0
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0.0)
        if dev <= 0:
            continue
        if "packed_score" in ev.key:
            kernel_us += dev
        else:
            other_us += dev
            n_other += ev.count
    print(f"[profile] {n_steps} ld steps, 8 members, B=100, N=24, bf16: wall {wall_ms:.3f} ms "
          f"({wall_ms / n_steps:.4f} ms/step)")
    if kernel_us == 0.0:
        print("[profile] the profiler shows no device time: breakdown not measured")
        return
    busy_ms = (kernel_us + other_us) / 1e3
    print(f"[profile] device time: packed_score kernel {kernel_us / 1e3 / n_steps:.4f} ms/step, "
          f"other kernels {other_us / 1e3 / n_steps:.4f} ms/step ({n_other / n_steps:.1f} "
          f"launches/step); device busy {busy_ms / wall_ms:.4f} of wall, idle "
          f"{1 - busy_ms / wall_ms:.4f}")


def phase_main_path() -> dict:
    import numpy as np

    from tsdiff_tpu_torch.cli import sampling
    from tsdiff_tpu_torch.data.dataset import save_dataset
    from tsdiff_tpu_torch.data.synthetic import make_corpus
    from tsdiff_tpu_torch.diffusion.sampler import SamplingSettings, build_step_coeffs
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from tsdiff_tpu_torch.eval.dmae import calc_dmae
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.ops import packed_score as ps
    from tsdiff_tpu_torch.train import load_checkpoint

    shutil.rmtree(OUT_DIR, ignore_errors=True)
    os.makedirs(OUT_DIR)
    test_set = os.path.join(OUT_DIR, "test_data.pkl")
    save_dataset(test_set, make_corpus(200, seed=2024))
    ckpts = [os.path.join(CKPT_DIR, f"seed{s}_best.ckpt") for s in MEMBER_SEEDS]
    n_steps, respacing, batch_size = 5000, 625, 100
    argv = ckpts + [
        "--test_set", test_set, "--save_dir", OUT_DIR, "--dtype", "bfloat16",
        "--fused_score", "--sort_by_size", "--sampling_type", "ld",
        "--n_steps", str(n_steps), "--timestep_respacing", str(respacing),
        "--batch_size", str(batch_size), "--device", "cuda",
    ]
    ps.packed_score.launches = 0
    ps.packed_score_reference.calls = 0
    t0 = time.monotonic()
    save_path = sampling.main(argv)
    wall = time.monotonic() - t0
    launches, plain_calls = ps.packed_score.launches, ps.packed_score_reference.calls

    with open(save_path, "rb") as f:
        results = pickle.load(f)
    cfg = Config(load_checkpoint(ckpts[0])["config"]).model
    steps = len(build_step_coeffs(
        DiffusionSchedule.from_config(cfg),
        SamplingSettings(n_steps=n_steps, timestep_respacing=respacing),
    ).a)
    attempts = [results[i]["sampling_attempts"] for i in range(0, len(results), batch_size)]
    expected = steps * sum(attempts)
    print(f"[main] {len(results)} samples in {len(attempts)} batches, attempts {attempts}, "
          f"{steps} model calls per run: kernel launches {launches} (expected {expected}), "
          f"plain-version calls {plain_calls}")
    if launches != expected:
        fail(f"kernel launched {launches} times, expected {expected}")
    if plain_calls != 0:
        fail(f"the plain version ran {plain_calls} times on the main path")
    if len(results) != 200:
        fail(f"{len(results)} samples, expected 200")
    for r in results:
        if r["pos_gen"].shape != (len(r["atom_type"]), 3) or not np.isfinite(r["pos_gen"]).all():
            fail("non-finite or misshaped pos_gen")
    dmae = np.array([calc_dmae(r["pos"], r["pos_gen"]) for r in results])
    model_calls = steps * sum(attempts)
    print(f"[main] wall {wall:.3f} s, {wall / model_calls * 1e3:.4f} ms per sampling step "
          f"(8 members, batch <= {batch_size}), {len(results) / wall:.4f} samples/s; "
          f"D-MAE mean {dmae.mean():.4f} median {np.median(dmae):.4f} (bound {DMAE_BOUND})")
    if not dmae.mean() < DMAE_BOUND:
        fail(f"mean D-MAE {dmae.mean():.4f} >= {DMAE_BOUND}")
    return dict(launches=launches, wall=wall, dmae_mean=float(dmae.mean()))


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(ROOT, "tsdiff_tpu_torch")):
        fail("tsdiff_tpu_torch not found beside chip_smoke.py: run it from the repository")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_card()
    phase_build()
    k = phase_kernels()
    main_path = phase_main_path()
    phase_profile()
    bf = k[(24, "bfloat16")]
    print(json.dumps({"kernels": [{
        "name": "packed_score",
        "route": "cuda",
        "source": "tsdiff_tpu_torch/csrc/packed_score.cu",
        "replaces": "tsdiff_tpu/ops/pallas/condensed_score_packed.py:164",
        "launches": main_path["launches"],
        "max_abs_err": bf["max_abs_err"],
        "ms": bf["ms"],
        "plain_ms": bf["plain_ms"],
        "bound_ms": bf["bound_ms"],
        "bound_by": bf["bound_by"],
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
