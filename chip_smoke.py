"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. card: name and power limit, SM clock and temperature, CUDA and nvcc
   versions;
2. build: compile the port's CUDA kernels from ``tsdiff_tpu_torch/csrc``, one
   nvcc per source, in parallel, cached libraries removed first so that the
   time is the build's; registers, spills and shared memory of every kernel
   from the ``ptxas`` log; fails if the dense score's warp-specialised kernel,
   B3's ``wgmma`` forward (both builds: B3 and B4), B3 backward's ``wgmma``
   row kernel or its ``wgmma`` weight-gradient kernel spills, or if ptxas
   serializes the ``wgmma`` of any stack kernel or of B1's warp-specialised
   kernel (C7512/C7520); prints the latter's spill stores;
3. kernels against their plain PyTorch versions at the main paths' shapes:
   the tile product of the warp-specialised kernels alone against a matrix
   product; the packed score step (B1) with the 8 trained campaign members on
   100 synthetic reactions with a jittered geometry, N=24 in float32 (TF32
   off, the ``mma.sync`` kernel) and bfloat16 and N=16 in bfloat16 (the
   warp-specialised ``wgmma`` kernel: two launches bitwise equal, its own
   launch counter, its L2 weight bytes per launch), then the ``wgmma`` kernel
   alone at N=8 (M=8, B=100), at a served tier (B=4) and at the mesh's M=4
   (N=16, 24), each against the plain version, two launches bitwise equal and
   counted, and on the same inputs in
   bfloat16 its int8 variant (B5: the same checks, and its tile product
   against an integer matrix product); the dense fused score step (B2) with
   seed106 on 100 reactions, N=24 in float32 (the ``mma.sync`` kernel) and
   bfloat16 and N=16 in bfloat16 (the warp-specialised ``wgmma`` kernel: two
   launches bitwise equal, its own launch counter), every output element;
   the fused SchNet stack (B3's forward and
   backward, B4) with seed106's stack weights on edge features from the
   port's dense model, bfloat16 at the training batch (B=200) in both
   training buckets (N=16, N=24) and float32 at B=16, N=24: in bf16 the
   forward and B4 through their ``wgmma`` kernel, fed the weight image and
   ``ea``'s tile images as a train step makes them (their own counters, two
   launches bitwise equal, B4 equal to B3's output), the backward's calls
   bitwise equal, also fed those, and through its ``wgmma`` row and
   weight-gradient kernels (float32 through neither: ``mma.sync``), with the
   backward's time split under torch.profiler into the row kernel and the
   weight-gradient kernels beside their bounds; in bf16 the weight-gradient
   kernel also alone on the plain backward's operands of the 7 blocks (two
   calls bitwise equal, against the plain products and ``torch.mm``), timed
   beside the same 35 products through ``torch.mm`` (float32 output), both
   also by their device time under torch.profiler, the figures kept in the
   JSON line (``ms_by``, ``library_ms_by``: "profiler"); errors, times
   (CUDA events: the median and the minimum of five timings of 20 launches,
   with the SM clock and temperature before and after) and the bound of each;
   then B3's forward and backward on the smooth cutoff's fractional mask
   (``0.5 (cos(pi d / cutoff) + 1)`` on the synthetic batch's distances, as
   a ``smooth_conv`` model feeds it) at B=200, N=24 in bf16 (the ``wgmma``
   kernels) and B=16 in f32, every output and gradient against the plain
   stack, with the share of edges whose mask is fractional;
4. sampling main path: the port's sampling CLI on 200 synthetic reactions
   with the 8 members, bf16, fused packed score, ``ld`` over the 5000-step
   schedule walked in 625 model calls, each step a replay of the CUDA graph
   of its (bucket, tier, clip), the run under torch.profiler; checks one
   graph per walk shape, B1 launched once per walk step and once more per
   graph (its eager first step) by kernel name in that run (replays advance
   no wrapper's counter), the wrapper's counter at each graph's eager first
   step and recording, all through the warp-specialised kernel, that
   positions are finite and that the mean D-MAE is plausible; then the same
   command unprofiled, for its time, its samples equal bit for bit; prints
   the D-MAE with identity matching (the gated figure) and matched over each
   graph's automorphisms (the reference metric, never above it);
5. sampling profile: 20 steps at N=24 under torch.profiler;
6. training paths, on a synthetic corpus at full width (H=256, L=7, batch
   200, bf16, 40 iterations), each train and validation step a replay of
   the CUDA graph of its (step kind, bucket), each run with finite losses,
   a written checkpoint and the CLI's graphs/s over the run; then 20 steps
   on one fixed N=24 batch (the loss must fall) eagerly, eagerly again and
   replayed from a graph, from the same initialisation, the second eager
   and the captured step started from the eager run's state on every step:
   the captured step equal to the eager one bit for bit on every step in
   every metric and in every tensor outside what the one nondeterministic
   op (F.embedding's backward into the bond table) feeds, with how often
   it and the second eager step differ inside; the time per step and a
   profile of the eager
   and the captured step (device ms, idle share, launches per step by
   kernel name); then the train CLI eagerly twice and once with the
   learning rate 1% higher (the control) on the first timed run's flags:
   every logged loss of the captured run within ``CLI_LOSS_RTOL`` of the
   eager run's, a limit that holds the second eager run and not the
   control; then 8 reactions sampled through B1 from the checkpoint it
   trained:
   a. the train CLI with ``use_pallas`` and its defaults (the corpus resident
      on the card by ``--device_data auto``) under torch.profiler: checks one
      graph per (step kind, bucket) and replays covering every step, the
      stack kernels counted by name in that run (B3's ``wgmma`` forward at
      every forward call, eager or replayed, B3 backward's ``wgmma`` row and
      weight-gradient kernels L times at every backward call, no B4 and no
      other stack kernel), the wrapper counters at each graph's eager first
      call and recording, the weight image and ``ea``'s tile images made
      once per forward and reused by the backward, and no plain-version
      call; then the same run unprofiled with ``--device_data auto``,
      ``off``, ``off`` and ``auto`` (graphs/s of each);
   b. the production command line, ``--tag seed0 --dtype bfloat16
      --packed_train --device_data auto`` on the trained members' ``model``
      block: the run directory ends in ``_seed0``, the log reports the
      resident corpus, no stack kernel, no B1 and no plain version ran; then
      the same with ``--device_data off``, ``off`` and ``auto`` again, each
      checked the same way (graphs/s of each);
7. dense sampling path: seed106 with ``fused_score`` through ``make_score_fn``
   and ``dynamic_sampling`` on 100 reactions of the N=24 bucket, 625 launches
   of the dense score kernel (B2), all of its warp-specialised kernel, against
   the unfused torch path and the 8-member packed ensemble on the same
   reactions and noise; both D-MAE figures as in phase 4;
8. int8 sampling path: phase 4 with ``--quant int8``: the warp-specialised
   int8 kernel (B5) once per walk step and once more per graph by kernel
   name in the profiled run, at each graph's eager first step and recording
   by its counter, none of B1, D-MAE within noise of phase 4;
9. serving: ``tsdiff_tpu_torch.serve.SamplerService`` and its HTTP front in
   this process on 127.0.0.1, with the 8 members, bf16, ``fused_score``,
   5000 steps and a draft tier of 625, ``max_batch`` 32, ``max_wait_ms`` 50,
   each (bucket, tier, respacing) walked by replaying one CUDA graph of the
   sampling step: (a) phase 4's 200 reactions as draft requests from 8 client
   threads, each POSTing 1-8 graphs at a time, (b) 32 of them at full
   quality, each with requests/s, p50 and p99 latency, the rounds by (bucket,
   respacing, tier) and the D-MAE (gate as phase 4); one recording per
   (bucket, tier, respacing), the peak memory; (c) captured rounds against
   eager rounds on the same seed, through B1 and B5 at tiers 4 and 32, N=24:
   equal bit for bit; B1 and B5 against their plain versions on the statics
   and positions of served rounds at N=8, 16, 24 and tiers 4 and 32; their
   launches counted by kernel name under torch.profiler in captured rounds
   of 25 steps (exactly 25 each); (d) for tiers 4, 8, 16, 32 at N=24 the ms
   per step of a 625-step round eager and captured, and from a profiled
   25-step round the device ms per step, the idle share against the
   unprofiled step and B1's time per launch; (e) the
   command line ``python -m tsdiff_tpu_torch.serve`` in its own process:
   ``/healthz``, one draft ``POST /generate``, a 404, then stopped;
10. reference interop: (a) the 8 members written as reference ``.pt`` files
   (``torch.save``, an ``easydict`` config, the schedule buffers) and phase
   4's first 100 reactions as a PyG pickle, sampled with phase 4's flags,
   against the ``.ckpt`` files on the native pickle of the same reactions:
   ``pos_gen`` equal bit for bit, B1's ``wgmma`` kernel in every walk (each
   sampling run under torch.profiler, B1 once per walk step and once more
   per graph by kernel name), the evaluate CLI's D-MAE of both; (b) phase 6b's
   command line with ``--pretrain`` seed101's ``.pt``: finite losses, the
   warm-start file logged, the last validation loss below phase 6b's from
   random init; (c) that run resumed for 20 more iterations with
   ``--profile``: the checkpoint read holds the optimizer state in the JAX
   package's layout, the count continues, ``Phase timings:`` logs the
   ``tsdiff.train.data`` and ``tsdiff.train.step`` spans and ``trace.json``
   is written; (d) the 100 true geometries plus N(0, 0.3 A) noise
   attached by the post-processing CLI as ``ts_guess`` and refined with
   ``--from_ts_guess --denoise_from_time_t 1500`` (the 1500-step window in
   625 calls) through B1, counted as in (a): finite, mean D-MAE < 0.6;
11. the native packer and the mesh of ranks: (a) ``from_numpy_graphs``
   through the C++ packer (sparse edges; phase 4's test set and phase 6's
   corpus are written so) against the numpy packer (dense ``bond_mat``) on
   the training corpus's batches (B=200, N=16 and 24) and the sampling
   CLI's (B=100, N=24): equal bit for bit, host ms per batch (median of 20),
   and phase 6's streamed graphs/s beside the numpy packer's; B1 and B5 at
   the mesh's call shapes (4 members at B=100, 8 at B=50) and B3 at B=100
   against their plain versions, timed; then two rank processes on the card
   over Gloo
   (this script with ``--mesh-rank``), on the (1, 2) and the (2, 1) mesh:
   (b) one step of the packed ensemble's score against 8 members in one
   process on the same inputs (``MESH_STEP_RTOL`` of max|ref| at ens=2, bit
   for bit at dp=2), then the sampling CLI on phase 4's command against
   phase 4's samples (bit for bit at dp=2; at ens=2 the 90th percentile of
   the per-reaction difference within ``MESH_WALK_P90``, beside a control
   run with another seed, and D-MAE within ``MESH_DMAE_DELTA``), B1 counted
   by kernel name on each rank (625 per walk) with its members per launch;
   (c) the train CLI ``--multihost`` with ``use_pallas``, bf16, 20
   iterations, its logged losses within ``CLI_LOSS_RTOL`` of one process's,
   B3 counted by name on each rank; (d) a served draft round at tier 8 on
   each mesh against one process's; (e) with two or more GPUs, the same over
   NCCL with the collectives captured, else a line that it was not run
   (``python3 chip_smoke.py --mesh-nccl`` runs that part alone);
12. the GeoDiff-legacy family, configs/geodiff_legacy/qm9_default.yml at
   full width (H=128, 6 SchNet blocks, 4 GIN layers, edge order 3, cutoff
   10 A, batch 64, f32, TF32 off) on a synthetic conformer corpus (200 +
   20 + 50 molecules of 9-29 atoms with hydrogens, 5 conformers each):
   the train CLI, 40 iterations, for ``type: diffusion`` and a ``type: dsm``
   copy (finite losses, the last validation loss below the first, every
   step a graph replay) and one train step eager and captured; the card's
   ``make_dual_eps_fn`` and both losses against the port on the CPU
   (weights, inputs and draws injected; ``TS`` false and true and a
   ``smooth_conv`` copy; within ``LEGACY_AGREE`` of max|CPU|); the sampling
   CLI on 50 molecules x 10 samples, ``ld`` in 625 calls of 5000 steps,
   and the DSM checkpoint with ``--n_steps 20 --sigma_respacing 10`` (no
   NaN flag, finite, walks captured; ms per step, samples/s); the
   clustering CLI on sample 0's molecule; the evaluate CLI's ``--covmat``
   on the samples grouped with their reference stacks (COV-R/MAT-R,
   COV-P/MAT-P); self-checks: the references against themselves give COV
   1.0 and MAT < 1e-6, and ``cluster_conformers`` finds G clusters in G
   known groups;
13. the protein sidechain path: (a) configs/protein_sidechain.yml at full
   width (``PROTEIN_SIDECHAIN``: dual encoder, DSM, H=128, 4+4 convs, cutoff
   10 A, 50 levels) on synthetic compact proteins of 128 residues at about
   protein density (``data/synthetic.py::compact_protein_pdb``, 10-A balls
   of 90-400 atoms) featurized by ``preprocessing --pdb_glob``; the train
   CLI in sidechain mode for 40 captured steps at batch 8 (the config's 32
   and 16 do not fit; peak memory); the protein_sampling CLI with
   ``--sigma_respacing 5 --n_steps 10`` on the model's seeded
   initialisation, captured and eager (pos_gen equal bit for bit, the
   backbone exact, every sidechain atom scored, no NaN flag), ms per walk
   step of a covering batch replayed and eager, the default walk
   extrapolated; the same CLI and the evaluate CLI's ``--protein`` on the
   trained checkpoint; ``accumulate_protein_eps`` on the card against the
   CPU within ``PROTEIN_AGREE``; (b) the JAX protein gate's pipeline
   (``tests/test_protein_gate.py::run_gate``: its corpus, model, 4000 Adam
   steps at 3e-4 as a captured step, the held-out chains through the
   protein_sampling CLI, the untrained model and the trans-180 template),
   two models each sampled with 6 seeds: the RMSD threshold on the pooled
   RMSD, the rotamer thresholds on chi1 read modulo the backbone plane's
   reflection (``mirror_chi1``), the signed thresholds printed as missed
   where they miss (ROADMAP §C.3); (c) the protein_sampling CLI at dp=2,
   two Gloo ranks on one card, on the seeded model, equal to one process
   bit for bit;
14. the optional encoders from ``load_encoder`` at the JAX defaults' widths
   (EGNN H=128, 5 convs; DimeNet++ H=128, 4 layers, 7 spherical, 6 radial;
   ComENet H=256, 4 layers), B=8, N=24 and 32, f32, TF32 off, eval mode:
   output and every parameter's gradient on the card against the CPU
   (``ENCODER_AGREE``, or ``ENCODER_F32_FACTOR`` times the CPU's own float32
   error against float64 where larger), and the card's forward without
   autograd against its forward with it under the same limit (DimeNet++'s
   blocks take the triplet kernel without autograd: one launch a block by
   its counter), ms per forward and backward; whether sympy imports there,
   for information;
15. checkpoint directories and the build cache: (a) the train CLI with 6a's
   flags and ``--ckpt_backend orbax`` under torch.profiler, a ``.ckpt`` of
   the same state written beside each save: every ``.orbax`` directory loads
   through the port to that ``.ckpt``'s arrays bit for bit (params,
   optimizer state, EMA), B3 at every step by kernel name; then unprofiled
   with ``orbax``, ``pickle``, ``pickle``, ``orbax``: the ms each save held
   the loop, each orbax write's ms and the wait at the loop's end, graphs/s;
   (b) that run
   resumed for 10 iterations from its ``.orbax`` and from its ``.ckpt``
   files: logged losses within ``CLI_LOSS_RTOL`` (phase 6's F.embedding
   caveat); (c) the 8 members written as ``.orbax`` directories and sampled
   with phase 10's command on its 100 reactions: equal to phase 10's
   ``.ckpt`` samples bit for bit, B1 once per walk step by kernel name; (d)
   the JAX package's orbax directory committed in ``tests/torch_data``
   (OCDBT, zstd) read to its ``.npz``, the zstd library named; (e) two
   processes (``--cache-probe``) in turn on one empty
   ``TSDIFF_COMPILE_CACHE``: each builds the kernels and the packer (or
   finds them there) and launches B1 once; the second builds nothing
   (``_build.build_info`` 0.0); ``tsdiff_tpu_torch/_build/`` untouched;
16. DimeNet++ through the captured walk: the condensed network with
   DimeNet++ at its published widths (the benchmark's configuration and
   stand-in weights), bf16, B=100 synthetic reactions in the N=16 and N=24
   buckets, ``PROFILED_WALK`` steps of ``ld`` replayed from one CUDA graph
   under torch.profiler: the triplet kernel (``csrc/dimenet_triplet.cu``)
   once a block at each step by kernel name, its counter at the eager first
   step and the recording, the plain version never called; the kernel on
   the four blocks' inputs recorded at the reactions' jittered geometry against
   the plain version (``TOL_TRIPLET``), two launches bitwise equal; its
   time beside its bound and the plain version's einsums.

The second-to-last lines are a JSON object of per-kernel numbers and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import atexit
import contextlib
import io
import json
import os
import pickle
import re
import resource
import shutil
import signal
import subprocess
import sys
import time

PROCESS_T0 = time.monotonic()   # phase 15's cache probes time their start from here

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT_DIR = os.path.join(ROOT, "artifacts", "seeds", "ckpts")
# the 8 members of the 10k-reaction campaign (artifacts/campaign_10k)
MEMBER_SEEDS = (106, 101, 104, 102, 108, 103, 109, 105)
OUT_DIR = os.path.join(ROOT, ".scratch", "chip_smoke")  # gitignored
TRAIN_DIR = os.path.join(ROOT, ".scratch", "chip_smoke_train")
SOURCES = ("packed_score", "schnet_stack", "condensed_score", "packed_score_int8",
           "dimenet_triplet")

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 without them
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12
# launches per timing of a kernel; cuda_time_ms takes five such timings
TIMING_ITERS = 20
# a B3 backward kernel's name in a profile, without "_kernel" and its arguments
BWD_KERNEL = re.compile(r"schnet_bwd_\w*?(?=_kernel)")

# kernel vs plain version, as a fraction of the output's largest magnitude,
# for every kernel and every output (the stack's gradients included):
# float32 only reorders float32 sums; bfloat16 rounds at the same points in
# both, but a reordered float32 sum can flip a rounding by one bf16 ulp
# (2^-8) and such flips propagate through the 7 blocks
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 3e-3)}  # (max, mean)
# the int8 kernel in bf16: its int32 sums are exact on both sides, but an
# activation that a flipped bf16 rounding moves across a tie of its row's
# quantization flips that int8 code by one, 1/127 of the row's maximum: two
# bf16 ulps (2^-8) of it where the flipped rounding itself moved it by one.
# So twice the bf16 tolerance
TOL_INT8 = (6e-2, 6e-3)
# mean D-MAE of the main path: the JAX package measured 0.4365 for `ld` at
# 625 respaced steps (4 members, artifacts/respacing_curve.json) and 0.4465
# at 5000 steps (8 members, artifacts/campaign_10k); over 200 reactions the
# mean's standard error is ~0.03, and a broken score gives D-MAE > 1
DMAE_BOUND = 0.6
# the dense path samples 100 reactions of the N=24 bucket alone (17-24 atoms).
# On those every path of the port scores 0.78-0.79 (the 8-member packed
# ensemble and the unfused model on the same reactions and noise, which
# phase 7 runs and prints beside the fused run), so the bound there is 1.0 and
# the check that carries the weight is the agreement with the unfused run
DMAE_BOUND_N24 = 1.0
DMAE_FUSED_DELTA = 0.03
# the batch tiers of the serving phase (max_batch 32 and its halvings)
SERVE_TIERS = (4, 8, 16, 32)
# the steps of a profiled serving round: short enough that its trace holds
# every launch (a profiled round of 625 steps came out a few records short)
PROFILED_WALK = 25
# the int8 run against the bf16 run on the same reactions and seeds: within
# the mean's standard error (the JAX package's gate is "within noise")
DMAE_INT8_DELTA = 0.03


def fail(msg: str) -> None:
    """Print the failure on both streams (a caller may keep only one) and exit 1."""
    print(f"FAILED: {msg}", flush=True)
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sh(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


def cuda_time_ms(fn, iters: int, repeats: int = 5, warmup: int = 2) -> tuple[float, float]:
    """``(median, minimum)`` over ``repeats`` timings of ``iters`` launches
    each (CUDA events, after ``warmup`` launches), in ms per launch.  One mean
    of 20 launches spread 9 % between two runs on the same card and code."""
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times)), float(min(times))


def smi_clocks(tag: str) -> None:
    """The card's SM clock and temperature now, beside the timings."""
    print(f"[{tag}] SM clock, temperature: "
          f"{sh(['nvidia-smi', '--query-gpu=clocks.sm,temperature.gpu', '--format=csv,noheader'])}")


def phase_card() -> str:
    import torch

    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from tsdiff_tpu_torch.ops import _build

    print(f"[card] {sh([_build.find_nvcc(), '--version']).splitlines()[-1]}")
    smi_clocks("card")
    return smi.splitlines()[0]


def phase_build() -> None:
    """Build every kernel library from the sources: cached libraries of
    these sources are removed first, so the time printed is nvcc's.  Fails if
    the dense score's warp-specialised kernel spills."""
    import glob

    from tsdiff_tpu_torch.ops import _build

    for name in SOURCES:
        for old in glob.glob(os.path.join(_build.BUILD_ROOT, f"{name}-*")):
            shutil.rmtree(old)
    t0 = time.monotonic()
    _build.build(list(SOURCES))
    print(f"[build] {', '.join(f'{n}.cu' for n in SOURCES)} built in "
          f"{time.monotonic() - t0:.1f} s, one nvcc each in parallel (" + ", ".join(
              f"{n} {_build.build_info[n]['seconds']:.1f} s" for n in SOURCES) + ")")
    spills, wg_dense_spills, wg_rows_spills, wg_xty_spills, wg_fwd_spills = 0, None, None, None, {}
    wg_b1_spills, triplet_spills = None, {}
    for name in SOURCES:
        # ptxas -v: "Compiling entry function '<mangled>'", then its stack and
        # spill line, then "Used N registers, ..."
        kernel, stack = "?", "0 bytes spill stores"
        for line in _build.build_info[name]["log"].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                short = re.search(r"\d+(packed_score\w*?kernel|tile_product\w*?kernel|schnet_\w*?kernel|"
                                  r"condensed_score\w*?kernel|dimenet_triplet_kernel)(I\w+?)?E",
                                  m.group(1))
                kernel = (short.group(1) + (short.group(2) or "")) if short else m.group(1)[-60:]
            elif "bytes spill" in line:
                stack = line.strip()
            elif "Used" in line and "registers" in line:
                n_spill = int(re.search(r"(\d+) bytes spill stores", stack).group(1))
                spills += n_spill
                if kernel == "condensed_score_wg_kernel":
                    wg_dense_spills = n_spill
                if kernel == "packed_score_wg_kernel":
                    wg_b1_spills = n_spill
                if kernel == "schnet_bwd_rows_wg_kernel":
                    wg_rows_spills = n_spill
                if kernel == "schnet_bwd_xty_wg_kernel":
                    wg_xty_spills = n_spill
                if kernel.startswith("schnet_fwd_wg_kernel"):  # B3 (hs stored) and B4
                    wg_fwd_spills[kernel] = n_spill
                if kernel.startswith("dimenet_triplet_kernel"):  # ILb1: bf16, ILb0: float32
                    triplet_spills[kernel] = n_spill
                print(f"[build] {name}: {kernel}: {line.strip().replace('ptxas info    : ', '')}; "
                      f"{stack}")
    print(f"[build] spill stores over all kernels: {spills} bytes; of the dense score's "
          f"warp-specialised kernel: {wg_dense_spills} bytes, of B3 backward's wgmma row kernel: "
          f"{wg_rows_spills} bytes, of its wgmma weight-gradient kernel: {wg_xty_spills} bytes, "
          f"of the wgmma forward (B3, B4): {wg_fwd_spills} (all must be 0); of B1's "
          f"warp-specialised kernel: {wg_b1_spills} bytes (1,176 before its filter chain "
          f"ran in registers); of DimeNet++'s triplet kernel (Lb1 bf16, Lb0 float32): "
          f"{triplet_spills}")
    if len(triplet_spills) != 2:
        fail(f"dimenet_triplet_kernel was not found twice in the ptxas log: {triplet_spills}")
    if wg_dense_spills != 0:
        fail(f"condensed_score_wg_kernel spills {wg_dense_spills} bytes (or was not found)")
    if wg_rows_spills != 0:
        fail(f"schnet_bwd_rows_wg_kernel spills {wg_rows_spills} bytes (or was not found)")
    if wg_xty_spills != 0:
        fail(f"schnet_bwd_xty_wg_kernel spills {wg_xty_spills} bytes (or was not found)")
    if len(wg_fwd_spills) != 2 or any(wg_fwd_spills.values()):
        fail(f"schnet_fwd_wg_kernel spills, or was not found twice: {wg_fwd_spills}")
    # ptxas says C7512 / C7520 where it serializes a kernel's wgmma; the stack's
    # library has three wgmma kernels, the forward and the backward's row and
    # weight-gradient kernels
    serialized = [line.strip() for line in _build.build_info["schnet_stack"]["log"].splitlines()
                  if re.search(r"C75(12|20)", line)]
    print(f"[build] schnet_stack: {len(serialized)} wgmma serialization lines (C7512/C7520)"
          + "".join(f"\n[build]   {line[:200]}" for line in serialized))
    if serialized:
        fail("ptxas serializes the wgmma of schnet_fwd_wg_kernel, schnet_bwd_rows_wg_kernel or "
             "schnet_bwd_xty_wg_kernel")
    # B1's filter chain holds f2's 128 accumulators beside f1's
    serialized = [line.strip() for line in _build.build_info["packed_score"]["log"].splitlines()
                  if re.search(r"C75(12|20)", line) and "packed_score_wg_kernel" in line]
    print(f"[build] packed_score: {len(serialized)} wgmma serialization lines (C7512/C7520) of "
          f"packed_score_wg_kernel" + "".join(f"\n[build]   {line[:200]}" for line in serialized))
    if serialized:
        fail("ptxas serializes the wgmma of packed_score_wg_kernel")


def load_member(seed: int, dtype, device, **model_overrides):
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.convert import params_from_jax
    from tsdiff_tpu_torch.models import CondenseEncoderEpsNetwork
    from tsdiff_tpu_torch.train import load_checkpoint, select_params

    ck = load_checkpoint(os.path.join(CKPT_DIR, f"seed{seed}_best.ckpt"))
    cfg = Config({**ck["config"]["model"], **model_overrides})
    model = CondenseEncoderEpsNetwork.from_config(cfg, dtype=dtype)
    model.load_state_dict(params_from_jax(select_params(ck, False)[0]))
    return model.to(device).eval()


def load_members(dtype, device):
    return [load_member(seed, dtype, device) for seed in MEMBER_SEEDS]


def time_and_bound(tag: str, kernel, plain, cost: dict, dname: str, library=None,
                   library_what: str = "") -> dict:
    """Kernel and plain-version times (CUDA events, warmed up; the median and
    the minimum of five timings) beside the bound: the larger of operations /
    peak rate (working-type flop and, where the kernel has them, int8
    operations, each at its own rate, summed) and bytes / memory rate; and,
    where ``library`` is given, the time of the PyTorch call that computes
    the same function (``library_what`` says which)."""
    ms, ms_min = cuda_time_ms(kernel, TIMING_ITERS)
    plain_ms, plain_min = cuda_time_ms(plain, 2, warmup=1)
    lib_ms = lib_min = None
    lib_text = "library_ms null (no single PyTorch call computes this function)"
    if library is not None:
        lib_ms, lib_min = cuda_time_ms(library, TIMING_ITERS)
        lib_text = (f"library {lib_ms:.4f} ms (median; minimum {lib_min:.4f}; {library_what}), "
                    f"the kernel {ms / lib_ms:.3f}x of it")
    t_ops = (cost["flops"] / PEAK_FLOPS[dname] + cost.get("int8_ops", 0) / PEAK_INT8) * 1e3
    t_bytes = cost["bytes"] / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"[kernels] {tag}: {ms:.4f} ms/launch (kernel, median of 5 timings of {TIMING_ITERS} "
          f"launches; minimum {ms_min:.4f}), {plain_ms:.4f} ms (plain, median; minimum "
          f"{plain_min:.4f}), bound "
          f"{bound_ms:.4f} ms by {bound_by} ({cost['flops']:.4g} flop, "
          f"{cost.get('int8_ops', 0):.4g} int8 operations, {cost['bytes']:.4g} bytes), "
          f"{(cost['flops'] + cost.get('int8_ops', 0)) / ms / 1e9:.4g} T operations/s achieved, "
          f"{lib_text}")
    return dict(ms=ms, ms_min=ms_min, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms, library_ms_min=lib_min, ms_by="events",
                library_ms_by=None if lib_ms is None else "events")


def check_close(tag: str, out, ref, dname: str, tol=None) -> float:
    """Kernel output against the plain version, within ``tol`` (default
    TOL[dname]) of max|ref|; returns the max abs error."""
    import torch

    err = (out.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    e_max, e_mean = err.max().item(), err.mean().item()
    tol_max, tol_mean = tol or TOL[dname]
    print(f"[kernels] {tag} {tuple(out.shape)}: max|ref| {scale:.6g} max abs err {e_max:.6g} "
          f"(rel {e_max / scale:.3g}, tol {tol_max}) mean abs err {e_mean:.6g} (rel "
          f"{e_mean / scale:.3g}, tol {tol_mean})")
    if not torch.isfinite(out).all():
        fail(f"{tag}: non-finite output")
    if e_max > tol_max * scale or e_mean > tol_mean * scale:
        fail(f"{tag}: kernel disagrees with the plain version")
    return e_max


def bucket_graphs(rng, n_bucket: int, count: int) -> list[dict]:
    """``count`` synthetic reactions of the ``n_bucket`` bucket (more than
    ``n_bucket - 8`` atoms, at most ``n_bucket``) drawn from ``rng``."""
    from tsdiff_tpu_torch.data.synthetic import _bend_table, make_reaction

    table, graphs = _bend_table(), []
    while len(graphs) < count:
        g = make_reaction(rng, table)
        if n_bucket - 8 < len(g["atom_type"]) <= n_bucket:
            graphs.append(g)
    return graphs


def kernel_batch(n_bucket: int, seed: int, count: int = 100):
    """``count`` synthetic reactions in the ``n_bucket`` bucket, with a
    jittered geometry, on the card."""
    import numpy as np
    import torch

    from tsdiff_tpu_torch.core.graph import from_numpy_graphs

    rng = np.random.default_rng(seed)
    batch = from_numpy_graphs(bucket_graphs(rng, n_bucket, count), max_nodes=n_bucket,
                              device="cuda")
    jitter = torch.from_numpy(rng.normal(scale=0.2, size=batch.pos.shape).astype(np.float32))
    pos = (batch.pos + jitter.to("cuda")) * batch.node_mask[..., None]
    return batch, pos


def phase_kernels() -> dict:
    import torch

    from tsdiff_tpu_torch.core.packed import eq_transform_packed
    from tsdiff_tpu_torch.diffusion.ensemble import stack_params
    from tsdiff_tpu_torch.ops import packed_score as ps
    from tsdiff_tpu_torch.ops import packed_score_int8 as p8

    smi_clocks("kernels")
    result = {}
    # the warp-specialised kernels' tile product alone: 64 x 256 by the arranged
    # 256 x 256 weight through the ring, A from shared memory and from
    # registers, against a float32 matrix product (bf16 products are exact in
    # float32: only the order of the 256-term sums differs)
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(64, 256, generator=gen).to("cuda", torch.bfloat16)
    wt = (torch.randn(256, 256, generator=gen) / 16).to("cuda", torch.bfloat16)
    prod = ps.tile_product_selftest(a, wt)
    torch.cuda.synchronize()
    want = a.float() @ wt.float().T
    for i, name in enumerate(("A from shared memory", "A from registers",
                              "full width from K-blocks")):
        err = (prod[i] - want).abs().max().item()
        print(f"[kernels] tile product, {name}: max abs err {err:.3g} of max|ref| "
              f"{want.abs().max().item():.4g} (tol 1e-4 of it)")
        if not err <= 1e-4 * want.abs().max().item():
            fail(f"the tile product ({name}) disagrees with the matrix product")
    # the same for the int8 kernel's tile product, against an integer matrix product: exact
    a8 = torch.randint(-127, 128, (64, 256), generator=gen, dtype=torch.int8).to("cuda")
    w8t = torch.randint(-127, 128, (256, 256), generator=gen, dtype=torch.int8).to("cuda")
    prod8 = p8.tile_product_selftest_int8(a8, w8t)
    torch.cuda.synchronize()
    exact = torch.equal(prod8, (a8.double() @ w8t.double().T).to(torch.int32))
    print(f"[kernels] int8 tile product: equal to the integer matrix product: {exact}")
    if not exact:
        fail("the int8 tile product disagrees with the integer matrix product")
    # the main path runs bf16 at the N=16 and N=24 buckets; N=24 also in f32
    for n_bucket, dname in ((24, "float32"), (24, "bfloat16"), (16, "bfloat16")):
        dtype = getattr(torch, dname)
        batch, pos = kernel_batch(n_bucket, seed=1234 + n_bucket)
        members = load_members(dtype, torch.device("cuda"))
        model = members[0]
        pp = model.precompute_packed_pairs(batch.bond_mat, batch.node_mask)
        info = model.build_packed_pair_info(pos, batch.node_mask, pp)
        with torch.no_grad():
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

        wg_before = ps.packed_score.wg_launches
        out = kernel()
        again = kernel()
        ref = plain()
        torch.cuda.synchronize()
        tag = f"packed_score N={n_bucket} {dname}"
        # bf16 takes the warp-specialised kernel, f32 the mma.sync kernel
        took_wg = ps.packed_score.wg_launches - wg_before
        M, B = z.shape[:2]
        print(f"[kernels] {tag}: {took_wg} of 2 launches took the warp-specialised kernel; two "
              f"launches bitwise equal: {torch.equal(out, again)}; L2 weight bytes per launch "
              f"{ps.wg_l2_weight_bytes(M, B, n_bucket, L):.4g} (warp-specialised, "
              f"{len(ps.wg_schedule(n_bucket, L))} stages of {ps.STAGE_BYTES} bytes per CTA) "
              f"against {ps.mma_sync_l2_weight_bytes(M, B, n_bucket, L):.4g} (mma.sync)")
        if took_wg != (2 if dtype == torch.bfloat16 else 0):
            fail(f"{tag}: {took_wg} launches of the warp-specialised kernel")
        if not torch.equal(out, again):
            fail(f"{tag}: two launches on the same inputs differ")
        del again
        e_max = check_close(f"{tag} out", out, ref, dname)
        eq_k = eq_transform_packed(out.mean(0), pos, info.m_eq, info.d_out)
        eq_r = eq_transform_packed(ref.mean(0), pos, info.m_eq, info.d_out)
        eq_err = (eq_k - eq_r).abs().max().item()
        eq_scale = eq_r.abs().max().item()
        print(f"[kernels] {tag} node_eq: max abs err {eq_err:.6g} of max|ref| {eq_scale:.6g}")
        if eq_err > TOL[dname][0] * eq_scale:
            fail(f"{tag}: node_eq disagrees with the plain version")

        timing = time_and_bound(tag, kernel, plain, ps.packed_score_cost(w, z, L), dname)
        result[(n_bucket, dname)] = dict(timing, max_abs_err=e_max)
        del w, args, out, ref

        if dtype == torch.bfloat16:   # B5 runs in bf16 only on the int8 path
            w8 = stack_params([m.kernel_weights_int8() for m in members])
            args8 = (w8, z, info.d_in.contiguous(), info.cmask.contiguous(),
                     pp.type_r_in, pp.type_p_in, pp.type_r_out, pp.type_p_out)

            def kernel8():
                return p8.packed_score_int8(*args8, num_blocks=L)

            def plain8():
                return p8.packed_score_int8_reference(*args8, num_blocks=L)

            wg_before = p8.packed_score_int8.wg_launches
            out8, again8, ref8 = kernel8(), kernel8(), plain8()
            torch.cuda.synchronize()
            tag = f"packed_score_int8 N={n_bucket} {dname}"
            took_wg = p8.packed_score_int8.wg_launches - wg_before
            print(f"[kernels] {tag}: {took_wg} of 2 launches took the warp-specialised kernel; two "
                  f"launches bitwise equal: {torch.equal(out8, again8)}; L2 weight bytes per launch "
                  f"{p8.wg_l2_weight_bytes_int8(M, B, n_bucket, L):.4g} (warp-specialised, "
                  f"{len(p8.wg_schedule_int8(n_bucket, L))} stages of {ps.STAGE_BYTES} bytes per "
                  f"CTA) against {p8.mma_sync_l2_weight_bytes_int8(M, B, n_bucket, L):.4g} (mma.sync)")
            if took_wg != 2:
                fail(f"{tag}: {took_wg} launches of the warp-specialised kernel")
            if not torch.equal(out8, again8):
                fail(f"{tag}: two launches on the same inputs differ")
            del again8
            e_max = check_close(f"{tag} out", out8, ref8, dname, tol=TOL_INT8)
            timing = time_and_bound(tag, kernel8, plain8,
                                    p8.packed_score_int8_cost(w8, z, L), dname)
            result[("int8", n_bucket, dname)] = dict(timing, max_abs_err=e_max)
            del w8, args8, out8, ref8
        del members, z
        torch.cuda.empty_cache()
    b1_shapes()
    return result


def b1_shapes() -> None:
    """B1's ``wgmma`` kernel alone at the other shapes its callers launch: N=8
    at the campaign's M=8, B=100, a served tier (B=4) and the mesh's four
    members a rank (M=4), on synthetic reactions with the campaign members'
    weights: against the plain version, two launches bitwise equal and counted
    by ``packed_score.wg_launches``."""
    import torch

    from tsdiff_tpu_torch.diffusion.ensemble import stack_params
    from tsdiff_tpu_torch.ops import packed_score as ps

    members = load_members(torch.bfloat16, torch.device("cuda"))
    for n_bucket, M, B in ((8, 8, 100), (16, 8, 4), (24, 8, 4), (16, 4, 100), (24, 4, 100)):
        batch, pos = kernel_batch(n_bucket, seed=4321 + 7 * n_bucket + B, count=B)
        model = members[0]
        pp = model.precompute_packed_pairs(batch.bond_mat, batch.node_mask)
        info = model.build_packed_pair_info(pos, batch.node_mask, pp)
        with torch.no_grad():
            z = torch.stack([m.node_states(batch.atom_type, batch.r_feat, batch.p_feat,
                                           batch.node_mask) for m in members[:M]]).contiguous()
        w = stack_params([m.kernel_weights() for m in members[:M]])
        args = (w, z, info.d_in.contiguous(), info.cmask.contiguous(),
                pp.type_r_in, pp.type_p_in, pp.type_r_out, pp.type_p_out)
        before = ps.packed_score.wg_launches
        out = ps.packed_score(*args, num_blocks=model.num_convs)
        again = ps.packed_score(*args, num_blocks=model.num_convs)
        ref = ps.packed_score_reference(*args, num_blocks=model.num_convs)
        torch.cuda.synchronize()
        tag = f"packed_score N={n_bucket} M={M} B={B} bfloat16"
        took = ps.packed_score.wg_launches - before
        print(f"[kernels] {tag}: {took} of 2 launches took the warp-specialised kernel; two "
              f"launches bitwise equal: {torch.equal(out, again)}")
        if took != 2:
            fail(f"{tag}: {took} launches of the warp-specialised kernel")
        if not torch.equal(out, again):
            fail(f"{tag}: two launches on the same inputs differ")
        check_close(f"{tag} out", out, ref, "bfloat16")
    del members
    torch.cuda.empty_cache()


def phase_dense_kernels() -> dict:
    """B2 against its plain version, every output element: seed106 on 100
    reactions with a jittered geometry, N=24 in float32 (the mma.sync kernel)
    and bfloat16 and N=16 in bfloat16 (the warp-specialised wgmma kernel: two
    launches bitwise equal, its own launch counter)."""
    import torch

    from tsdiff_tpu_torch.ops import condensed_score as cs

    result = {}
    for n_bucket, dname in ((24, "float32"), (24, "bfloat16"), (16, "bfloat16")):
        dtype = getattr(torch, dname)
        batch, pos = kernel_batch(n_bucket, seed=4321 + n_bucket)
        model = load_member(106, dtype, torch.device("cuda"))
        with torch.no_grad():
            static = model.precompute_static(batch.atom_type, batch.r_feat, batch.p_feat,
                                             batch.bond_mat, batch.node_mask)
            edges_in, d_in, _, _ = model.build_pair_info(pos, batch.node_mask, static.pairs)
        cmask = ((d_in <= model.cutoff) & edges_in.mask_global).float()
        w = model.fused_weights()
        args = (w, static.z.contiguous(), d_in.contiguous(), cmask, static.emb_r_in,
                static.emb_p_in, static.emb_r_out, static.emb_p_out)
        L = model.num_convs

        def kernel():
            return cs.condensed_score(*args, num_blocks=L)

        def plain():
            return cs.condensed_score_reference(*args, num_blocks=L)

        wg_before = cs.condensed_score.wg_launches
        out, again, ref = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        tag = f"condensed_score N={n_bucket} {dname}"
        # bf16 takes the warp-specialised kernel, f32 the mma.sync kernel
        took_wg = cs.condensed_score.wg_launches - wg_before
        print(f"[kernels] {tag}: {took_wg} of 2 launches took the warp-specialised kernel; two "
              f"launches bitwise equal: {torch.equal(out, again)}; L2 weight bytes per launch "
              f"{cs.wg_dense_l2_weight_bytes(len(out), n_bucket, L):.4g} (warp-specialised, "
              f"{len(cs.dense_schedule(n_bucket, L))} stages of {cs.STAGE_BYTES} bytes per CTA) "
              f"against {cs.mma_sync_dense_l2_weight_bytes(len(out), n_bucket, L):.4g} (mma.sync)")
        if took_wg != (2 if dtype == torch.bfloat16 else 0):
            fail(f"{tag}: {took_wg} launches of the warp-specialised kernel")
        if not torch.equal(out, again):
            fail(f"{tag}: two launches on the same inputs differ")
        del again
        e_max = check_close(f"{tag} out", out, ref, dname)
        on_edges = edges_in.mask_global
        print(f"[kernels] {tag}: {int(on_edges.sum())} of {on_edges.numel()} pairs are edges; "
              f"max abs err on edges {(out - ref)[..., 0][on_edges].abs().max().item():.6g}")
        timing = time_and_bound(tag, kernel, plain,
                                cs.condensed_score_cost(w, static.z, L), dname)
        result[(n_bucket, dname)] = dict(timing, max_abs_err=e_max)
        del model, static, w, args, out, ref
        torch.cuda.empty_cache()
    return result


def stack_inputs(B: int, n_bucket: int, dname: str, seed: int, smooth: bool = False):
    """seed106's SchNet stack weights and the stack's inputs from the port's
    dense model on ``B`` synthetic reactions of the ``n_bucket`` bucket,
    prepared in ``dname`` as ``(w, h, ea, c)``, and a seeded normal
    cotangent ``g``.  ``smooth``: the cutoff mask is the smooth cosine one,
    ``0.5 (cos(pi d / cutoff) + 1)`` on the edges (``smooth_conv: true``)."""
    import torch

    from tsdiff_tpu_torch.ops import schnet_stack as ss

    dtype = getattr(torch, dname)
    model = load_member(106, dtype, torch.device("cuda"))
    model.encoder.smooth = smooth
    batch, pos = kernel_batch(n_bucket, seed=seed, count=B)
    with torch.no_grad():
        static = model.precompute_static(batch.atom_type, batch.r_feat, batch.p_feat,
                                         batch.bond_mat, batch.node_mask)
        edges_in, d_in, _, _ = model.build_pair_info(pos, batch.node_mask, static.pairs)
        d_emb = model.edge_enc.d_embedding(d_in.to(dtype)[..., None])
        edge_attr = model.edge_attr(d_emb, static.emb_r_in, static.emb_p_in)
        cmask = model.encoder.cutoff_mask(d_in, edges_in.mask_global)
    weights = {k: v.detach() for k, v in model.encoder.stack.weights().items()}
    w, h, ea, c = ss.prepare_inputs(weights, static.z, edge_attr, cmask, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(h.shape, generator=gen, device="cuda").to(dtype)
    return w, h, ea, c, g


def library_xty():
    """``(fn, what)``: x^T y by one ``torch.mm`` call with float32 output from
    bf16 inputs (``mm.dtype``) where this torch has it, else by bf16
    ``torch.mm``.  The port never calls it: it is the yardstick."""
    import torch

    x = torch.ones((64, 256), dtype=torch.bfloat16, device="cuda")
    try:
        torch.mm(x.t(), x, out_dtype=torch.float32)
        return (lambda a, b: torch.mm(a.t(), b, out_dtype=torch.float32),
                "torch.mm(x.t(), y, out_dtype=torch.float32)")
    except (TypeError, RuntimeError) as err:
        print(f"[kernels] torch.mm has no out_dtype here ({type(err).__name__}: "
              f"{str(err)[:120]}): the yardstick is bf16 torch.mm(x.t(), y)")
        return (lambda a, b: torch.mm(a.t(), b)), "torch.mm(x.t(), y) in bf16 (no out_dtype)"


def phase_xty(tag: str, operands: list, rgrads: dict, B: int, N: int, H: int, dtype) -> dict:
    """B3 backward's ``wgmma`` weight-gradient kernel alone on the plain
    backward's operands of every block (one backward call's 7 x 5 products):
    two calls bitwise equal, the gradients against the plain products and
    against ``torch.mm``, every call counted as the ``wgmma`` kernel's; its
    time per backward call beside its bound and beside the same 35 products
    through ``torch.mm``."""
    import torch

    from tsdiff_tpu_torch.ops import schnet_stack as ss

    mm, what = library_xty()
    L = len(operands)
    xty = ss.schnet_stack_xty
    before = (xty.launches, xty.wg_launches)
    e_max, same = 0.0, True
    for l, (xs, ys) in zip(reversed(range(L)), operands):
        out, again = ss.schnet_stack_xty(xs, ys), ss.schnet_stack_xty(xs, ys)
        torch.cuda.synchronize()
        same = same and torch.equal(out, again)
        for k, (name, _, _) in enumerate(ss.XTY_JOBS):
            e_max = max(e_max, check_close(f"schnet_bwd_xty_wg {tag} l={l} d{name}", out[k],
                                           rgrads[name][l], "bfloat16"))
            check_close(f"schnet_bwd_xty_wg {tag} l={l} d{name} against {what}", out[k],
                        mm(xs[k], ys[k]).float(), "bfloat16")
    took = (xty.launches - before[0], xty.wg_launches - before[1])
    print(f"[kernels] schnet_bwd_xty_wg {tag}: {took[1]} of {took[0]} calls took the wgmma kernel "
          f"(expected {2 * L} of {2 * L}); two calls bitwise equal: {same}")
    if took != (2 * L, 2 * L):
        fail(f"schnet_bwd_xty_wg {tag}: {took[1]} of {took[0]} calls took the wgmma kernel")
    if not same:
        fail(f"schnet_bwd_xty_wg {tag}: two calls on the same operands differ")
    kernel = lambda: [ss.schnet_stack_xty(xs, ys) for xs, ys in operands]  # noqa: E731
    library = lambda: [mm(x, y) for xs, ys in operands for x, y in zip(xs, ys)]  # noqa: E731
    timing = time_and_bound(
        f"schnet_bwd_xty_wg {tag} (one backward call: {L} calls of 5 products)", kernel,
        lambda: [ss.xty_reference(xs, ys) for xs, ys in operands],
        ss.schnet_stack_cost(B, N, H, L, dtype, "bwd_xty"), "bfloat16",
        library=library, library_what=f"{5 * L} calls of {what}")
    # CUDA events around host launches may time the host (35 torch.mm calls):
    # the device time of the same calls under torch.profiler is the figure kept
    kernel_dev, library_dev = profiled_ms(kernel), profiled_ms(library)
    print(f"[kernels] schnet_bwd_xty_wg {tag} under torch.profiler (device events, per backward "
          f"call): the kernel alone {fmt_ms(kernel_dev)} ms ({L} calls; CUDA events "
          f"{timing['ms']:.4f}), {what} {fmt_ms(library_dev)} ms ({5 * L} calls; CUDA events "
          f"{timing['library_ms']:.4f})" + ("" if None in (kernel_dev, library_dev) else
                                            f", the kernel {kernel_dev / library_dev:.3f}x of it"))
    timing.update(ms_events=timing["ms"], library_ms_events=timing["library_ms"])
    if kernel_dev is not None:
        timing.update(ms=kernel_dev, ms_by="profiler")
    if library_dev is not None:
        timing.update(library_ms=library_dev, library_ms_by="profiler")
    return dict(timing, max_abs_err=e_max)


def bwd_split(tag: str, call, B: int, N: int, H: int, L: int, dtype, n_calls: int = 3) -> dict:
    """B3 backward's time per call by kernel under torch.profiler (device
    events), its row kernel and its weight-gradient kernels beside their
    bounds, and the host-side arrangement (the weight image, ea's tile
    images) as the rest of the call's device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tsdiff_tpu_torch.ops import schnet_stack as ss

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            call()
        torch.cuda.synchronize()
    rows = device_kernels(prof, n_calls)
    part = {"rows": sum(ms for ms, _, name in rows if "schnet_bwd_rows" in name),
            "xty": sum(ms for ms, _, name in rows if "schnet_bwd_xty" in name
                       or "schnet_bwd_reduce" in name),
            "sum": sum(ms for ms, _, name in rows if "schnet_bwd_sum" in name),
            "other": sum(ms for ms, _, name in rows if "schnet_bwd_" not in name)}
    if part["rows"] == 0.0:
        print(f"[kernels] schnet_stack_bwd {tag}: the profiler shows no device time: split not "
              f"measured")
        return part
    out = []
    for kind, key in (("bwd_rows", "rows"), ("bwd_xty", "xty")):
        cost = ss.schnet_stack_cost(B, N, H, L, dtype, kind)
        t_ops, t_bytes = cost["flops"] / PEAK_FLOPS["bfloat16"] * 1e3, cost["bytes"] / PEAK_BYTES * 1e3
        out.append(f"{key} {part[key]:.4f} ms (bound {max(t_ops, t_bytes):.4f} by "
                   f"{'operations' if t_ops >= t_bytes else 'bytes'}: {cost['flops']:.4g} flop in "
                   f"{t_ops:.4f} ms, {cost['bytes']:.4g} bytes in {t_bytes:.4f} ms)")
    print(f"[kernels] schnet_stack_bwd {tag} per call under torch.profiler: " + "; ".join(out)
          + f"; bias sums {part['sum']:.4f} ms; other device time (zeroing, the weight image and "
          f"ea's tile images, casts) {part['other']:.4f} ms; kernels: " + ", ".join(
              f"{name[:40]} {ms:.4f} ms x{n:.0f}" for ms, n, name in rows[:6]))
    return part


def phase_stack_kernels() -> dict:
    """B3's forward and backward and B4 against their plain versions: bf16 at
    the training batch (B=200) in both of the training run's buckets, f32 at
    B=16.  N=16 has no padded node tile rows and its pair rows fill exactly
    four 64-row tiles, so it is a case of its own."""
    import torch

    from tsdiff_tpu_torch.ops import schnet_stack as ss

    result = {}
    for B, n_bucket, dname in ((200, 16, "bfloat16"), (200, 24, "bfloat16"),
                               (16, 24, "float32")):
        dtype = getattr(torch, dname)
        w, h, ea, c, g = stack_inputs(B, n_bucket, dname, seed=700 + B + n_bucket)
        _, N, H = h.shape
        L = w["f1w"].shape[0]
        tag = f"B={B} N={N} {dname}"
        ea4, c3 = ea.reshape(B, N, N, H), c.reshape(B, N, N)

        # the wgmma kernels' weight image and ea tile images, made once as a
        # train step makes them (None in f32: the mma.sync kernels take none)
        image, ea_img = ss.stack_wg_operands(w, h, ea, c)
        torch.cuda.synchronize()
        made = ""
        if image is not None:
            ops_ms = cuda_time_ms(lambda: ss.stack_wg_operands(w, h, ea, c), TIMING_ITERS)
            made = (f"; the weight image and ea's tile images (made once per train step) "
                    f"{ops_ms[0]:.4f} ms (median; minimum {ops_ms[1]:.4f})")
        fwd, b4 = ss.schnet_stack_fwd, ss.interaction_stack_pallas
        before = (fwd.launches, fwd.wg_launches, b4.launches, b4.wg_launches)
        out, hs = ss.schnet_stack_fwd(w, h, ea, c, image=image, ea_img=ea_img)
        out2, hs2 = ss.schnet_stack_fwd(w, h, ea, c, image=image, ea_img=ea_img)
        b4_out = ss.interaction_stack_pallas(w, h, ea4, c3, dtype, image=image, ea_img=ea_img)
        b4_again = ss.interaction_stack_pallas(w, h, ea4, c3, dtype, image=image, ea_img=ea_img)
        ref_out, ref_hs = ss.schnet_stack_fwd_reference(w, h, ea, c)
        torch.cuda.synchronize()
        # bf16 takes the wgmma kernel, f32 the mma.sync one
        wg_want = 2 if dtype == torch.bfloat16 else 0
        took = (fwd.launches - before[0], fwd.wg_launches - before[1], b4.launches - before[2],
                b4.wg_launches - before[3])
        same = (torch.equal(out, out2) and torch.equal(hs, hs2) and torch.equal(b4_out, b4_again)
                and torch.equal(b4_out, out))
        print(f"[kernels] schnet_stack_fwd and B4 {tag}: launches (B3, of them wgmma; B4, of them "
              f"wgmma) {took}, expected {(2, wg_want, 2, wg_want)}; two launches of each bitwise "
              f"equal, and B4 equal to B3's out: {same}{made}")
        if took != (2, wg_want, 2, wg_want):
            fail(f"schnet_stack_fwd / B4 {tag}: launches {took}")
        if not same:
            fail(f"schnet_stack_fwd / B4 {tag}: two launches on the same inputs differ")
        del out2, hs2, b4_again
        e_fwd = max(check_close(f"schnet_stack_fwd {tag} out", out, ref_out, dname),
                    check_close(f"schnet_stack_fwd {tag} hs", hs, ref_hs, dname))
        e_b4 = check_close(f"schnet_stack (B4) {tag} out", b4_out,
                           ss.interaction_stack_reference(w, h, ea, c), dname)
        wg_before = (ss.schnet_stack_bwd.wg_launches, ss.schnet_stack_bwd.xty_wg_launches)
        dh, dea, grads = ss.schnet_stack_bwd(w, ea, c, ref_hs, g)
        again = ss.schnet_stack_bwd(w, ea, c, ref_hs, g)
        # as a train step calls it: the forward's image and tile images
        given = ss.schnet_stack_bwd(w, ea, c, ref_hs, g, image=image, ea_img=ea_img)
        operands = []   # the weight-gradient products' operands, block by block
        rdh, rdea, rgrads = ss.schnet_stack_bwd_reference(w, ea, c, ref_hs, g, operands=operands)
        torch.cuda.synchronize()
        # bf16 takes the wgmma row and weight-gradient kernels, f32 the mma.sync ones
        took_wg = (ss.schnet_stack_bwd.wg_launches - wg_before[0],
                   ss.schnet_stack_bwd.xty_wg_launches - wg_before[1])
        same = all(torch.equal(dh, o[0]) and torch.equal(dea, o[1])
                   and all(torch.equal(grads[k], o[2][k]) for k in ss.W_KEYS)
                   for o in (again, given))
        print(f"[kernels] schnet_stack_bwd {tag}: of 3 calls, {took_wg[0]} took the wgmma row "
              f"kernel and {took_wg[1]} the wgmma weight-gradient kernel; two calls, and a third "
              f"fed the forward's weight image and ea tile images, bitwise equal in dh, dea and "
              f"the nine gradients: {same}")
        if took_wg != ((3, 3) if dtype == torch.bfloat16 else (0, 0)):
            fail(f"schnet_stack_bwd {tag}: (row, weight-gradient) calls through the wgmma "
                 f"kernels {took_wg}")
        if not same:
            fail(f"schnet_stack_bwd {tag}: two calls on the same inputs differ")
        del again, given
        e_bwd = max([check_close(f"schnet_stack_bwd {tag} dh", dh, rdh, dname),
                     check_close(f"schnet_stack_bwd {tag} dea", dea, rdea, dname)]
                    + [check_close(f"schnet_stack_bwd {tag} d{k}", grads[k], rgrads[k], dname)
                       for k in ss.W_KEYS])
        del out, hs, ref_out, dh, dea, grads, rdh, rdea, b4_out

        result[(N, dname)] = {
            "fwd": dict(time_and_bound(
                f"schnet_stack_fwd {tag}",
                lambda: ss.schnet_stack_fwd(w, h, ea, c, image=image, ea_img=ea_img),
                lambda: ss.schnet_stack_fwd_reference(w, h, ea, c),
                ss.schnet_stack_cost(B, N, H, L, dtype, "fwd"), dname), max_abs_err=e_fwd),
            "bwd": dict(time_and_bound(
                f"schnet_stack_bwd {tag}", lambda: ss.schnet_stack_bwd(w, ea, c, ref_hs, g),
                lambda: ss.schnet_stack_bwd_reference(w, ea, c, ref_hs, g),
                ss.schnet_stack_cost(B, N, H, L, dtype, "bwd"), dname), max_abs_err=e_bwd),
            "stack": dict(time_and_bound(
                f"schnet_stack (B4) {tag}",
                lambda: ss.interaction_stack_pallas(w, h, ea4, c3, dtype, image=image,
                                                    ea_img=ea_img),
                lambda: ss.interaction_stack_reference(w, h, ea, c),
                ss.schnet_stack_cost(B, N, H, L, dtype, "stack"), dname), max_abs_err=e_b4),
        }
        if dtype == torch.bfloat16:
            result[(N, dname)]["bwd_split"] = bwd_split(
                tag, lambda: ss.schnet_stack_bwd(w, ea, c, ref_hs, g), B, N, H, L, dtype)
            result[(N, dname)]["xty"] = phase_xty(tag, operands, rgrads, B, N, H, dtype)
        del w, h, ea, c, g, ref_hs, ea4, c3, image, ea_img, operands, rgrads
        torch.cuda.empty_cache()
    print("[kernels] tolerances (max, mean abs err / max|ref|): float32 (1e-4, 1e-4), only the "
          "float32 summation order differs; bfloat16 (3e-2, 3e-3), both round to bf16 at the "
          "same points but a reordered float32 sum can flip one rounding by a bf16 ulp (2^-8), "
          "and such flips propagate through the 7 blocks; the int8 kernel in bfloat16 (6e-2, "
          "6e-3), as a flipped rounding can flip an int8 code, 1/127 of its row's maximum or "
          "two bf16 ulps of it")
    smi_clocks("kernels")
    return result


def phase_stack_smooth() -> dict:
    """B3's forward and backward on the smooth cutoff's fractional mask (a
    condensed or dual encoder with ``smooth_conv: true`` feeds B3 such masks
    in training): bf16 at B=200, N=24 (the ``wgmma`` kernels) and f32 at
    B=16 (``mma.sync``), the outputs and every gradient against the plain
    stack (``interaction_stack_reference``, ``schnet_stack_fwd_reference``,
    ``schnet_stack_bwd_reference``) under ``TOL``.  Returns the largest
    error by dtype."""
    import torch

    from tsdiff_tpu_torch.ops import schnet_stack as ss

    result = {}
    for B, dname in ((200, "bfloat16"), (16, "float32")):
        dtype = getattr(torch, dname)
        w, h, ea, c, g = stack_inputs(B, 24, dname, seed=900 + B, smooth=True)
        _, N, _ = h.shape
        tag = f"smooth mask B={B} N={N} {dname}"
        edges = int((c > 0).sum())
        fractional = int(((c > 0) & (c < 1)).sum())
        print(f"[kernels] schnet_stack {tag}: cutoff mask 0.5 (cos(pi d / 10) + 1) on the "
              f"synthetic batch's encoder edges: {fractional} of {edges} edges "
              f"({fractional / max(edges, 1):.4f}) strictly between 0 and 1, of {c.numel()} "
              f"pair slots; values in [{float(c[c > 0].min()):.4g}, {float(c.max()):.4g}]")
        if fractional < edges // 2:
            fail(f"schnet_stack {tag}: the smooth mask is fractional on only {fractional} "
                 f"of {edges} edges")
        image, ea_img = ss.stack_wg_operands(w, h, ea, c)
        fwd, bwd = ss.schnet_stack_fwd, ss.schnet_stack_bwd
        before = (fwd.wg_launches, bwd.wg_launches, bwd.xty_wg_launches)
        ref_hs = ss.schnet_stack_fwd_reference(w, h, ea, c)[1]
        out, hs = fwd(w, h, ea, c, image=image, ea_img=ea_img)
        # the backward on the plain forward's states, as the plain backward
        dh, dea, grads = bwd(w, ea, c, ref_hs, g, image=image, ea_img=ea_img)
        torch.cuda.synchronize()
        took = (fwd.wg_launches - before[0], bwd.wg_launches - before[1],
                bwd.xty_wg_launches - before[2])
        want = (1, 1, 1) if dtype == torch.bfloat16 else (0, 0, 0)
        print(f"[kernels] schnet_stack {tag}: wgmma launches (forward, backward rows, weight "
              f"gradients) {took}, expected {want}")
        if took != want:
            fail(f"schnet_stack {tag}: the wgmma kernels took {took} of the calls")
        e_fwd = max(check_close(f"schnet_stack_fwd {tag} out", out,
                                ss.interaction_stack_reference(w, h, ea, c), dname),
                    check_close(f"schnet_stack_fwd {tag} hs", hs, ref_hs, dname))
        rdh, rdea, rgrads = ss.schnet_stack_bwd_reference(w, ea, c, ref_hs, g)
        e_bwd = max([check_close(f"schnet_stack_bwd {tag} dh", dh, rdh, dname),
                     check_close(f"schnet_stack_bwd {tag} dea", dea, rdea, dname)]
                    + [check_close(f"schnet_stack_bwd {tag} d{k}", grads[k], rgrads[k], dname)
                       for k in ss.W_KEYS])
        result[dname] = {"fwd": e_fwd, "bwd": e_bwd, "fractional_share": fractional / edges}
        del w, h, ea, c, g, image, ea_img, out, hs, dh, dea, grads, ref_hs, rdh, rdea, rgrads
        torch.cuda.empty_cache()
    return result


def device_kernels(prof, steps: int) -> list[tuple[float, float, str]]:
    """``(ms per step, launches per step, name)`` of every kernel in a
    torch.profiler run, largest first.  Only device events count: a CPU op's
    own device time repeats the time of the kernels it launched."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0.0)
        if ev.device_type == DeviceType.CUDA and dev > 0:
            rows.append((dev / 1e3 / steps, ev.count / steps, ev.key))
    return sorted(rows, reverse=True)


def profiled_ms(fn, n_calls: int = 5) -> float | None:
    """Device time of one call of ``fn`` under torch.profiler: the device
    events of ``n_calls`` calls (after one warm-up) summed, per call; None
    where the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
    total = sum(ms for ms, _, _ in device_kernels(prof, n_calls))
    return total if total > 0 else None


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def cli_graphs(save_dir: str) -> tuple[int, str]:
    """``(graphs recorded, their keys)`` from the sampling CLI's log in
    ``save_dir``: one CUDA graph per (bucket, tier, clip) walked."""
    with open(os.path.join(save_dir, "log.txt")) as f:
        found = re.findall(r"CUDA graphs recorded: (\d+), one per \(bucket, tier, clip\): (.*)",
                           f.read())
    if not found:
        fail(f"the sampling CLI in {save_dir} logged no CUDA graphs: it did not walk captured")
    return int(found[-1][0]), found[-1][1]


def walk_shapes(results: list, batch_size: int, test_set: list) -> set:
    """The (bucket, tier, clip) of every walk of a sampling CLI run, from
    its results in order, as the CLI pads a batch: the bucket of its largest
    reaction among the test set's buckets, the tier of its size, clip 1000
    and, for a second attempt, 20."""
    from tsdiff_tpu_torch.data.dataset import default_buckets, pick_bucket, tier_ladder

    buckets = default_buckets(max(len(g["atom_type"]) for g in test_set))
    tiers = tier_ladder(batch_size, 1, max_tiers=3)
    shapes = set()
    for i in range(0, len(results), batch_size):
        chunk = results[i:i + batch_size]
        tier = min((t for t in tiers if t >= len(chunk)), default=batch_size)
        bucket = max(pick_bucket(len(r["atom_type"]), buckets) for r in chunk)
        shapes |= {(bucket, tier, clip) for clip in (1000.0, 20.0)[:chunk[0]["sampling_attempts"]]}
    return shapes


def profiled_call(fn, device_only: bool = False):
    """``(fn(), prof)``: ``fn`` run under torch.profiler, the card
    synchronised before the trace ends; ``device_only`` traces the card's
    activity alone (what ``kernel_counts`` reads; much less to process)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] if device_only else [ProfilerActivity.CPU,
                                                              ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof


def kernel_counts(prof) -> dict:
    """Launches of every kernel in a torch.profiler run by name; a replay
    of a CUDA graph advances no wrapper's counter but shows here."""
    from torch.autograd import DeviceType

    counts: dict = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            counts[ev.key] = counts.get(ev.key, 0) + ev.count
    return counts


def score_launches(counts: dict) -> dict:
    """B1's (``False``) and B5's (``True``) launches in ``kernel_counts``."""
    return {want: sum(n for name, n in counts.items() if "packed_score" in name
                      and ("int8" in name) == want and "selftest" not in name)
            for want in (True, False)}


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
    from tsdiff_tpu_torch.ops import packed_score as ps

    node_eq_fn = make_packed_ensemble_eps_fn(members, batch)
    ps.packed_score.launches = ps.packed_score.wg_launches = 0
    dynamic_sampling(node_eq_fn, schedule, pos, batch.node_mask, settings, generator=gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        dynamic_sampling(node_eq_fn, schedule, pos, batch.node_mask, settings, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    rows = device_kernels(prof, n_steps)
    step_ms = wall_ms / n_steps
    print(f"[profile] {n_steps} ld steps, 8 members, B=100, N=24, bf16: wall {wall_ms:.3f} ms "
          f"({step_ms:.4f} ms/step); packed_score launches {ps.packed_score.launches}, of them "
          f"warp-specialised {ps.packed_score.wg_launches} (expected {2 * n_steps} each)")
    if (ps.packed_score.launches, ps.packed_score.wg_launches) != (2 * n_steps, 2 * n_steps):
        fail("the profiled steps did not all take the warp-specialised kernel")
    kernel_ms = sum(ms for ms, _, name in rows if "packed_score" in name)
    if kernel_ms == 0.0:
        print("[profile] the profiler shows no device time: breakdown not measured")
        return
    other = [(ms, n) for ms, n, name in rows if "packed_score" not in name]
    busy = kernel_ms + sum(ms for ms, _ in other)
    print(f"[profile] device time: packed_score kernel {kernel_ms:.4f} ms/step, other kernels "
          f"{sum(ms for ms, _ in other):.4f} ms/step ({sum(n for _, n in other):.1f} "
          f"launches/step); device busy {busy / step_ms:.4f} of wall, idle "
          f"{1 - busy / step_ms:.4f}")


def phase_main_path(quant: str = "none") -> dict:
    """The sampling CLI on 200 synthetic reactions with the 8 members, bf16,
    fused packed score, ``ld`` over the 5000-step schedule in 625 model
    calls; with ``quant="int8"`` the same run through the int8 kernel."""
    import numpy as np

    from tsdiff_tpu_torch.cli import evaluate, sampling
    from tsdiff_tpu_torch.data.dataset import save_dataset
    from tsdiff_tpu_torch.data.synthetic import make_corpus, sparse_edges
    from tsdiff_tpu_torch.diffusion.sampler import SamplingSettings, build_step_coeffs
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from tsdiff_tpu_torch.eval.dmae import calc_dmae, dmae_for_graph
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.ops import packed_score as ps
    from tsdiff_tpu_torch.ops import packed_score_int8 as p8
    from tsdiff_tpu_torch.train import load_checkpoint

    tag = "main" if quant == "none" else f"main {quant}"
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    os.makedirs(OUT_DIR)
    test_set = os.path.join(OUT_DIR, "test_data.pkl")
    # sparse edges, the on-disk form of real test sets: the C++ packer packs them
    save_dataset(test_set, sparse_edges(make_corpus(200, seed=2024)))
    ckpts = [os.path.join(CKPT_DIR, f"seed{s}_best.ckpt") for s in MEMBER_SEEDS]
    n_steps, respacing, batch_size = 5000, 625, 100
    argv = ckpts + [
        "--test_set", test_set, "--dtype", "bfloat16",
        "--fused_score", "--sort_by_size", "--sampling_type", "ld",
        "--n_steps", str(n_steps), "--batch_size", str(batch_size), "--device", "cuda",
        "--quant", quant,
    ]
    # the run itself under torch.profiler: replays advance no wrapper's
    # counter, so the score kernels are counted there by name
    ps.packed_score.launches = ps.packed_score.wg_launches = 0
    p8.packed_score_int8.launches = p8.packed_score_int8.wg_launches = 0
    ps.packed_score_reference.calls = p8.packed_score_int8_reference.calls = 0
    save_path, prof = profiled_call(lambda: sampling.main(
        argv + ["--save_dir", OUT_DIR, "--timestep_respacing", str(respacing)]))
    on_path, other = ((ps.packed_score, p8.packed_score_int8) if quant == "none"
                      else (p8.packed_score_int8, ps.packed_score))
    launches, other_launches = on_path.launches, other.launches
    plain_calls = ps.packed_score_reference.calls + p8.packed_score_int8_reference.calls
    by_name = score_launches(kernel_counts(prof))
    del prof

    with open(save_path, "rb") as f:
        results = pickle.load(f)
    cfg = Config(load_checkpoint(ckpts[0])["config"]).model
    steps = len(build_step_coeffs(
        DiffusionSchedule.from_config(cfg),
        SamplingSettings(n_steps=n_steps, timestep_respacing=respacing),
    ).a)
    attempts = [results[i]["sampling_attempts"] for i in range(0, len(results), batch_size)]
    graphs, keys = cli_graphs(OUT_DIR)
    shapes = walk_shapes(results, batch_size, make_corpus(200, seed=2024))
    # the wrappers count each graph's eager first step and its recording
    expected = 2 * graphs
    # on the card: every walk step, and each graph's eager first step once more
    walk_steps = steps * sum(attempts)
    expected_run = walk_steps + graphs
    int8 = quant == "int8"
    print(f"[{tag}] {len(results)} samples in {len(attempts)} batches, attempts {attempts}, "
          f"{steps} model calls per run, {walk_steps} walk steps replayed from "
          f"{graphs} CUDA graphs ({keys}; expected one per (bucket, tier, clip) walked: "
          f"{len(shapes)}); counted by kernel name in this run under torch.profiler: "
          f"{'B5' if int8 else 'B1'} {by_name[int8]} (expected {expected_run}: every walk "
          f"step and each graph's eager first step), {'B1' if int8 else 'B5'} "
          f"{by_name[not int8]} (expected 0); wrapper counters: {on_path.__name__} "
          f"{launches}, of the warp-specialised kernel {on_path.wg_launches} (expected "
          f"{expected} each: each graph's eager first step and its recording), "
          f"{other.__name__} {other_launches} (expected 0), plain-version calls {plain_calls}")
    if graphs != len(shapes):
        fail(f"{graphs} CUDA graphs recorded for {len(shapes)} walk shapes")
    if (by_name[int8], by_name[not int8]) != (expected_run, 0):
        fail(f"{tag}: the captured walk did not launch the score kernel once per step")
    if (launches, on_path.wg_launches) != (expected, expected):
        fail(f"{on_path.__name__} launched {launches} times ({on_path.wg_launches} "
             f"warp-specialised) outside replays, expected {expected}")
    if other_launches != 0:
        fail(f"{other.__name__} launched {other_launches} times on the {tag} path")
    if plain_calls != 0:
        fail(f"the plain version ran {plain_calls} times on the main path")
    if len(results) != 200:
        fail(f"{len(results)} samples, expected 200")
    for r in results:
        if r["pos_gen"].shape != (len(r["atom_type"]), 3) or not np.isfinite(r["pos_gen"]).all():
            fail("non-finite or misshaped pos_gen")
    # the same command unprofiled, for its time: the same samples bit for bit
    timed_dir = os.path.join(OUT_DIR, "timed")
    t0 = time.monotonic()
    timed_path = sampling.main(argv + ["--save_dir", timed_dir,
                                       "--timestep_respacing", str(respacing)])
    wall = time.monotonic() - t0
    with open(timed_path, "rb") as f:
        timed = pickle.load(f)
    same = len(timed) == len(results) and all(
        np.array_equal(a["pos_gen"], b["pos_gen"]) for a, b in zip(timed, results))
    dmae = np.array([calc_dmae(r["pos"], r["pos_gen"]) for r in results])
    matched = np.array([dmae_for_graph(r, r["pos_gen"]) for r in results])
    print(f"[{tag}] unprofiled run of the same command: samples equal to the profiled run's "
          f"bit for bit: {same}; wall {wall:.3f} s, {wall / walk_steps * 1e3:.4f} ms per "
          f"sampling step (8 members, batch <= {batch_size}), {len(results) / wall:.4f} "
          f"samples/s; D-MAE mean {dmae.mean():.4f} median {np.median(dmae):.4f} (identity "
          f"matching, bound {DMAE_BOUND}); automorphism-matched D-MAE mean {matched.mean():.4f} "
          f"median {np.median(matched):.4f}")
    if not same:
        fail(f"{tag}: the unprofiled run's samples differ from the profiled run's")
    sizes = np.array([len(r["atom_type"]) for r in results])
    print(f"[{tag}] D-MAE mean by size: " + ", ".join(
        f"{name} {dmae[sel].mean():.4f} ({int(sel.sum())} reactions)"
        for name, sel in (("up to 16 atoms", sizes <= 16), ("17-24 atoms", sizes > 16))
        if sel.any()))
    if not dmae.mean() < DMAE_BOUND:
        fail(f"mean D-MAE {dmae.mean():.4f} >= {DMAE_BOUND}")
    # the evaluate CLI, as the production pipeline runs it right after sampling
    stats_path = os.path.join(OUT_DIR, "dmae_stats.pkl")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        evaluate.main(["--samples", save_path, "--out", stats_path])
    with open(stats_path, "rb") as f:
        written = pickle.load(f)
    gap = abs(float(np.mean(written["dmae"])) - float(matched.mean()))
    print(f"[{tag}] evaluate CLI: " + " / ".join(printed.getvalue().strip().splitlines())
          + f"; its mean D-MAE {np.mean(written['dmae']):.10f} against this phase's matched "
          f"{matched.mean():.10f}: |difference| {gap:.3g} (limit 1e-9)")
    if len(written["dmae"]) != len(results):
        fail(f"the evaluate CLI scored {len(written['dmae'])} of {len(results)} samples")
    if not gap <= 1e-9:
        fail(f"the evaluate CLI's mean D-MAE differs from the phase's by {gap:.3g}")
    return dict(launches=by_name[int8], wall=wall, dmae_mean=float(dmae.mean()), argv=argv,
                samples=results, respacing=respacing, steps=steps)


def phase_dense_path() -> dict:
    """The dense single-model sampling path: seed106 with ``fused_score``
    through ``make_score_fn`` and ``dynamic_sampling`` on 100 synthetic
    reactions of the N=24 bucket, bf16, ``ld`` over the 5000-step schedule in
    625 model calls, each one launch of the dense score kernel."""
    import numpy as np
    import torch

    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.diffusion.ensemble import make_packed_ensemble_eps_fn, make_score_fn
    from tsdiff_tpu_torch.diffusion.sampler import (
        SamplingSettings,
        dynamic_sampling,
        final_frame_scale,
    )
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from tsdiff_tpu_torch.eval.dmae import calc_dmae, get_min_dmae_match, graph_automorphisms
    from tsdiff_tpu_torch.ops import condensed_score as cs
    from tsdiff_tpu_torch.train import load_checkpoint

    batch, _ = kernel_batch(24, seed=555)
    dev = torch.device("cuda")
    model = load_member(106, torch.bfloat16, dev, fused_score=True)
    cfg = Config(load_checkpoint(os.path.join(CKPT_DIR, "seed106_best.ckpt"))["config"]).model
    schedule = DiffusionSchedule.from_config(cfg)
    settings = SamplingSettings(sampling_type="ld", n_steps=5000, timestep_respacing=625)
    ref, mask = batch.pos.cpu().numpy(), batch.node_mask.cpu().numpy()
    atoms = [np.nonzero(m)[0] for m in mask]
    bond, types = batch.bond_mat.cpu().numpy(), batch.atom_type.cpu().numpy()
    autos = [graph_automorphisms(bond[b][np.ix_(a, a)], types[b][a]) for b, a in enumerate(atoms)]

    def sample(make_fn):
        """(D-MAE per reaction, automorphism-matched D-MAE per reaction, wall
        s) of one run from the same start and noise."""
        gen = torch.Generator(device="cuda").manual_seed(2022)
        pos_init = torch.randn(batch.pos.shape, generator=gen, device="cuda")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = dynamic_sampling(make_fn(), schedule, pos_init, batch.node_mask, settings,
                               generator=gen)
        nan = bool(res.nan_detected.item())
        wall = time.monotonic() - t0
        pos = (res.pos * final_frame_scale(schedule, settings)).cpu().numpy()
        if nan or pos.shape != tuple(batch.pos.shape) or not np.isfinite(pos).all():
            fail("non-finite or misshaped positions on the dense path")
        ident = np.array([calc_dmae(ref[b][a], pos[b][a]) for b, a in enumerate(atoms)])
        matched = np.array([get_min_dmae_match(ref[b][a], pos[b][a], autos[b])[0]
                            for b, a in enumerate(atoms)])
        return ident, matched, wall

    cs.condensed_score.launches = cs.condensed_score.wg_launches = 0
    cs.condensed_score_reference.calls = 0
    dmae, dmae_m, wall = sample(lambda: make_score_fn(model, batch))
    launches, plain_calls = cs.condensed_score.launches, cs.condensed_score_reference.calls
    wg = cs.condensed_score.wg_launches
    print(f"[dense] 100 samples, 1 model, B=100, N=24, bf16: condensed_score launches "
          f"{launches} (expected 625), of them warp-specialised {wg} (expected 625), "
          f"plain-version calls {plain_calls}")
    if launches != 625 or wg != 625:
        fail(f"the dense score kernel launched {launches} times, {wg} of them warp-specialised, "
             f"expected 625 and 625")
    if plain_calls != 0:
        fail(f"the plain version ran {plain_calls} times on the dense path")
    print(f"[dense] wall {wall:.3f} s, {wall / launches * 1e3:.4f} ms per sampling step, "
          f"{len(dmae) / wall:.4f} samples/s; D-MAE mean {dmae.mean():.4f} median "
          f"{np.median(dmae):.4f} (identity matching, bound {DMAE_BOUND_N24}); "
          f"automorphism-matched D-MAE mean {dmae_m.mean():.4f} median {np.median(dmae_m):.4f}")
    if not dmae.mean() < DMAE_BOUND_N24:
        fail(f"mean D-MAE {dmae.mean():.4f} >= {DMAE_BOUND_N24} on the dense path")

    # the same reactions, start and noise through the model's unfused torch
    # path, and through the 8-member packed ensemble as this bucket's yardstick
    unfused = load_member(106, torch.bfloat16, dev)
    dmae_u, dmae_um, wall_u = sample(lambda: make_score_fn(unfused, batch))
    members = load_members(torch.bfloat16, dev)
    dmae_e, dmae_em, wall_e = sample(lambda: make_packed_ensemble_eps_fn(members, batch))
    delta = abs(dmae.mean() - dmae_u.mean())
    print(f"[dense] same reactions and noise: unfused torch path D-MAE mean {dmae_u.mean():.4f} "
          f"median {np.median(dmae_u):.4f} in {wall_u:.3f} s (|difference| of the means "
          f"{delta:.4f}, limit {DMAE_FUSED_DELTA}; correlation per reaction "
          f"{np.corrcoef(dmae, dmae_u)[0, 1]:.4f}); 8-member packed ensemble D-MAE mean "
          f"{dmae_e.mean():.4f} median {np.median(dmae_e):.4f} in {wall_e:.3f} s; "
          f"automorphism-matched means: unfused {dmae_um.mean():.4f}, ensemble "
          f"{dmae_em.mean():.4f}")
    if not delta <= DMAE_FUSED_DELTA:
        fail(f"the fused dense run's mean D-MAE differs from the unfused run's by {delta:.4f}")
    return dict(launches=launches, wall=wall, dmae_mean=float(dmae.mean()))


def train_setup() -> tuple[dict, dict, dict, list]:
    """The training phases' corpus (1000 + 200 synthetic reactions) and the
    production model and ``train`` block (configs/train_config.yml, as the
    trained checkpoints embed it: ``packed_train``, no ``use_pallas``) with
    EMA and a 40-iteration run: ``(model_cfg, train_cfg, paths, buckets)``."""
    from tsdiff_tpu_torch.data import save_dataset
    from tsdiff_tpu_torch.data.synthetic import make_corpus, sparse_edges
    from tsdiff_tpu_torch.train import load_checkpoint

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    os.makedirs(TRAIN_DIR)
    # sparse edges, the on-disk form of real datasets: the streamed loader
    # packs them with the C++ packer
    corpus = sparse_edges(make_corpus(1200, seed=31))
    paths = {"train": os.path.join(TRAIN_DIR, "train_data.pkl"),
             "val": os.path.join(TRAIN_DIR, "valid_data.pkl")}
    save_dataset(paths["train"], corpus[:1000])
    save_dataset(paths["val"], corpus[1000:])
    ck = load_checkpoint(os.path.join(CKPT_DIR, "seed106_best.ckpt"))
    train_cfg = {**ck["config"]["train"], "seed": 0, "batch_size": 200, "val_freq": 20,
                 "log_freq": 10, "max_iters": 40, "ema_decay": 0.999}
    return dict(ck["config"]["model"]), train_cfg, paths, [16, 24]


def write_train_config(name: str, model_cfg: dict, train_cfg: dict, paths: dict,
                       buckets: list) -> str:
    cfg = {"model": model_cfg, "train": train_cfg, "dataset": paths,
           "tpu": {"bucket_sizes": buckets}}
    path = os.path.join(TRAIN_DIR, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def run_train_cli(tag: str, cfg_path: str, train_cfg: dict, flags: list, logdir: str,
                  capture: bool = True, profiled: bool = False) -> dict:
    """The train CLI on ``cfg_path`` with ``flags``, its run directory made
    under ``TRAIN_DIR/logdir``, its steps replayed from CUDA graphs (or, with
    ``capture=False``, eager), with ``profiled`` under torch.profiler; checks
    finite losses, a written checkpoint, the closing throughput line and,
    captured, the graphs line, and returns the run's directory, wall, log,
    losses, graphs/s, best checkpoint, graphs (recorded keys, replays by
    key) and, profiled, its kernel launches by name."""
    import numpy as np
    import torch

    from tsdiff_tpu_torch.cli import train as train_cli
    from tsdiff_tpu_torch.train import get_checkpoint_path

    iters = train_cfg["max_iters"]
    validations = sum(1 for it in range(1, iters + 1) if it % train_cfg["val_freq"] == 0
                      or it == iters)
    argv = [cfg_path, "--logdir", os.path.join(TRAIN_DIR, logdir), *flags, "--device", "cuda"]
    counts = None
    t0 = time.monotonic()
    if profiled:
        log_dir, prof = profiled_call(lambda: train_cli.main(argv, capture=capture))
        counts = kernel_counts(prof)
        del prof
    else:
        log_dir = train_cli.main(argv, capture=capture)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    with open(os.path.join(log_dir, "log.txt")) as f:
        log = f.read()
    losses = [(kind, int(it), float(v))
              for kind, it, v in re.findall(r"\[(Train|Validate)\] Iter (\d+) \| Loss (\S+)", log)]
    print(f"[{tag}] {' '.join(flags)}: {iters} iterations in {wall:.3f} s"
          f"{' under torch.profiler' if profiled else ''}; logged losses: {losses}")
    if len(losses) != iters // train_cfg["log_freq"] + validations:
        fail(f"{tag}: expected {iters // train_cfg['log_freq']} train and {validations} "
             f"validation log lines, got {len(losses)}")
    if not all(np.isfinite(v) for _, _, v in losses):
        fail(f"{tag}: non-finite training or validation loss")
    tput = re.search(r"\[Train\] Throughput \| Iters (\d+)-(\d+) \| (\d+) graphs in (\S+) s "
                     r"\| (\S+) graphs/s", log)
    if tput is None:
        fail(f"{tag}: the train CLI logged no throughput line")
    gps = float(tput.group(5))
    print(f"[{tag}] CLI run, iterations {int(tput.group(1))}-{int(tput.group(2))} (all but the "
          f"first, the input pipeline, both buckets, validations and checkpoints included): "
          f"{int(tput.group(3))} graphs in {float(tput.group(4)):.3f} s, {gps:.4f} graphs/s")
    ckpt_path, ckpt_it = get_checkpoint_path(os.path.join(log_dir, "checkpoints"))
    print(f"[{tag}] best checkpoint {os.path.relpath(ckpt_path, ROOT)} (iteration {ckpt_it}); "
          f"run directory {os.path.basename(log_dir)}")
    found = re.search(r"\[Train\] CUDA graphs \| recorded \d+: (.*) \| replays (.*)", log)
    if capture != (found is not None):
        fail(f"{tag}: capture={capture} but the log says "
             f"{found.group(0) if found else 'no CUDA graph was recorded'}")
    graphs = None
    if found:
        recorded = [(k, int(b)) for k, b in (item.split() for item in found.group(1).split(", "))]
        replays = {(k, int(b)): int(n) for k, b, n in
                   (item.split() for item in found.group(2).split(", "))}
        graphs = dict(recorded=recorded, replays=replays)
        print(f"[{tag}] CUDA graphs recorded {recorded}, replays {replays}")
    return dict(log_dir=log_dir, wall=wall, log=log, losses=losses, graphs_per_s=gps,
                ckpt=ckpt_path, graphs=graphs, kernels=counts)


#: the one op of a train step whose result varies between calls on identical
#: inputs on the card: F.embedding's backward into the bond-type table
#: (``models/edge.py::bond_embedding``, ``ops/packed_score_xla.py``; bf16,
#: ~1e5 indices into 100 rows), whose kernel
#: ``compute_grad_weight_atomic_accumulate`` sums the repeats of a row with
#: float atomics, so its result can differ by a bf16 ulp between calls.
NONDETERMINISTIC = ("F.embedding's backward into edge_enc.bond_emb.weight "
                    "(compute_grad_weight_atomic_accumulate, float atomics)")
#: what that op's gradient feeds in one step, and nothing else does
BOND_CHAIN = {f"{part} edge_enc.bond_emb.weight" for part in ("param", "mu", "nu", "ema")}
#: the train CLI's logged losses, captured against eager: the largest
#: relative difference allowed, between two eager runs' own and a control
#: run's (the learning rate 1% higher), both read on an H100 at 700 W: 0
#: between eager runs of 6a and of 6b, 3.4e-3 (6a) and 4.8e-3 (6b) for the
#: control.  It passes one unit in the last logged digit of a training
#: loss (0.01 of ~190, 5.3e-5), which the bond table's atomics could move
CLI_LOSS_RTOL = 1e-4
CONTROL_LR = 1.01


def state_tensors(state) -> dict:
    """A train state's tensors by name (live, not copies): parameters,
    moments, EMA, counters."""
    out = {f"param {k}": v.detach() for k, v in state.params.items()}
    for part in ("mu", "nu"):
        out.update({f"{part} {k}": v for k, v in state.opt_state[part].items()})
    if state.ema_params is not None:
        out.update({f"ema {k}": v for k, v in state.ema_params.items()})
    out["step"], out["count"] = state.step, state.opt_state["count"]
    return out


def differing(a: dict, b: dict) -> list[str]:
    import torch

    return [k for k in a if not torch.equal(a[k], b[k])]


def max_diff(a: dict, b: dict, keys) -> float:
    return max((float((a[k].double() - b[k].double()).abs().max()) for k in keys), default=0.0)


def lockstep_verdict(tag: str, steps: list) -> None:
    """The determinism condition, step by step.  Each step of the captured
    run and of a second eager run started from the eager run's state, copied
    into theirs in place; ``steps[i][name]`` is ``(differing tensors,
    differing metrics, max |diff| in BOND_CHAIN)`` against the eager step.
    On every step the captured step must equal the eager one bit for bit in
    every tensor outside ``BOND_CHAIN``, which only ``NONDETERMINISTIC``
    feeds, and in every metric: the gradient norm among them sums the bond
    table's gradient too, so a difference there is below what moves a
    float32 norm.  The second eager run shows how often two eager steps
    differ in the chain (informational: it varies between runs)."""
    rows = {name: [(i, r[name]) for i, r in enumerate(steps) if r[name][0] or r[name][1]]
            for name in ("captured", "eager again")}
    print(f"[{tag}] lockstep, every step from the eager run's state: {len(steps)} steps; the "
          f"captured step differs from the eager one on steps "
          f"{[(i, t, m, d) for i, (t, m, d) in rows['captured']]}, the second eager step on "
          f"steps {[(i, t, m, d) for i, (t, m, d) in rows['eager again']]} (differing tensors, "
          f"differing metrics, max |diff| in {sorted(BOND_CHAIN)})")
    for i, (tensors, metrics, _) in rows["captured"]:
        outside = sorted(set(tensors) - BOND_CHAIN)
        if metrics or outside:
            fail(f"{tag}: step {i}: the captured step differs from the eager one from the same "
                 f"state outside what {NONDETERMINISTIC} feeds: tensors {outside[:8]} "
                 f"({len(outside)}), metrics {metrics}")
    print(f"[{tag}] captured equals eager bit for bit in every metric and every tensor outside "
          f"the bond chain on all {len(steps)} steps; inside it on "
          f"{len(steps) - len(rows['captured'])} (a second eager step: "
          f"{len(steps) - len(rows['eager again'])}); the chain is fed only by "
          f"{NONDETERMINISTIC}")


def compare_cli_losses(tag: str, cfg_path: str, setup: tuple, flags: list,
                       captured: dict) -> dict:
    """The train CLI eager on the flags of ``captured``, twice, and once
    more with the learning rate ``CONTROL_LR`` times the config's: every
    logged training and validation loss of the captured run against the
    first eager run's within ``CLI_LOSS_RTOL`` relative, which must hold the
    second eager run too and not the control.  Returns the first eager run."""
    model_cfg, train_cfg, paths, buckets = setup
    eager = run_train_cli(f"{tag} eager", cfg_path, train_cfg, flags, "logs_eager_0",
                          capture=False)
    again = run_train_cli(f"{tag} eager", cfg_path, train_cfg, flags, "logs_eager_1",
                          capture=False)
    opt = train_cfg["optimizer"]
    control_cfg = {**train_cfg, "optimizer": {**opt, "lr": opt["lr"] * CONTROL_LR}}
    control_path = write_train_config(os.path.basename(cfg_path)[:-5] + "_control", model_cfg,
                                      control_cfg, paths, buckets)
    control = run_train_cli(f"{tag} control", control_path, control_cfg, flags,
                            "logs_eager_control", capture=False)

    def rel(a, b):
        if [x[:2] for x in a["losses"]] != [x[:2] for x in b["losses"]]:
            fail(f"{tag}: two runs on the same flags logged different lines")
        return max(abs(x[2] - y[2]) / max(abs(y[2]), 1e-12)
                   for x, y in zip(a["losses"], b["losses"]))

    d, d_again, d_control = rel(captured, eager), rel(again, eager), rel(control, eager)
    print(f"[{tag}] the CLI's {len(eager['losses'])} logged losses against the eager run's, "
          f"largest relative difference: captured {d:.6g}, a second eager run {d_again:.6g}, "
          f"the control (learning rate x {CONTROL_LR}) {d_control:.6g}; limit {CLI_LOSS_RTOL}")
    if not d_again <= CLI_LOSS_RTOL < d_control:
        fail(f"{tag}: the limit {CLI_LOSS_RTOL} does not lie between two eager runs' difference "
             f"{d_again:.6g} and the control's {d_control:.6g}")
    if not d <= CLI_LOSS_RTOL:
        fail(f"{tag}: the captured CLI run's losses differ from the eager run's by {d:.6g}")
    return eager


def fixed_batch_steps(tag: str, model_cfg: dict, train_cfg: dict, paths: dict, buckets: list,
                      n_prof: int = 3) -> dict:
    """20 train steps on one fixed N=24 batch of 200 with fixed t and noise
    (the loss must fall), from one seeded initialisation three times, in
    lockstep: eager, eager again and replayed from a CUDA graph
    (``train/captured.py``; its first step eager, then recorded), the
    second eager and the captured step started from the eager run's state
    on every step, and each step's state and metrics compared
    (``lockstep_verdict``).  For the eager
    and the captured run: the time per step on the host clock, then
    ``n_prof`` steps under torch.profiler (ms per step, device ms, idle
    share, launches per step and the kernel rows by name); the stack
    kernels' launches per step by kernel name equal in both."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.data import PaddedBatchLoader, TSDataset
    from tsdiff_tpu_torch.diffusion.objective import sample_antithetic_timesteps
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from tsdiff_tpu_torch.models import get_model
    from tsdiff_tpu_torch.train import init_train_state, make_optimizer, make_train_step
    from tsdiff_tpu_torch.train.captured import StepGraphs
    from tsdiff_tpu_torch.train.trainer import on_device

    B = train_cfg["batch_size"]
    mcfg = Config(model_cfg)
    schedule = DiffusionSchedule.from_config(mcfg)
    loader = PaddedBatchLoader(TSDataset(paths["train"]), B, bucket_sizes=buckets, device="cuda")
    batch = next(b for b in loader if b.atom_type.shape[1] == 24)
    gen = torch.Generator(device="cuda").manual_seed(5)
    t = sample_antithetic_timesteps(gen, B, 0, len(schedule.alphas), "cuda")
    noise = torch.randn(batch.pos.shape, generator=gen, device="cuda")
    lr = train_cfg["optimizer"]["lr"]

    runs = {}
    for name in ("eager", "eager again", "captured"):
        model = get_model(mcfg, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0)).to("cuda")
        tx = make_optimizer(Config(train_cfg["optimizer"]), train_cfg["max_grad_norm"])
        state = init_train_state(model, tx, ema_decay=train_cfg["ema_decay"])
        step = make_train_step(model, tx, schedule, ema_decay=train_cfg["ema_decay"])
        fn = (lambda step, state: lambda b, t, noise: step(state, b, lr, t=t, noise=noise)[1])(
            step, state)
        graphs = StepGraphs("cuda") if name == "captured" else None
        one = (lambda fn, graphs: (lambda: graphs(("train", 24), fn, batch, t, noise)) if graphs
               else (lambda: fn(batch, t, noise)))(fn, graphs)
        runs[name] = dict(model=model, state=state, one=one, losses=[], step_s=[])
    # every step of the second eager and the captured run starts from the
    # eager run's state, copied into theirs in place (the graph holds its
    # addresses), so that every replay is held to the eager step
    for r in runs.values():
        on_device(r["state"])
    steps, norms = [], []
    for i in range(20):
        ref = {k: v.clone() for k, v in state_tensors(runs["eager"]["state"]).items()}
        with torch.no_grad():
            for name in ("eager again", "captured"):
                for k, v in state_tensors(runs[name]["state"]).items():
                    v.copy_(ref[k])
        metrics = {}
        for name, r in runs.items():
            torch.cuda.synchronize()
            t0 = time.monotonic()
            metrics[name] = r["one"]()
            r["losses"].append(float(metrics[name]["loss"]))
            r["step_s"].append(time.monotonic() - t0)
        ref = state_tensors(runs["eager"]["state"])
        norms.append(float(metrics["eager"]["grad_norm"]))
        row = {}
        for name in ("captured", "eager again"):
            got = state_tensors(runs[name]["state"])
            row[name] = (differing(got, ref), differing(metrics[name], metrics["eager"]),
                         max_diff(got, ref, BOND_CHAIN))
        steps.append(row)
    print(f"[{tag}] gradient norms of the 20 eager steps (the clip at "
          f"{train_cfg['max_grad_norm']}): {[round(n, 2) for n in norms]}")
    def profiled(r) -> dict:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(n_prof):
                r["one"]()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
        rows = device_kernels(prof, n_prof)
        busy = sum(row[0] for row in rows)
        step_ms = wall_ms / n_prof
        return dict(ms=float(np.mean(r["step_s"][1:])) * 1e3, rows=rows, step_ms=step_ms,
                    device_ms=busy or None, idle=1 - busy / step_ms if busy else None,
                    launches=sum(row[1] for row in rows))

    eager, captured = profiled(runs["eager"]), profiled(runs["captured"])
    what = "packed_train" if runs["eager"]["model"].packed_train else "use_pallas"
    for name, r in (("eager", eager), ("captured", captured)):
        losses = runs[name]["losses"]
        first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        print(f"[{tag}] fixed batch (B={B}, N=24, bf16, {what}), 20 {name} steps: losses "
              f"{[round(v, 4) for v in losses]}; mean of the first 5 {first5:.4f}, of the "
              f"last 5 {last5:.4f}")
        if not np.all(np.isfinite(losses)) or not last5 < first5:
            fail(f"{tag}: the loss did not fall on the fixed batch ({name})")
        print(f"[{tag}] per-step figure on the fixed N=24 batch, {name}: {r['ms']:.4f} ms per "
              f"train step (steps 2-20, host clock around a synchronised step), "
              f"{B / r['ms'] * 1e3:.4f} graphs/s; profile of {n_prof} steps: wall "
              f"{r['step_ms']:.4f} ms/step; device time "
              + (f"{r['device_ms']:.4f} ms/step in {r['launches']:.1f} kernel launches/step, "
                 f"device busy {r['device_ms'] / r['step_ms']:.4f} of wall, idle "
                 f"{r['idle']:.4f}" if r["device_ms"] else
                 "not measured (the profiler shows no device time)"))
    print(f"[{tag}] kernels per captured step by name (launches per step, ms per step): "
          + "; ".join(f"{name[:60]} {n:.0f} {ms:.4f}" for ms, n, name in captured["rows"][:12]))
    stack = {kind: {re.search(r"schnet_\w+", name).group(0): n for _, n, name in r["rows"]
                    if "schnet_" in name}
             for kind, r in (("eager", eager), ("captured", captured))}
    print(f"[{tag}] stack kernels per step by name, eager {stack['eager']}, captured "
          f"{stack['captured']}")
    if stack["eager"] != stack["captured"]:
        fail(f"{tag}: the captured step runs other stack kernels than the eager step")
    lockstep_verdict(tag, steps)
    keys = ("ms", "step_ms", "device_ms", "idle", "launches")
    return dict(ms_per_step=eager["ms"], device_ms=eager["device_ms"], idle=eager["idle"],
                launches_per_step=eager["launches"], rows=eager["rows"],
                captured={k: captured[k] for k in keys + ("rows",)},
                eager={k: eager[k] for k in keys})


def sample_with(tag: str, ckpt_path: str) -> None:
    """8 reactions, 20 respaced ld steps, from a checkpoint this run trained,
    through the packed score kernel (B1): every model call one launch of its
    warp-specialised kernel, all positions finite."""
    import numpy as np

    from tsdiff_tpu_torch.cli import sampling
    from tsdiff_tpu_torch.data import save_dataset
    from tsdiff_tpu_torch.data.synthetic import make_corpus
    from tsdiff_tpu_torch.ops import packed_score as ps

    test_set = os.path.join(TRAIN_DIR, "sample_set.pkl")
    save_dataset(test_set, make_corpus(8, seed=77))
    ps.packed_score.launches = ps.packed_score.wg_launches = 0
    save_dir = os.path.join(TRAIN_DIR, f"samples_{tag}")
    save_path = sampling.main([
        ckpt_path, "--test_set", test_set, "--save_dir", save_dir,
        "--fused_score", "--dtype", "bfloat16", "--sampling_type", "ld", "--n_steps", "5000",
        "--timestep_respacing", "20", "--batch_size", "8", "--device", "cuda",
    ])
    with open(save_path, "rb") as f:
        samples = pickle.load(f)
    launches = (ps.packed_score.launches, ps.packed_score.wg_launches)
    graphs, keys = cli_graphs(save_dir)
    if len(samples) != 8 or not all(np.isfinite(r["pos_gen"]).all() for r in samples):
        fail(f"{tag}: sampling from the trained checkpoint gave missing or non-finite positions")
    if graphs == 0 or launches != (2 * graphs, 2 * graphs):
        fail(f"{tag}: sampling launched the packed score kernel {launches[0]} times, "
             f"{launches[1]} of them warp-specialised, for {graphs} CUDA graphs")
    print(f"[{tag}] sampled {len(samples)} reactions for 20 respaced ld steps with the trained "
          f"checkpoint, replayed from {graphs} CUDA graph ({keys}): all positions finite; "
          f"packed_score launches {launches[0]} (each graph's eager first step and its "
          f"recording), all {launches[1]} warp-specialised")


def phase_train(setup: tuple) -> dict:
    """The training path with the fused SchNet stack (``use_pallas``) at full
    width and the CLI's defaults (``--device_data auto``): its stack kernels'
    launch counts, then a fixed-batch descent check with step times and a
    profile, then sampling from the checkpoint this run trained."""
    import torch

    from tsdiff_tpu_torch.data import PaddedBatchLoader, TSDataset
    from tsdiff_tpu_torch.ops import schnet_stack as ss

    model_cfg, train_cfg, paths, buckets = setup
    model_cfg = {**model_cfg, "packed_train": False, "use_pallas": True}
    cfg_path = write_train_config("train_config", model_cfg, train_cfg, paths, buckets)
    B, iters = train_cfg["batch_size"], train_cfg["max_iters"]
    val_loader = PaddedBatchLoader(TSDataset(paths["val"]), B, bucket_sizes=buckets)
    val_batches = len(val_loader)
    validations = sum(1 for it in range(1, iters + 1) if it % train_cfg["val_freq"] == 0
                      or it == iters)
    ss.schnet_stack_fwd.launches = ss.schnet_stack_bwd.launches = 0
    ss.schnet_stack_fwd.wg_launches = ss.schnet_stack_bwd.wg_launches = 0
    ss.schnet_stack_bwd.xty_wg_launches = 0
    ss.interaction_stack_pallas.launches = ss.interaction_stack_pallas.wg_launches = 0
    ss.schnet_stack_fwd_reference.calls = ss.schnet_stack_bwd_reference.calls = 0
    ss.interaction_stack_reference.calls = 0
    ss.arrange_stack_weights.calls = ss.ea_tile_images.calls = 0
    run = run_train_cli("train", cfg_path, train_cfg, ["--dtype", "bfloat16"], "logs",
                        profiled=True)
    launches = (ss.schnet_stack_fwd.launches, ss.schnet_stack_bwd.launches)
    fwd_wg, bwd_wg = ss.schnet_stack_fwd.wg_launches, ss.schnet_stack_bwd.wg_launches
    xty_wg = ss.schnet_stack_bwd.xty_wg_launches
    b4_launches = ss.interaction_stack_pallas.launches
    plain = (ss.schnet_stack_fwd_reference.calls, ss.schnet_stack_bwd_reference.calls,
             ss.interaction_stack_reference.calls)
    made = (ss.arrange_stack_weights.calls, ss.ea_tile_images.calls)
    # one graph per (step kind, bucket); a key's first call runs eagerly, then
    # the graph is recorded: the wrappers count both, and no replay
    graphs = run["graphs"]
    want_keys = {("train", b) for b in buckets} | {("eval", b.pos.shape[1]) for b in val_loader}
    n_train = sum(k == "train" for k, _ in graphs["recorded"])
    n_eval = len(graphs["recorded"]) - n_train
    replays = {kind: sum(n for (k, _), n in graphs["replays"].items() if k == kind)
               for kind in ("train", "eval")}
    expect_fwd, expect_bwd = 2 * (n_train + n_eval), 2 * n_train
    # on the card, counted by kernel name in this run: every forward (each
    # key's eager first call and every replay, train and eval) is one launch
    # of B3's wgmma forward (``<true>``: it stores hs; ``<false>`` is B4) and
    # every backward L launches each of the wgmma row and weight-gradient kernels
    L = model_cfg["encoder"]["num_convs"]
    ran_fwd = n_train + n_eval + replays["train"] + replays["eval"]
    ran_bwd = n_train + replays["train"]
    named = {kernel: sum(n for name, n in run["kernels"].items() if kernel in name)
             for kernel in ("schnet_fwd_wg_kernel<true>", "schnet_fwd_wg_kernel<false>",
                            "schnet_bwd_rows_wg_kernel", "schnet_bwd_xty_wg_kernel")}
    other_stack = sorted({re.search(r"schnet_\w+", name).group(0)
                          for name in run["kernels"] if "schnet_" in name}
                         - {"schnet_fwd_wg_kernel", "schnet_bwd_rows_wg_kernel",
                            "schnet_bwd_xty_wg_kernel", "schnet_bwd_xty_wg_reduce_kernel",
                            "schnet_bwd_sum_kernel"})
    measured = (named["schnet_fwd_wg_kernel<true>"], named["schnet_bwd_rows_wg_kernel"] // L,
                named["schnet_bwd_xty_wg_kernel"] // L, named["schnet_fwd_wg_kernel<false>"])
    print(f"[train] {iters} iterations of batch {B} (buckets {buckets}), {validations} "
          f"validations of {val_batches} batches, replayed from CUDA graphs "
          f"{graphs['recorded']} (expected one per (step kind, bucket): {sorted(want_keys)}): "
          f"replays {replays} (expected train {iters - n_train}, eval "
          f"{validations * val_batches - n_eval}); counted by kernel name in this run under "
          f"torch.profiler: {named} (expected forward {ran_fwd}: each key's eager first call "
          f"and every replay; row and weight-gradient kernels {L} x {ran_bwd} train steps; B4 "
          f"0), other stack kernels {other_stack} (expected none); so B3 ran {measured[0]} "
          f"forward and {measured[1]} backward calls, B4 {measured[3]}; wrapper counters: B3 "
          f"forward {launches[0]}, through the wgmma kernel {fwd_wg}, B3 backward "
          f"{launches[1]}, through the wgmma row kernel {bwd_wg} and the wgmma weight-gradient "
          f"kernel {xty_wg} (expected {expect_fwd} and {expect_bwd}: each graph's eager first "
          f"call and its recording), B4 {b4_launches}, plain-version calls {plain}; the weight "
          f"image and ea's tile images made {made} times (expected {expect_fwd} each: once per "
          f"forward, the backward reusing them)")
    if set(graphs["recorded"]) != want_keys or len(graphs["recorded"]) != len(want_keys):
        fail(f"CUDA graphs recorded {graphs['recorded']}, expected one per {sorted(want_keys)}")
    if replays != {"train": iters - n_train, "eval": validations * val_batches - n_eval}:
        fail(f"graph replays {replays} do not cover the run's steps")
    if named != {"schnet_fwd_wg_kernel<true>": ran_fwd, "schnet_fwd_wg_kernel<false>": 0,
                 "schnet_bwd_rows_wg_kernel": L * ran_bwd,
                 "schnet_bwd_xty_wg_kernel": L * ran_bwd} or other_stack:
        fail(f"the run's stack kernels by name {named} (others {other_stack}) do not match its "
             f"{ran_fwd} forward and {ran_bwd} backward calls")
    if launches != (expect_fwd, expect_bwd):
        fail(f"stack kernels launched {launches}, expected {(expect_fwd, expect_bwd)}")
    if fwd_wg != expect_fwd:
        fail(f"{fwd_wg} of {launches[0]} B3 forward calls took the wgmma kernel")
    if bwd_wg != expect_bwd:
        fail(f"{bwd_wg} of {launches[1]} B3 backward calls took the wgmma row kernel")
    if xty_wg != expect_bwd:
        fail(f"{xty_wg} of {launches[1]} B3 backward calls took the wgmma weight-gradient kernel")
    if made != (expect_fwd, expect_fwd):
        fail(f"the weight image and ea's tile images were made {made} times, expected "
             f"{expect_fwd} each")
    if any(plain):
        fail(f"the plain stack versions ran {plain} times on the training path")
    # made from pinned memory at a shape's first eager backward (phase 3's,
    # or a train graph's eager first call), so never inside a recording
    tables = sorted((rows, nodes) for rows, nodes, _ in ss._xty_tables)
    print(f"[train] B3's weight-gradient schedule tables (pair rows, node rows), made by eager "
          f"backward calls before any recording: {tables}")
    if not tables:
        fail("no weight-gradient schedule table was made by the eager first calls")
    if "device-resident corpus" not in run["log"]:
        fail("the train CLI's default (--device_data auto) did not keep the corpus on the card")
    # the CLI's graphs/s, unprofiled, with the corpus resident and streamed,
    # in turns: the host sets the pace of these 40-iteration runs and drifts
    # between them
    gps = {"auto": [], "off": []}
    timed = []
    for i, mode in enumerate(("auto", "off", "off", "auto")):
        timed.append(run_train_cli("train", cfg_path, train_cfg,
                                   ["--dtype", "bfloat16", "--device_data", mode],
                                   f"logs_{i}_{mode}"))
        gps[mode].append(timed[-1]["graphs_per_s"])
    print(f"[train] CLI graphs/s in the order auto, off, off, auto: --device_data auto "
          f"{gps['auto']}, off {gps['off']}")

    fixed = fixed_batch_steps("train", model_cfg, train_cfg, paths, buckets)
    eager_run = compare_cli_losses("train", cfg_path, (model_cfg, train_cfg, paths, buckets),
                                   ["--dtype", "bfloat16", "--device_data", "auto"], timed[0])
    print(f"[train] CLI graphs/s of the eager run on the same flags: "
          f"{eager_run['graphs_per_s']:.4f} (captured, the same flags: "
          f"{timed[0]['graphs_per_s']:.4f})")
    rows = fixed["rows"]
    fwd = sum(ms for ms, _, name in rows if "schnet_fwd_" in name)
    bwd = [(ms, name) for ms, _, name in rows if "schnet_bwd_" in name]
    other = [(ms, n) for ms, n, name in rows if "schnet_" not in name]
    if fwd:
        fwd_names = sorted({re.search(r"schnet_fwd_\w*?kernel", name).group(0)
                            for _, _, name in rows if "schnet_fwd_" in name})
        print(f"[train] device time per step: B3 forward {fwd:.4f} ms ({', '.join(fwd_names)}), "
              f"B3 backward "
              f"{sum(ms for ms, _ in bwd):.4f} ms (" + ", ".join(
                  f"{BWD_KERNEL.search(name).group(0)} {ms:.4f}"
                  for ms, name in bwd)
              + f"), all other kernels {sum(ms for ms, _ in other):.4f} ms "
              f"({sum(n for _, n in other):.1f} launches/step)")
        for k_ms, n, name in [r for r in rows if "schnet_" not in r[2]][:5]:
            print(f"[train]   other: {k_ms:.4f} ms/step in {n:.0f} launches: {name[:100]}")
    sample_with("train", run["ckpt"])
    torch.cuda.empty_cache()
    return dict(launches=measured[:2], xty_launches=measured[2], b4_launches=measured[3],
                wall=run["wall"], ms_per_step=fixed["ms_per_step"],
                cli_graphs_per_s=timed[0]["graphs_per_s"], final_loss=run["losses"][-1][2],
                graphs_per_s=gps)


def phase_train_packed(setup: tuple) -> dict:
    """The production command line: the trained members' ``model`` block
    unchanged (``packed_train``, no ``use_pallas``) with the training phase's
    ``train`` block, ``--tag seed0 --dtype bfloat16 --packed_train
    --device_data auto``; checks the run's directory and resident corpus, and
    that no stack kernel and no plain version ran; then the same run with
    ``--device_data off``, ``off`` and ``auto``, in turns; then the
    fixed-batch check, step times and profile; then sampling from the
    packed-trained checkpoint through B1."""
    import torch

    from tsdiff_tpu_torch.ops import packed_score as ps
    from tsdiff_tpu_torch.ops import schnet_stack as ss

    model_cfg, train_cfg, paths, buckets = setup
    if not model_cfg.get("packed_train") or model_cfg.get("use_pallas"):
        fail("the trained members' model block no longer carries packed_train without use_pallas")
    cfg_path = write_train_config("train_config_packed", model_cfg, train_cfg, paths, buckets)
    counters = [(ss.schnet_stack_fwd, "launches"), (ss.schnet_stack_bwd, "launches"),
                (ss.interaction_stack_pallas, "launches"), (ss.schnet_stack_fwd_reference, "calls"),
                (ss.schnet_stack_bwd_reference, "calls"), (ss.interaction_stack_reference, "calls"),
                (ps.packed_score, "launches"), (ps.packed_score_reference, "calls")]
    runs = {"auto": [], "off": []}
    for i, mode in enumerate(("auto", "off", "off", "auto")):   # in turns, as in phase 6a
        for fn, attr in counters:
            setattr(fn, attr, 0)
        flags = ["--tag", "seed0", "--dtype", "bfloat16", "--packed_train", "--device_data", mode]
        run = run_train_cli("train packed", cfg_path, train_cfg, flags, f"logs_packed_{i}_{mode}")
        counts = {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in counters}
        resident = "device-resident corpus" in run["log"]
        print(f"[train packed] --device_data {mode}: run directory ends in _seed0: "
              f"{run['log_dir'].endswith('_seed0')}; resident corpus logged: {resident}; "
              f"stack kernels, plain versions and the packed score kernel on this path: {counts} "
              f"(all must be 0)")
        if not run["log_dir"].endswith("_seed0"):
            fail(f"the run directory {run['log_dir']} does not end in _seed0")
        if resident != (mode == "auto"):
            fail(f"--device_data {mode}: resident corpus logged {resident}")
        if any(counts.values()):
            fail(f"--device_data {mode}: a stack kernel, a plain version or B1 ran on the packed "
                 f"training path: {counts}")
        recorded = run["graphs"]["recorded"]
        if len(set(recorded)) != len(recorded) or {k for k, _ in recorded} != {"train", "eval"} \
                or sum(run["graphs"]["replays"].values()) == 0:
            fail(f"--device_data {mode}: CUDA graphs {run['graphs']}, expected one per (step "
                 f"kind, bucket), replayed")
        runs[mode].append(run)
    print(f"[train packed] CLI graphs/s in the order auto, off, off, auto: --device_data auto "
          f"{[r['graphs_per_s'] for r in runs['auto']]}, off "
          f"{[r['graphs_per_s'] for r in runs['off']]}")
    fixed = fixed_batch_steps("train packed", model_cfg, train_cfg, paths, buckets)
    for k_ms, n, name in fixed["rows"][:6]:
        print(f"[train packed]   kernel: {k_ms:.4f} ms/step in {n:.0f} launches: {name[:100]}")
    flags = ["--tag", "seed0", "--dtype", "bfloat16", "--packed_train", "--device_data", "auto"]
    eager_run = compare_cli_losses("train packed", cfg_path, setup, flags, runs["auto"][0])
    print(f"[train packed] CLI graphs/s of the eager run on the same flags: "
          f"{eager_run['graphs_per_s']:.4f} (captured: {runs['auto'][0]['graphs_per_s']:.4f})")
    sample_with("train packed", runs["auto"][0]["ckpt"])
    torch.cuda.empty_cache()
    val_loss = [v for kind, _, v in runs["auto"][0]["losses"] if kind == "Validate"][-1]
    return dict(graphs_per_s={m: [r["graphs_per_s"] for r in rs] for m, rs in runs.items()},
                val_loss=val_loss,
                **{k: fixed[k] for k in ("ms_per_step", "device_ms", "idle", "launches_per_step")})


def write_reference_pt(path: str, ck: dict) -> None:
    """``ck``'s raw weights as a reference ``<iter>.pt`` (``torch.save`` zip
    container): the state dict by the port's ``condensenc_state_dict_from_params``
    with the schedule's ``betas``/``alphas`` buffers, and the config as nested
    ``easydict.EasyDict`` (a stand-in module registered for the write only)."""
    import types

    import numpy as np
    import torch

    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.data.convert import condensenc_state_dict_from_params
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from tsdiff_tpu_torch.train import select_params

    mod = types.ModuleType("easydict")
    mod.EasyDict = type("EasyDict", (dict,), {"__module__": "easydict"})

    def easy(obj):
        return mod.EasyDict({k: easy(v) for k, v in obj.items()}) if isinstance(obj, dict) else obj

    model_cfg = ck["config"]["model"]
    sd = {k: torch.from_numpy(np.array(v)) for k, v in condensenc_state_dict_from_params(
        select_params(ck, False)[0], model_cfg["encoder"]["num_convs"]).items()}
    schedule = DiffusionSchedule.from_config(Config(model_cfg))
    sd["betas"] = torch.from_numpy(np.asarray(schedule.betas, np.float32))
    sd["alphas"] = torch.from_numpy(np.asarray(schedule.alphas, np.float32))
    saved = sys.modules.get("easydict")
    sys.modules["easydict"] = mod
    try:
        torch.save({"config": easy(ck["config"]), "model": sd, "iteration": ck["iteration"],
                    "avg_val_loss": ck["avg_val_loss"]}, path)
    finally:
        sys.modules.pop("easydict")
        if saved is not None:
            sys.modules["easydict"] = saved


def write_pyg_pickle(path: str, graphs: list) -> None:
    """``graphs`` as a reference PyG pickle: one ``torch_geometric`` ``Data``
    per reaction (the port's stand-in, pickled under PyG's name), its fields
    torch tensors, the condensed bonds as ``edge_index``/``edge_type``."""
    import numpy as np
    import torch

    from tsdiff_tpu_torch.data import pyg_compat

    installed = pyg_compat.install_pyg_stubs()
    try:
        data = []
        for g in graphs:
            row, col = np.nonzero(g["bond_mat"])
            data.append(pyg_compat.StubData(
                atom_type=torch.from_numpy(np.asarray(g["atom_type"], np.int64)),
                r_feat=torch.from_numpy(g["r_feat"]), p_feat=torch.from_numpy(g["p_feat"]),
                pos=torch.from_numpy(g["pos"]),
                edge_index=torch.from_numpy(np.stack([row, col]).astype(np.int64)),
                edge_type=torch.from_numpy(g["bond_mat"][row, col].astype(np.int64)),
                smiles=g["smiles"]))
        with open(path, "wb") as f:
            pickle.dump(data, f)
    finally:
        for name in installed:
            sys.modules.pop(name, None)


def sample_cli(tag: str, ckpts: list, test_set: str, save_dir: str, n_steps: int = 5000,
               extra=()) -> tuple:
    """The sampling CLI with phase 4's flags (bf16, ``--fused_score``, ``ld``,
    the ``n_steps`` window in 625 respaced calls, batch 100, the default
    seed) plus ``extra``, on the captured walk, under torch.profiler: B1
    once per walk step and once more per graph by kernel name, none of B5;
    the wrapper counters at each graph's eager first step and recording, no
    plain version; all positions finite.  ``(results, B1's launches by
    name, D-MAE mean, evaluate CLI's output)``."""
    import numpy as np

    from tsdiff_tpu_torch.cli import evaluate, sampling
    from tsdiff_tpu_torch.eval.dmae import calc_dmae
    from tsdiff_tpu_torch.ops import packed_score as ps

    respacing = 625
    ps.packed_score.launches = ps.packed_score.wg_launches = 0
    ps.packed_score_reference.calls = 0
    argv = ckpts + [
        "--test_set", test_set, "--dtype", "bfloat16", "--fused_score",
        "--sort_by_size", "--sampling_type", "ld", "--batch_size", "100", "--device", "cuda",
        "--n_steps", str(n_steps), *extra]
    t0 = time.monotonic()
    save_path, prof = profiled_call(lambda: sampling.main(
        argv + ["--save_dir", save_dir, "--timestep_respacing", str(respacing)]))
    wall = time.monotonic() - t0
    counts = kernel_counts(prof)
    by_name = score_launches(counts)
    del prof
    with open(save_path, "rb") as f:
        results = pickle.load(f)
    attempts = [results[i]["sampling_attempts"] for i in range(0, len(results), 100)]
    graphs, keys = cli_graphs(save_dir)
    expected = 2 * graphs
    expected_run = respacing * sum(attempts) + graphs
    launches = (ps.packed_score.launches, ps.packed_score.wg_launches)
    print(f"[interop] {tag}: {len(results)} samples in {wall:.3f} s under torch.profiler "
          f"(checkpoints and test set loaded, sampled, written), attempts {attempts}, "
          f"{respacing * sum(attempts)} walk steps replayed from {graphs} CUDA graphs ({keys}): "
          f"by kernel name B1 {by_name[False]} (expected {expected_run}: every walk step and "
          f"each graph's eager first step), B5 {by_name[True]} (expected 0); wrapper counters: "
          f"packed_score {launches[0]}, of the wgmma kernel {launches[1]} (expected {expected} "
          f"each: each graph's eager first step and its recording), plain-version calls "
          f"{ps.packed_score_reference.calls}")
    if graphs == 0 or launches != (expected, expected) or ps.packed_score_reference.calls:
        fail(f"{tag}: B1's wgmma kernel did not carry every recorded walk")
    if (by_name[False], by_name[True]) != (expected_run, 0):
        # the walk's other kernels tell a launch missing from a record lost by the trace
        per_step = sorted(((n, name[:80]) for name, n in counts.items()
                           if n >= respacing * sum(attempts)), reverse=True)
        fail(f"{tag}: the captured walk did not launch B1 once per step; the trace's kernels "
             f"with at least one launch per walk step: {per_step}")
    for r in results:
        if r["pos_gen"].shape != (len(r["atom_type"]), 3) or not np.isfinite(r["pos_gen"]).all():
            fail(f"{tag}: non-finite or misshaped pos_gen")
    dmae = float(np.mean([calc_dmae(r["pos"], r["pos_gen"]) for r in results]))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        evaluate.main(["--samples", save_path])
    return results, by_name[False], dmae, " / ".join(printed.getvalue().strip().splitlines())


def phase_reference_interop(setup: tuple, packed: dict) -> dict:
    """Phase 10: the reference's artifacts through the port on the card.
    (a) the 8 members as reference ``.pt`` files and phase 4's first 100
    reactions as a PyG pickle, sampled through B1, against the ``.ckpt``
    files on the native pickle: equal bit for bit; (b) the production
    command line warm-started from seed101's ``.pt``; (c) its run resumed
    with ``--profile``; (d) guess refinement: noisy true geometries attached
    by the post-processing CLI, denoised from t = 1500."""
    import numpy as np

    from tsdiff_tpu_torch.cli import post_processing
    from tsdiff_tpu_torch.cli import train as train_cli
    from tsdiff_tpu_torch.data.dataset import save_dataset
    from tsdiff_tpu_torch.data.parse_xyz import format_xyz_block
    from tsdiff_tpu_torch.data.synthetic import make_corpus
    from tsdiff_tpu_torch.eval.dmae import calc_dmae
    from tsdiff_tpu_torch.train import get_checkpoint_path, load_checkpoint

    t_phase = time.monotonic()
    out_dir = os.path.join(ROOT, ".scratch", "chip_smoke_interop")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ckpts = [os.path.join(CKPT_DIR, f"seed{s}_best.ckpt") for s in MEMBER_SEEDS]
    pts = []
    for path in ckpts:
        pts.append(os.path.join(out_dir, os.path.basename(path)[:-5] + ".pt"))
        write_reference_pt(pts[-1], load_checkpoint(path))
    graphs = make_corpus(200, seed=2024)[:100]          # phase 4's first 100 reactions
    native, pyg = os.path.join(out_dir, "test_data.pkl"), os.path.join(out_dir, "test_pyg.pkl")
    save_dataset(native, graphs)
    write_pyg_pickle(pyg, graphs)
    print(f"[interop] wrote {len(pts)} reference .pt files ({os.path.getsize(pts[0]):,} bytes "
          f"each) and a PyG pickle of {len(graphs)} reactions")

    # (a) .pt + PyG against .ckpt + native
    got, n_pt, dmae_pt, eval_pt = sample_cli(".pt + PyG", pts, pyg, os.path.join(out_dir, "pt"))
    want, n_ck, dmae_ck, eval_ck = sample_cli(".ckpt + native", ckpts, native,
                                              os.path.join(out_dir, "ckpt"))
    diff = max(float(np.abs(a["pos_gen"] - b["pos_gen"]).max()) for a, b in zip(got, want))
    same = len(got) == len(want) == 100 and all(
        a["smiles"] == b["smiles"] and np.array_equal(a["pos_gen"], b["pos_gen"])
        for a, b in zip(got, want))
    print(f"[interop] (a) pos_gen of the .pt + PyG run against the .ckpt + native run: max |diff| "
          f"{diff}, equal bit for bit: {same}; D-MAE mean {dmae_pt:.4f} / {dmae_ck:.4f}; "
          f"evaluate CLI: {eval_pt} || {eval_ck}")
    if not same:
        fail("sampling from the .pt files and the PyG pickle differs from the .ckpt run")

    # (b) the production command line warm-started from seed101's .pt
    model_cfg, train_cfg, paths, buckets = setup
    cfg_path = write_train_config("train_config_pretrain", model_cfg, train_cfg, paths, buckets)
    warm = pts[MEMBER_SEEDS.index(101)]
    flags = ["--tag", "seed0", "--dtype", "bfloat16", "--packed_train", "--device_data", "auto"]
    run = run_train_cli("interop pretrain", cfg_path, train_cfg, flags + ["--pretrain", warm],
                        "logs_pretrain")
    val = [v for kind, _, v in run["losses"] if kind == "Validate"]
    named = f"Warm-start weights from {warm}" in run["log"]
    print(f"[interop] (b) --pretrain {os.path.basename(warm)}: log names it: {named}; last "
          f"validation loss {val[-1]:.4f} against {packed['val_loss']:.4f} from random init "
          f"(phase 6b, the same iteration)")
    if not named:
        fail("the --pretrain run's log does not name the warm-start file")
    if not val[-1] < packed["val_loss"]:
        fail("the warm-started run's validation loss is not below the run from random init")

    # (c) resume (b) with --profile
    ck_path, it = get_checkpoint_path(os.path.join(run["log_dir"], "checkpoints"))
    ck = load_checkpoint(ck_path)
    opt = ck["opt_state"]
    jax_layout = (isinstance(opt, tuple) and len(opt) == 2 and opt[0] == ()
                  and set(opt[1]) == {"count", "mu", "nu"})

    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key in tree for k, v in shapes(tree[key], f"{prefix}/{key}").items()}
        return {prefix: np.shape(tree)}

    if jax_layout:
        jax_layout = shapes(opt[1]["mu"]) == shapes(opt[1]["nu"]) == shapes(ck["params"])
    count = int(opt[1]["count"]) if jax_layout else None
    resume_iters = train_cfg["max_iters"] + 20
    resumed = train_cli.main([run["log_dir"], "--logdir", os.path.join(TRAIN_DIR, "logs_resume"),
                              "--max_iters", str(resume_iters), "--profile", *flags,
                              "--device", "cuda"])
    with open(os.path.join(resumed, "log.txt")) as f:
        log = f.read()
    losses = [float(v) for v in re.findall(r"\] Iter \d+ \| Loss (\S+)", log)]
    ck2_path, it2 = get_checkpoint_path(os.path.join(resumed, "checkpoints"))
    count2 = int(load_checkpoint(ck2_path)["opt_state"][1]["count"])
    timings = log[log.find("Phase timings:"):] if "Phase timings:" in log else ""
    phase_ms = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^\s*tsdiff\.train\.(\w+): +\S+ ms total, +(\S+) ms a call", timings, re.M)}
    print(f"[interop] (c) resumed {os.path.relpath(ck_path, ROOT)} (iteration {it}, JAX layout "
          f"((), {{count, mu, nu}}) with params' leaf shapes: {jax_layout}, count {count}) to "
          f"iteration {resume_iters}: checkpoint at {it2} with count {count2} (expected "
          f"{None if count is None else count + it2 - it + 1}); losses finite: "
          f"{bool(losses) and bool(np.all(np.isfinite(losses)))}; phase timings {phase_ms}: "
          f"train.step {phase_ms.get('step')} host ms per step profiled (no sync) "
          f"against phase 6b's unprofiled {packed['ms_per_step']:.4f} ms on the fixed batch")
    if not jax_layout:
        fail("the checkpoint the resume read does not have the JAX optimizer-state layout")
    if count2 != count + it2 - it + 1:
        fail("the resumed run's optimizer count does not continue from the saved one")
    if not losses or not np.all(np.isfinite(losses)):
        fail("the resumed run logged non-finite losses")
    if not {"data", "step"} <= set(phase_ms) or not os.path.exists(
            os.path.join(resumed, "trace.json")):
        fail("the --profile run logged no Phase timings of train.data and train.step, "
             "or wrote no trace.json")

    # (d) guess refinement
    rng = np.random.default_rng(2024)
    xyz = os.path.join(out_dir, "guess.xyz")
    with open(xyz, "w") as f:
        f.write("".join(format_xyz_block(g["atom_type"], g["pos"] + rng.normal(
            scale=0.3, size=g["pos"].shape)) for g in graphs))
    guess = os.path.join(out_dir, "test_guess.pkl")
    post_processing.main(["--data", native, "--xyz", xyz, "--key", "ts_guess", "--out", guess])
    refined, n_guess, dmae_guess, eval_guess = sample_cli(
        "ts guess", pts, guess, os.path.join(out_dir, "refined"), n_steps=1500,
        extra=["--from_ts_guess", "--denoise_from_time_t", "1500"])
    start = float(np.mean([calc_dmae(r["pos"], r["ts_guess"]) for r in refined]))
    print(f"[interop] (d) guesses (true TS + N(0, 0.3 A)) at D-MAE {start:.4f}, refined from "
          f"t = 1500 in 625 calls: D-MAE mean {dmae_guess:.4f} (bound {DMAE_BOUND}) against "
          f"{dmae_pt:.4f} generated from noise in (a); evaluate CLI: {eval_guess}")
    if not dmae_guess < DMAE_BOUND:
        fail(f"refined guesses' mean D-MAE {dmae_guess:.4f} >= {DMAE_BOUND}")
    print(f"[interop] phase 10 took {time.monotonic() - t_phase:.3f} s")
    return dict(launches=n_pt + n_ck + n_guess, test_set=native, ckpt_results=want)


def profiled_round(svc, tier: int, batch, int8: bool) -> dict:
    """One warm round of ``PROFILED_WALK`` steps of ``svc`` at ``(24, tier)``
    (the first records its graph), then one under torch.profiler.  Counts
    the launches of the score kernel on the service's path (B5 for
    ``int8``, else B1) and of the other by kernel name, and fails unless
    they are ``PROFILED_WALK`` and 0.  The device time per step is the sum
    of every device event that starts from the first step's score kernel up
    to the last step's, over the ``PROFILED_WALK - 1`` steps between them:
    the round's set-up and read-back lie outside."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    svc._execute(24, tier, batch, PROFILED_WALK)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        svc._execute(24, tier, batch, PROFILED_WALK)
        torch.cuda.synchronize()
    events = sorted((ev.time_range.start, ev.time_range.elapsed_us(), ev.name)
                    for ev in prof.events() if ev.device_type == DeviceType.CUDA)

    def score(name: str, want_int8: bool) -> bool:
        return "packed_score" in name and ("int8" in name) == want_int8 \
            and "selftest" not in name

    on_path = [(t, us) for t, us, name in events if score(name, int8)]
    other = sum(score(name, not int8) for _, _, name in events)
    if (len(on_path), other) != (PROFILED_WALK, 0):
        fail(f"a profiled {'int8' if int8 else 'bf16'} round of {PROFILED_WALK} steps at tier "
             f"{tier} launched its score kernel {len(on_path)} times and the other {other}")
    first, last = on_path[0][0], on_path[-1][0]
    window = [us for t, us, _ in events if first <= t < last]
    steps = PROFILED_WALK - 1
    return dict(launches=len(on_path), device_ms=sum(window) / steps / 1e3,
                events=len(window) / steps,
                kernel_ms=sum(us for _, us in on_path) / len(on_path) / 1e3)


def post_json(port: int, payload: dict) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def serve_clients(port: int, graphs: list, quality: str, sizes: list[int], threads: int = 8):
    """POST ``graphs`` in consecutive chunks of ``sizes`` from ``threads``
    client threads, each taking the next chunk when its last one returned.
    Returns ``(positions by graph, latency s by graph, wall s)``."""
    import threading

    import numpy as np

    chunks, i = [], 0
    for n in sizes:
        if i >= len(graphs):
            break
        chunks.append(list(range(i, min(i + n, len(graphs)))))
        i += n
    pos, lat, errors = [None] * len(graphs), [None] * len(graphs), []
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                if not chunks:
                    return
                idx = chunks.pop(0)
            body = {"quality": quality, "graphs": [
                {"atom_type": graphs[j]["atom_type"].tolist(), "r_feat": graphs[j]["r_feat"].tolist(),
                 "p_feat": graphs[j]["p_feat"].tolist(), "pos": None,
                 "bond_mat": graphs[j]["bond_mat"].tolist()} for j in idx]}
            t0 = time.monotonic()
            code, out = post_json(port, body)
            dt = time.monotonic() - t0
            if code != 200:
                errors.append(f"HTTP {code}: {out}")
                return
            for k, j in enumerate(idx):
                pos[j] = np.asarray(out["pos_gen"][k], np.float32)
                lat[j] = dt
                if out["nan"][k]:
                    errors.append(f"graph {j} came back with nan")

    workers = [threading.Thread(target=client) for _ in range(threads)]
    t0 = time.monotonic()
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=900)
    wall = time.monotonic() - t0
    if errors or any(w.is_alive() for w in workers):
        fail(f"serving clients: {errors[:3] or 'a client did not return'}")
    return pos, np.array(lat), wall


def served_dmae(tag: str, graphs: list, pos: list) -> float:
    import numpy as np

    from tsdiff_tpu_torch.eval.dmae import calc_dmae

    for g, p in zip(graphs, pos):
        if p is None or p.shape != (len(g["atom_type"]), 3) or not np.isfinite(p).all():
            fail(f"[{tag}] a request did not resolve to finite (n, 3) positions")
    dmae = np.array([calc_dmae(g["pos"], p) for g, p in zip(graphs, pos)])
    print(f"[{tag}] D-MAE mean {dmae.mean():.4f} median {np.median(dmae):.4f} over "
          f"{len(dmae)} requests (identity matching, bound {DMAE_BOUND})")
    if not dmae.mean() < DMAE_BOUND:
        fail(f"[{tag}] mean D-MAE {dmae.mean():.4f} >= {DMAE_BOUND}")
    return float(dmae.mean())


def serve_rounds(svc) -> dict:
    """``{(bucket, respacing, tier): rounds}`` walked by a service, retries
    keyed with "retry"."""
    return {(*key, tier): n for key, runner in svc._runners.items()
            for tier, n in runner.rounds().items() if n}


def steps_walked(svc, rounds_before: dict | None = None) -> int:
    before = rounds_before or {}
    return sum((n - before.get(key, 0)) * svc._runners[key[:-1]].n_walk
               for key, n in serve_rounds(svc).items())


def serve_cli(ckpts: list[str], graphs: list) -> None:
    """(e) the command line a user runs, ``python -m tsdiff_tpu_torch.serve
    CKPT... --fused_score --dtype bfloat16 --draft_respacing 625 --port P``,
    in its own process on the card: ``GET /healthz``, one draft ``POST
    /generate`` of two graphs and a 404; the process is stopped at the end."""
    import socket
    import urllib.error
    import urllib.request

    import numpy as np

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    cmd = [sys.executable, "-m", "tsdiff_tpu_torch.serve", *ckpts, "--fused_score",
           "--dtype", "bfloat16", "--draft_respacing", "625", "--port", str(port)]
    os.makedirs(os.path.join(ROOT, ".scratch"), exist_ok=True)
    log = open(os.path.join(ROOT, ".scratch", "serve_cli.log"), "w")
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        t0 = time.monotonic()
        health = None
        while health is None and time.monotonic() - t0 < 180 and proc.poll() is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=1) as r:
                    health = json.load(r)
            except OSError:
                time.sleep(0.5)
        if health is None or not health.get("ok"):
            fail(f"the serving CLI did not come up (exit code {proc.poll()}; log "
                 f".scratch/serve_cli.log)")
        up = time.monotonic() - t0
        body = {"quality": "draft", "graphs": [
            {"atom_type": g["atom_type"].tolist(), "r_feat": g["r_feat"].tolist(),
             "p_feat": g["p_feat"].tolist(), "pos": None, "bond_mat": g["bond_mat"].tolist()}
            for g in graphs]}
        t1 = time.monotonic()
        code, out = post_json(port, body)
        took = time.monotonic() - t1
        shapes = [np.asarray(p).shape for p in out.get("pos_gen", [])]
        req = urllib.request.Request(f"http://127.0.0.1:{port}/nothing")
        try:
            urllib.request.urlopen(req, timeout=10)
            missing = 200
        except urllib.error.HTTPError as e:
            missing = e.code
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            health = json.load(r)
        print(f"[serve cli] python -m tsdiff_tpu_torch.serve with the 8 members: up in {up:.1f} s; "
              f"POST /generate of 2 draft graphs: HTTP {code} in {took:.3f} s, shapes {shapes}, "
              f"nan {out.get('nan')}; GET /nothing: HTTP {missing}; /healthz {health}")
        want = [(len(g["atom_type"]), 3) for g in graphs]
        if code != 200 or shapes != want or any(out["nan"]) or missing != 404 \
                or health["served"] != len(graphs):
            fail("the serving CLI answered wrongly")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()


def served_kernel_checks(svc, quant: str | None, graphs: dict) -> float:
    """The service's score kernel (B5 for ``quant="int8"``, else B1) against
    its plain version on served rounds: for each bucket 8, 16 and 24 and
    tiers 4 and 32, one round of the draft walk on that many of ``graphs``
    (bucket -> reactions), then the kernel's wrapper and its plain version
    on what the round's buffers hold: the statics it copied in (packed
    pairs, the members' node states, the mask) and the positions it ended
    at.  Returns the largest max abs error."""
    import torch

    from tsdiff_tpu_torch.core.graph import from_numpy_graphs
    from tsdiff_tpu_torch.ops import packed_score as ps
    from tsdiff_tpu_torch.ops import packed_score_int8 as p8

    kernel, plain, tol = ((p8.packed_score_int8, p8.packed_score_int8_reference, TOL_INT8)
                          if quant else (ps.packed_score, ps.packed_score_reference, None))
    ensemble, worst = svc.ensemble, 0.0
    model, L = ensemble.model, ensemble.model.num_convs
    for n_bucket in (8, 16, 24):
        for tier in (4, 32):
            batch = from_numpy_graphs(graphs[n_bucket][:tier], max_nodes=n_bucket, device="cuda")
            _, nan = svc._execute(n_bucket, tier, batch, 625)
            buf = svc._runners[(n_bucket, 625)]._tiers[tier]
            statics, pp = buf.statics, buf.statics.pairs
            with torch.no_grad():
                info = model.build_packed_pair_info(buf.pos, statics.node_mask, pp)
                args = (ensemble.weights, statics.z, info.d_in.contiguous(),
                        info.cmask.contiguous(), pp.type_r_in, pp.type_p_in, pp.type_r_out,
                        pp.type_p_out)
                out = kernel(*args, num_blocks=L)
                ref = plain(*args, num_blocks=L)
            torch.cuda.synchronize()
            if nan:
                fail(f"the served {quant or 'bf16'} round at N={n_bucket}, tier {tier} was NaN")
            pairs = int(info.cmask.sum().item())
            tag = f"served {kernel.__name__} N={n_bucket} tier {tier} ({pairs} pairs in cutoff)"
            worst = max(worst, check_close(tag, out, ref, "bfloat16", tol=tol))
    return worst


def phase_serving() -> dict:
    """The serving entry point, in process: ``SamplerService`` and its HTTP
    front on 127.0.0.1 with the 8 members, bf16, ``fused_score``, 5000
    steps, a draft tier of 625, ``max_batch`` 32, ``max_wait_ms`` 50.
    (a) phase 4's 200 reactions as draft requests from 8 client threads,
    each POSTing 1-8 graphs at a time; (b) 32 of them at full quality;
    (c) captured rounds against eager rounds, B1 and B5, tiers 4 and 32,
    N=24, bit for bit; each kernel against its plain version on served
    rounds (``served_kernel_checks``) and its launches counted in profiled
    rounds (``profiled_round``); (d) ms per step eager and captured and the
    idle share by tier."""
    import threading

    import numpy as np
    import torch

    from tsdiff_tpu_torch import serve
    from tsdiff_tpu_torch.core.graph import from_numpy_graphs
    from tsdiff_tpu_torch.data.synthetic import make_corpus
    from tsdiff_tpu_torch.ops import packed_score as ps
    from tsdiff_tpu_torch.ops import packed_score_int8 as p8

    ckpts = [os.path.join(CKPT_DIR, f"seed{s}_best.ckpt") for s in MEMBER_SEEDS]

    def make_service(quant=None, capture=True):
        return serve.SamplerService(
            ckpts, n_steps=5000, dtype="bfloat16", fused_score=True, quant=quant,
            draft_respacing=625, max_batch=32, max_wait_s=0.05, capture=capture)

    counters = [(ps.packed_score, "launches"), (ps.packed_score, "wg_launches"),
                (p8.packed_score_int8, "launches"), (ps.packed_score_reference, "calls"),
                (p8.packed_score_int8_reference, "calls")]
    for fn, attr in counters:
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    svc = make_service()
    httpd = serve.make_http_server(svc, "127.0.0.1", 0)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    corpus = make_corpus(200, seed=2024)
    sizes = [int(n) for n in np.random.default_rng(7).integers(1, 9, size=200)]
    results = {}
    try:
        for tag, quality, graphs in (("serve draft", "draft", corpus),
                                     ("serve full", "full", corpus[:32])):
            before = serve_rounds(svc)
            pos, lat, wall = serve_clients(port, graphs, quality, sizes)
            steps = steps_walked(svc, before)
            rounds = {k: n - before.get(k, 0) for k, n in serve_rounds(svc).items()
                      if n > before.get(k, 0)}
            print(f"[{tag}] {len(graphs)} requests over HTTP from 8 client threads in "
                  f"{wall:.3f} s: {len(graphs) / wall:.4f} requests/s, latency p50 "
                  f"{np.percentile(lat, 50):.3f} s p99 {np.percentile(lat, 99):.3f} s; rounds by "
                  f"(bucket, respacing, tier): {rounds}; {steps} walk steps; graphs recorded so "
                  f"far {svc._graphs_captured}")
            results[tag] = dict(dmae=served_dmae(tag, graphs, pos), steps=steps, wall=wall,
                                p50=float(np.percentile(lat, 50)),
                                p99=float(np.percentile(lat, 99)))
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=60)
    health = svc._timed_out, svc._cancelled, svc._rejected
    peak = torch.cuda.max_memory_allocated() / 2**30
    keys = sorted(svc._runners, key=str)
    print(f"[serve] {svc._served} served, timed out/cancelled/rejected {health}; runners {keys}; "
          f"graphs recorded {svc._graphs_captured} (one per (bucket, tier, respacing) walked: "
          f"{sum(len(r.rounds()) for r in svc._runners.values())}); peak memory "
          f"{peak:.3f} GiB; B1 wrapper launches {ps.packed_score.launches} (warm-up steps and "
          f"recordings only), plain-version calls "
          f"{ps.packed_score_reference.calls + p8.packed_score_int8_reference.calls}")
    if svc._graphs_captured != sum(len(r.rounds()) for r in svc._runners.values()):
        fail("a (bucket, tier, respacing) was recorded more than once")
    if ps.packed_score.launches == 0 or ps.packed_score.wg_launches != ps.packed_score.launches:
        fail("the served rounds did not go through the warp-specialised B1 kernel")
    if ps.packed_score_reference.calls or p8.packed_score_int8_reference.calls \
            or p8.packed_score_int8.launches:
        fail("the plain version or B5 ran on the bf16 serving path")
    served_steps = sum(r["steps"] for r in results.values())

    # (c) captured against eager, bit for bit; the kernel against its plain
    # version on served rounds; (d) ms per step by tier
    rng = np.random.default_rng(31)
    graphs = {n: bucket_graphs(rng, n, 32) for n in (8, 16, 24)}
    batches = {t: from_numpy_graphs(graphs[24][:t], max_nodes=24, device="cuda")
               for t in SERVE_TIERS}
    served_err, profiled, by_tier = {}, {}, {}
    for quant in (None, "int8"):
        cap = svc if quant is None else make_service("int8")
        eager = make_service(quant, capture=False)
        for tier in (4, 32):
            eager._served = cap._served
            pos, nan = cap._execute(24, tier, batches[tier], 625)
            ref, ref_nan = eager._execute(24, tier, batches[tier], 625)
            diff = float(np.abs(pos - ref).max())
            print(f"[serve] captured against eager, {quant or 'bf16'}, tier {tier}, N=24, 625 "
                  f"steps: max abs difference {diff} (gate 0), NaN {nan}, {ref_nan}")
            if diff != 0.0 or nan or ref_nan or not np.isfinite(pos).all():
                fail(f"the captured {quant or 'bf16'} round at tier {tier} differs from the eager one")
        served_err[quant] = served_kernel_checks(cap, quant, graphs)
        # the launches on the serving path: profiled captured rounds, by kernel name
        profiled[quant] = sum(profiled_round(cap, tier, batches[tier], quant == "int8")["launches"]
                              for tier in ((4, 32) if quant else SERVE_TIERS))
        if quant is None:
            for tier in SERVE_TIERS:
                row = {}
                for mode, s in (("eager", eager), ("captured", cap)):
                    s._execute(24, tier, batches[tier], 625)      # recorded, warm
                    torch.cuda.synchronize()
                    t0 = time.monotonic()
                    s._execute(24, tier, batches[tier], 625)
                    row[mode] = (time.monotonic() - t0) / 625 * 1e3
                    prof = profiled_round(s, tier, batches[tier], int8=False)
                    row[mode + "_device"] = prof["device_ms"]
                    row[mode + "_idle"] = 1 - prof["device_ms"] / row[mode]
                    row[mode + "_b1"] = prof["kernel_ms"]
                    row[mode + "_events"] = prof["events"]
                by_tier[tier] = row
                print(f"[serve] tier {tier}, N=24, bf16: ms per step of a 625-step round eager "
                      f"{row['eager']:.4f}, captured {row['captured']:.4f} "
                      f"({row['eager'] / row['captured']:.3f}x); device ms per step of a profiled "
                      f"{PROFILED_WALK}-step round {row['eager_device']:.4f} and "
                      f"{row['captured_device']:.4f}, idle share against the unprofiled step "
                      f"{row['eager_idle']:.4f} and {row['captured_idle']:.4f}, device events per "
                      f"step {row['eager_events']:.1f} and {row['captured_events']:.1f}, B1 "
                      f"{row['captured_b1']:.4f} ms per launch ({8 * tier} CTAs on "
                      f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs); B1 "
                      f"launched {PROFILED_WALK} times in each profiled round")
        for s in (cap, eager):
            if s is not svc:
                s.close()
    print(f"[serve] launches counted by kernel name in the profiled captured rounds of "
          f"{PROFILED_WALK} steps: B1 {profiled[None]} (tiers {SERVE_TIERS}), B5 "
          f"{profiled['int8']} (tiers 4, 32); the served requests walked {served_steps} steps")
    svc.close()
    torch.cuda.empty_cache()
    serve_cli(ckpts, corpus[:2])
    return dict(b1_launches=profiled[None], b5_launches=profiled["int8"],
                walk_steps=served_steps, b1_err=served_err[None], b5_err=served_err["int8"],
                by_tier=by_tier, peak_gib=peak, **results)



# -- phase 11: the native packer, and the mesh of ranks on one card ----------

MESH_DIR = os.path.join(ROOT, ".scratch", "chip_smoke_mesh")
MESH_RANKS = 2
MESH_SHAPES = ("1,2", "2,1")
MESH_TRAIN_ITERS = 20
MESH_SERVE_TIER = 8
# the two rank processes' whole programme; a hang fails the phase, not the run
MESH_TIMEOUT_S = 420
PACKER_REPEATS = 20
# the mesh against one process on the same inputs.  dp only (2, 1): rows
# are independent, so equal bit for bit.  ens=2 (1, 2): the member sum over
# the ranks adds in another order than one rank's mean over 8, so one step's
# score differs at float32 rounding: held to the CPU test's f32 tolerance,
# 1e-5 of its largest magnitude.  Over a 625-step bf16 walk a difference
# flips bf16 roundings, which the walk carries on: per reaction the largest
# |difference| had median 0.0042 A and 90th percentile 0.019 A on an H100
# (a few reactions diverge further, 1.23 A at most, of 200), against a
# minimum of 1.46 A and a 10th percentile of 4.72 A for the same command
# with another seed (the control, printed each run); so the 90th percentile
# is held to 0.1 A and the mean D-MAE to 0.005 of one process's (it moved
# 0.0002; the mean's standard error is ~0.03)
MESH_STEP_RTOL = 1e-5
MESH_STEP_SEED = 4242
MESH_WALK_P90 = 0.1
MESH_DMAE_DELTA = 0.005
# phase 6's streamed (--device_data off) CLI graphs/s when its corpus (dense
# bond_mat) went through the numpy packer, on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md section 5): 6a use_pallas, 6b production
NUMPY_PACKER_OFF_GRAPHS_PER_S = {"6a": (7901.8, 6697.4), "6b": (2786.4, 7012.8)}


def median_ms(fn, repeats: int = PACKER_REPEATS) -> float:
    """Median host wall time of ``repeats`` calls of ``fn``, in ms."""
    import numpy as np

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_packer(train_gps: dict, packed_gps: dict) -> dict:
    """(a) ``from_numpy_graphs`` through the C++ packer (graphs with sparse
    edges, the on-disk form) against the numpy packer (the same graphs with
    a dense ``bond_mat``) on the training corpus's batches (B=200, N=16 and
    24) and the sampling CLI's (B=100, N=24): equal bit for bit, host ms per
    batch (median of 20, the casts and the tensors included); then phase 6's
    streamed graphs/s beside the numpy packer's."""
    import torch

    from tsdiff_tpu_torch.core.graph import from_numpy_graphs
    from tsdiff_tpu_torch.data import native
    from tsdiff_tpu_torch.data.synthetic import make_corpus, sparse_edges

    t0 = time.monotonic()
    native.native_available()
    print(f"[packer] C++ packer {os.path.relpath(native.library_path(), ROOT)} ready in "
          f"{time.monotonic() - t0:.3f} s (built at first use, phase 4)")
    train = make_corpus(1200, seed=31)[:1000]
    sample = sorted(make_corpus(200, seed=2024), key=lambda g: len(g["atom_type"]))
    cases = {
        "training B=200 N=16": ([g for g in train if len(g["atom_type"]) <= 16][:200], 16),
        "training B=200 N=24": ([g for g in train if len(g["atom_type"]) > 16][:200], 24),
        "sampling B=100 N=24": (sample[100:], 24),
    }
    out = {}
    for tag, (dense, n) in cases.items():
        sparse = sparse_edges(dense)
        a, b = from_numpy_graphs(sparse, max_nodes=n), from_numpy_graphs(dense, max_nodes=n)
        equal = all(torch.equal(getattr(a, f), getattr(b, f)) and
                    getattr(a, f).dtype == getattr(b, f).dtype
                    for f in ("atom_type", "r_feat", "p_feat", "pos", "bond_mat", "node_mask"))
        ms_native = median_ms(lambda: from_numpy_graphs(sparse, max_nodes=n))
        ms_numpy = median_ms(lambda: from_numpy_graphs(dense, max_nodes=n))
        ms_raw = median_ms(lambda: native.pack_batch_native(sparse, n))
        print(f"[packer] {tag} ({len(dense)} graphs): host ms per batch, median of "
              f"{PACKER_REPEATS}: C++ packer {ms_native:.4f} (of it pack_batch_native alone "
              f"{ms_raw:.4f}), numpy packer {ms_numpy:.4f}, numpy/C++ {ms_numpy / ms_native:.3f}x; "
              f"the batches equal bit for bit, dtypes included: {equal}")
        if not equal:
            fail(f"[packer] {tag}: the C++ and numpy packers' batches differ")
        out[tag] = dict(native_ms=ms_native, numpy_ms=ms_numpy, raw_ms=ms_raw)
    print(f"[packer] phase 6's streamed (--device_data off) CLI graphs/s with the C++ packer: "
          f"6a {train_gps['off']}, 6b {packed_gps['off']}; with the numpy packer (PERF.md "
          f"section 5): 6a {list(NUMPY_PACKER_OFF_GRAPHS_PER_S['6a'])}, 6b "
          f"{list(NUMPY_PACKER_OFF_GRAPHS_PER_S['6b'])}")
    return out


def phase_mesh_kernels() -> dict:
    """B1 and B5 at the call shapes of the mesh (4 members at B=100 with
    ens=2, 8 members at B=50 with dp=2) and B3 at half the training batch
    (B=100, N=16 and 24), bf16, against their plain versions, timed."""
    import torch

    from tsdiff_tpu_torch.diffusion.ensemble import stack_params
    from tsdiff_tpu_torch.ops import packed_score as ps
    from tsdiff_tpu_torch.ops import packed_score_int8 as p8
    from tsdiff_tpu_torch.ops import schnet_stack as ss

    out = {}
    dname, dtype = "bfloat16", torch.bfloat16
    members = load_members(dtype, torch.device("cuda"))
    for M, B in ((4, 100), (8, 50)):
        batch, pos = kernel_batch(24, seed=4000 + M, count=B)
        model = members[0]
        pp = model.precompute_packed_pairs(batch.bond_mat, batch.node_mask)
        info = model.build_packed_pair_info(pos, batch.node_mask, pp)
        with torch.no_grad():
            z = torch.stack([m.node_states(batch.atom_type, batch.r_feat, batch.p_feat,
                                           batch.node_mask) for m in members[:M]]).contiguous()
        rest = (z, info.d_in.contiguous(), info.cmask.contiguous(), pp.type_r_in,
                pp.type_p_in, pp.type_r_out, pp.type_p_out)
        L = model.num_convs
        ops = [("packed_score", ps.packed_score, ps.packed_score_reference,
                stack_params([m.kernel_weights() for m in members[:M]]), TOL[dname],
                ps.packed_score_cost)]
        if M == 4:
            ops.append(("packed_score_int8", p8.packed_score_int8,
                        p8.packed_score_int8_reference,
                        stack_params([m.kernel_weights_int8() for m in members[:M]]), TOL_INT8,
                        p8.packed_score_int8_cost))
        for name, kernel, plain, w, tol, cost in ops:
            tag = f"{name} M={M} B={B} N=24 {dname} (mesh shape)"
            got, ref = kernel(w, *rest, num_blocks=L), plain(w, *rest, num_blocks=L)
            torch.cuda.synchronize()
            err = check_close(f"{tag} out", got, ref, dname, tol=tol)
            out[(name, M, B)] = dict(time_and_bound(
                tag, lambda: kernel(w, *rest, num_blocks=L), lambda: plain(w, *rest, num_blocks=L),
                cost(w, z, L), dname), max_abs_err=err)
            del got, ref
    del members
    for n_bucket in (16, 24):
        B = 100
        w, h, ea, c, g = stack_inputs(B, n_bucket, dname, seed=800 + n_bucket)
        _, N, H = h.shape
        L = w["f1w"].shape[0]
        tag = f"B={B} N={N} {dname} (dp=2 shape)"
        image, ea_img = ss.stack_wg_operands(w, h, ea, c)
        o, hs = ss.schnet_stack_fwd(w, h, ea, c, image=image, ea_img=ea_img)
        r, rhs = ss.schnet_stack_fwd_reference(w, h, ea, c)
        e_fwd = max(check_close(f"schnet_stack_fwd {tag} out", o, r, dname),
                    check_close(f"schnet_stack_fwd {tag} hs", hs, rhs, dname))
        dh, dea, grads = ss.schnet_stack_bwd(w, ea, c, rhs, g, image=image, ea_img=ea_img)
        rdh, rdea, rgrads = ss.schnet_stack_bwd_reference(w, ea, c, rhs, g)
        e_bwd = max([check_close(f"schnet_stack_bwd {tag} dh", dh, rdh, dname),
                     check_close(f"schnet_stack_bwd {tag} dea", dea, rdea, dname)]
                    + [check_close(f"schnet_stack_bwd {tag} d{k}", grads[k], rgrads[k], dname)
                       for k in ss.W_KEYS])
        out[("fwd", N)] = dict(time_and_bound(
            f"schnet_stack_fwd {tag}",
            lambda: ss.schnet_stack_fwd(w, h, ea, c, image=image, ea_img=ea_img),
            lambda: ss.schnet_stack_fwd_reference(w, h, ea, c),
            ss.schnet_stack_cost(B, N, H, L, dtype, "fwd"), dname), max_abs_err=e_fwd)
        out[("bwd", N)] = dict(time_and_bound(
            f"schnet_stack_bwd {tag}", lambda: ss.schnet_stack_bwd(w, ea, c, rhs, g),
            lambda: ss.schnet_stack_bwd_reference(w, ea, c, rhs, g),
            ss.schnet_stack_cost(B, N, H, L, dtype, "bwd"), dname), max_abs_err=e_bwd)
        del w, h, ea, c, g, image, ea_img, o, hs, r, rhs, dh, dea, grads, rdh, rdea, rgrads
        torch.cuda.empty_cache()
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_mesh_ranks(plan: dict, backend: str) -> list[dict]:
    """Start the ``MESH_RANKS`` rank processes (this script with
    ``--mesh-rank``) on ``plan`` over ``backend`` and return what each saw;
    their logs go to ``MESH_DIR/<backend>/rank<r>.log``."""
    d = os.path.join(MESH_DIR, backend)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    with open(os.path.join(d, "plan.json"), "w") as f:
        json.dump(plan, f)
    port = free_port()
    env = dict(os.environ, TSDIFF_DIST_TIMEOUT_S="300")
    logs = [open(os.path.join(d, f"rank{r}.log"), "w") for r in range(MESH_RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
                               str(port), d, backend], stdout=log, stderr=subprocess.STDOUT,
                              cwd=ROOT, env=env) for r, log in enumerate(logs)]
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        fail(f"[mesh {backend}] the rank processes did not finish in {MESH_TIMEOUT_S} s "
             f"(logs in {os.path.relpath(d, ROOT)})")
    finally:
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(d, f"rank{r}.log")) as f:
                tail = f.read()[-4000:]
            fail(f"[mesh {backend}] rank {r} exited {p.returncode}:\n{tail}")
    out = []
    for r in range(MESH_RANKS):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def mesh_rank(rank: int, port: int, d: str, backend: str) -> None:
    """One rank of phase 11's mesh runs: the sampling CLI on each mesh of
    ``MESH_SHAPES`` (its run under torch.profiler, B1 counted by name and its
    members per launch), the train CLI with ``use_pallas`` (B3 counted by
    name), and a served round on the (1, 2) mesh (rank 0 batching, rank 1 in
    ``worker_loop``); writes ``rank<r>.json`` in ``d``."""
    sys.path.insert(0, ROOT)
    import torch

    from tsdiff_tpu_torch.cli import sampling
    from tsdiff_tpu_torch.cli import train as train_cli
    from tsdiff_tpu_torch.models import condensenc
    from tsdiff_tpu_torch.ops import packed_score as ps
    from tsdiff_tpu_torch.parallel import make_mesh, multihost
    from tsdiff_tpu_torch.serve import SamplerService

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(d, "plan.json")) as f:
        plan = json.load(f)
    coordinator = f"127.0.0.1:{port}"
    cluster = ["--multihost", "--coordinator", coordinator, "--nprocs", str(MESH_RANKS),
               "--procid", str(rank), "--dist_backend", backend]
    t_start = time.monotonic()
    device = multihost.initialize(coordinator, MESH_RANKS, rank, device="cuda", backend=backend)
    out = {"rank": rank, "device": str(device), "backend": backend,
           "seconds": {"initialize": time.monotonic() - t_start}}
    seen: list[int] = []
    real = condensenc.packed_score

    def spy(weights, z, *args, **kwargs):   # the members of every B1 call
        seen.append(int(z.shape[0]))
        return real(weights, z, *args, **kwargs)

    condensenc.packed_score = spy
    # one step of the packed ensemble's score on fixed inputs, per mesh
    from tsdiff_tpu_torch.diffusion.ensemble import load_members as load_ckpts
    from tsdiff_tpu_torch.diffusion.ensemble import make_ensemble
    from tsdiff_tpu_torch.parallel import shard_batch
    from tsdiff_tpu_torch.parallel.sharding import batch_spec

    batch, pos = kernel_batch(24, seed=MESH_STEP_SEED)
    for flag in plan["meshes"]:
        mesh = make_mesh(*(int(x) for x in flag.split(",")), device=device)
        members, _ = load_ckpts(plan["ckpts"], device, torch.bfloat16, fused_score=True,
                                mesh=mesh)
        ensemble = make_ensemble(members, mesh)
        rows = batch_spec(mesh).slice(pos.shape[0])
        node_eq = ensemble.step_fn(ensemble.prepare(shard_batch(batch, mesh)))(pos[rows])
        out[f"step_{flag}"] = dict(rows=[rows.start, rows.stop], members=len(members),
                                   node_eq=node_eq.cpu().tolist())
        del members, ensemble
    seen.clear()
    for flag in plan["meshes"]:
        save = os.path.join(d, f"sample_{flag}", f"rank{rank}")
        seen.clear()
        ps.packed_score.launches = 0
        t0 = time.monotonic()
        path, prof = profiled_call(lambda: sampling.main(
            plan["sample_argv"] + ["--save_dir", save, "--mesh", flag, *cluster]),
            device_only=True)
        wall = time.monotonic() - t0
        counts = kernel_counts(prof)
        del prof
        out.setdefault("seconds", {})[f"sample_{flag}"] = time.monotonic() - t0
        by_name = score_launches(counts)
        log = ""
        if os.path.exists(os.path.join(save, "log.txt")):
            with open(os.path.join(save, "log.txt")) as f:
                log = f.read()
        out[f"sample_{flag}"] = dict(path=path, wall=wall, b1=by_name[False], b5=by_name[True],
                                     wrapper=ps.packed_score.launches, calls=len(seen),
                                     members=sorted(set(seen)), log=log)
    from tsdiff_tpu_torch.ops import schnet_stack as ss

    ss.schnet_stack_fwd_reference.calls = ss.schnet_stack_bwd_reference.calls = 0
    t0 = time.monotonic()
    run, prof = profiled_call(lambda: train_cli.main(
        [plan["train_cfg"], "--logdir", os.path.join(d, "train"), "--dtype", "bfloat16",
         "--device", "cuda", *cluster]), device_only=True)
    wall = time.monotonic() - t0
    counts = kernel_counts(prof)
    del prof
    out["seconds"]["train"] = time.monotonic() - t0
    t0 = time.monotonic()
    with open(os.path.join(run, "log.txt")) as f:
        log = f.read()
    out["train"] = dict(
        run=run, wall=wall, log=log,
        named={k: sum(n for name, n in counts.items() if k in name)
               for k in ("schnet_fwd_wg_kernel<true>", "schnet_fwd_wg_kernel<false>",
                         "schnet_bwd_rows_wg_kernel", "schnet_bwd_xty_wg_kernel")},
        plain=[ss.schnet_stack_fwd_reference.calls, ss.schnet_stack_bwd_reference.calls])
    for flag in plan["meshes"]:
        svc = SamplerService(plan["ckpts"], n_steps=5000, dtype="bfloat16", fused_score=True,
                             draft_respacing=625, max_batch=MESH_SERVE_TIER, device="cuda",
                             capture=backend == "nccl",
                             mesh=make_mesh(*(int(x) for x in flag.split(",")), device=device))
        if rank == 0:
            with open(plan["serve_graphs"], "rb") as f:
                graphs = pickle.load(f)
            results = svc.generate(graphs, quality="draft")
            svc.close()
            out[f"serve_{flag}"] = [r["pos_gen"].tolist() for r in results]
        else:
            svc.worker_loop()
        out[f"served_graphs_{flag}"] = svc._graphs_captured
        del svc
    out["seconds"]["serve"] = time.monotonic() - t0
    torch.distributed.destroy_process_group()
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_mesh(main_path: dict, setup: tuple, backends: list | None = None) -> dict:
    """(b)-(e): two ranks on one card over Gloo (the walk and the steps
    eager: Gloo's collectives cannot be captured): the sampling CLI on the
    (1, 2) and (2, 1) meshes against phase 4's one-process run of the same
    command and seed, B1 counted by name on each rank with its members per
    launch; the train CLI data-parallel over 2 ranks (``use_pallas``, bf16,
    20 iterations) against the one-process run, B3 counted by name on each
    rank; one served draft round at tier 8 on the (1, 2) mesh against the
    one-process service's; with two or more GPUs, the same over NCCL with
    the collectives captured."""
    import numpy as np
    import torch

    from tsdiff_tpu_torch import serve
    from tsdiff_tpu_torch.data import PaddedBatchLoader, TSDataset
    from tsdiff_tpu_torch.data.synthetic import make_corpus
    from tsdiff_tpu_torch.eval.dmae import calc_dmae

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    ckpts = [os.path.join(CKPT_DIR, f"seed{s}_best.ckpt") for s in MEMBER_SEEDS]
    serve_graphs = os.path.join(MESH_DIR, "serve_graphs.pkl")
    with open(serve_graphs, "wb") as f:
        pickle.dump(make_corpus(200, seed=2024)[:MESH_SERVE_TIER], f)
    model_cfg, train_cfg, paths, buckets = setup
    mesh_train_cfg = {**train_cfg, "max_iters": MESH_TRAIN_ITERS}
    cfg_path = write_train_config("mesh_train_config",
                                  {**model_cfg, "packed_train": False, "use_pallas": True},
                                  mesh_train_cfg, paths, buckets)
    plan = dict(sample_argv=main_path["argv"] + ["--timestep_respacing",
                                                 str(main_path["respacing"])],
                meshes=list(MESH_SHAPES), train_cfg=cfg_path, ckpts=ckpts,
                serve_graphs=serve_graphs)
    # the one-process references: phase 4's samples; the train CLI and a served round here
    one_train = run_train_cli("mesh train, 1 process", cfg_path, mesh_train_cfg,
                              ["--dtype", "bfloat16"], "logs_mesh_one")
    svc = serve.SamplerService(ckpts, n_steps=5000, dtype="bfloat16", fused_score=True,
                               draft_respacing=625, max_batch=MESH_SERVE_TIER)
    with open(serve_graphs, "rb") as f:
        graphs8 = pickle.load(f)
    one_serve = [r["pos_gen"] for r in svc.generate(graphs8, quality="draft")]
    svc.close()
    del svc
    # one step of the 8-member packed ensemble in one process on the ranks' inputs
    from tsdiff_tpu_torch.diffusion.ensemble import PackedEnsemble
    from tsdiff_tpu_torch.diffusion.ensemble import load_members as load_ckpts

    batch, pos = kernel_batch(24, seed=MESH_STEP_SEED)
    ensemble = PackedEnsemble(load_ckpts(ckpts, torch.device("cuda"), torch.bfloat16,
                                         fused_score=True)[0])
    one_step = ensemble.step_fn(ensemble.prepare(batch))(pos).cpu().numpy()
    del ensemble, batch, pos
    torch.cuda.empty_cache()
    val_batches = len(PaddedBatchLoader(TSDataset(paths["val"]), train_cfg["batch_size"],
                                        bucket_sizes=buckets))
    one = main_path["samples"]
    batch_size = int(main_path["argv"][main_path["argv"].index("--batch_size") + 1])
    # the control of the samples' limit: the same command with another seed
    from tsdiff_tpu_torch.cli import sampling

    with open(sampling.main(plan["sample_argv"] + ["--save_dir", os.path.join(MESH_DIR, "seed"),
                                                   "--seed", "2023"]), "rb") as f:
        control = np.array([np.abs(g["pos_gen"] - o["pos_gen"]).max()
                            for g, o in zip(pickle.load(f), one)])
    print(f"[mesh] control: phase 4's command with --seed 2023 against phase 4's samples, max "
          f"|pos_gen difference| per reaction: min {control.min():.6g} A, 10th percentile "
          f"{np.percentile(control, 10):.6g}, median {np.median(control):.6g}")
    steps = main_path["steps"]
    L = model_cfg["encoder"]["num_convs"]
    result = {"b1": 0, "b3_fwd": 0, "b3_bwd": 0, "backends": []}
    if backends is None:
        backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2 else [])
    for backend in backends:
        t0 = time.monotonic()
        ranks = run_mesh_ranks(plan, backend)
        wall = time.monotonic() - t0
        result["backends"].append(backend)
        captured = backend == "nccl"
        print(f"[mesh {backend}] 2 ranks on {[r['device'] for r in ranks]}, the walk and the "
              f"steps {'captured in CUDA graphs' if captured else 'eager'}: {wall:.3f} s for "
              f"both ranks' programme")
        print(f"[mesh {backend}] seconds per part, per rank: {[r['seconds'] for r in ranks]}")
        # (b) one step of the score, then the sampling CLI
        for flag in MESH_SHAPES:
            dp, ens = (int(x) for x in flag.split(","))
            parts = [r[f"step_{flag}"] for r in ranks]
            scale = float(np.abs(one_step).max())
            errs = [float(np.abs(np.asarray(p["node_eq"], np.float32)
                                 - one_step[p["rows"][0]:p["rows"][1]]).max()) for p in parts]
            print(f"[mesh {backend}] one step of the packed ensemble's score, --mesh {flag} "
                  f"(rows per rank {[p['rows'] for p in parts]}, members per rank "
                  f"{[p['members'] for p in parts]}), bf16, {len(one_step)} reactions at N=24, "
                  f"against {len(ckpts)} members in one process on the same inputs: max abs "
                  f"difference per rank "
                  f"{errs} of max|ref| {scale:.6g} (limit: "
                  + ("0, bit for bit)" if ens == 1 else f"{MESH_STEP_RTOL} of it, f32 rounding "
                                                       f"of the member sum)"))
            if ens == 1 and any(e != 0.0 for e in errs):
                fail(f"[mesh {backend}] --mesh {flag}: one step's score differs from one "
                     f"process's")
            if ens > 1 and not max(errs) <= MESH_STEP_RTOL * scale:
                fail(f"[mesh {backend}] --mesh {flag}: one step's score differs from one "
                     f"process's by {max(errs):.6g}")
            with open(ranks[0][f"sample_{flag}"]["path"], "rb") as f:
                got = pickle.load(f)
            walks = sum(1 for i in range(0, len(got), batch_size)
                        for _ in range(got[i]["sampling_attempts"]))
            # the same command sorts alike: reaction i is phase 4's reaction i
            if [len(g["atom_type"]) for g in got] != [len(g["atom_type"]) for g in one]:
                fail(f"[mesh {backend}] --mesh {flag}: the samples are not phase 4's reactions")
            diffs = np.array([np.abs(g["pos_gen"] - o["pos_gen"]).max()
                              for g, o in zip(got, one)])
            dmae = np.array([calc_dmae(g["pos"], g["pos_gen"]) for g in got])
            dmae_one = np.array([calc_dmae(o["pos"], o["pos_gen"]) for o in one])
            graphs = 0
            found = re.findall(r"CUDA graphs recorded: (\d+)", ranks[0][f"sample_{flag}"]["log"])
            if found:
                graphs = int(found[-1])
            want_b1 = steps * walks + graphs
            side = [r[f"sample_{flag}"] for r in ranks]
            p90 = float(np.percentile(diffs, 90))
            print(f"[mesh {backend}] sampling CLI --mesh {flag} (dp={dp}, ens={ens}): "
                  f"{len(got)} samples in {walks} walks, wall per rank "
                  f"{[round(s['wall'], 3) for s in side]} s under torch.profiler; B1 by kernel "
                  f"name per rank {[s['b1'] for s in side]} (expected {want_b1}: {steps} per "
                  f"walk{', and each graph once more' if graphs else ''}), B5 "
                  f"{[s['b5'] for s in side]}; B1 calls per rank {[s['calls'] for s in side]} "
                  f"with members per call {[s['members'] for s in side]} (expected "
                  f"[{len(ckpts) // ens}]); against phase 4's one-process samples of the same "
                  f"command, "
                  f"max |pos_gen difference| per reaction: max {diffs.max():.6g} A, 90th "
                  f"percentile {p90:.6g} (limit "
                  + ("0, bit for bit" if ens == 1 else f"{MESH_WALK_P90}") +
                  f"), median {np.median(diffs):.6g}, {int((diffs == 0).sum())} of {len(diffs)} "
                  f"equal bit for bit; D-MAE mean {dmae.mean():.6f} against {dmae_one.mean():.6f}, "
                  f"|difference| {abs(dmae.mean() - dmae_one.mean()):.3g} (limit "
                  f"{MESH_DMAE_DELTA})")
            if any(s["b1"] != want_b1 or s["b5"] != 0 for s in side):
                fail(f"[mesh {backend}] --mesh {flag}: B1 did not run once per walk step")
            if any(s["members"] != [len(ckpts) // ens] for s in side):
                fail(f"[mesh {backend}] --mesh {flag}: B1 did not run on {len(ckpts) // ens} "
                     f"members")
            if not np.isfinite(diffs).all() or (diffs.max() if ens == 1 else p90) > (
                    0.0 if ens == 1 else MESH_WALK_P90):
                fail(f"[mesh {backend}] --mesh {flag}: the samples differ from the one-process "
                     f"run's (max {diffs.max():.6g} A, 90th percentile {p90:.6g} A)")
            if abs(dmae.mean() - dmae_one.mean()) > MESH_DMAE_DELTA:
                fail(f"[mesh {backend}] --mesh {flag}: D-MAE moved by "
                     f"{abs(dmae.mean() - dmae_one.mean()):.3g}")
            result["b1"] += sum(s["b1"] for s in side)
        # (c) training
        losses = []
        for r in ranks:
            losses.append([(kind, int(it), float(v)) for kind, it, v in re.findall(
                r"\[(Train|Validate)\] Iter (\d+) \| Loss (\S+)", r["train"]["log"])])
        want = [x for x in one_train["losses"]]
        rel = max(abs(a[2] - b[2]) / max(abs(b[2]), 1e-12)
                  for side in losses for a, b in zip(side, want))
        named = [r["train"]["named"] for r in ranks]
        ran_fwd, ran_bwd = MESH_TRAIN_ITERS + val_batches, MESH_TRAIN_ITERS
        print(f"[mesh {backend}] train CLI --multihost, dp=2 (batch {train_cfg['batch_size']}, "
              f"{train_cfg['batch_size'] // 2} rows per rank), use_pallas, bf16, "
              f"{MESH_TRAIN_ITERS} iterations: wall per rank "
              f"{[round(r['train']['wall'], 3) for r in ranks]} s under torch.profiler; "
              f"logged losses per rank {losses}, one process {want}: largest relative "
              f"difference {rel:.6g} (limit {CLI_LOSS_RTOL}); B3 by kernel name per rank "
              f"{named} (expected forward {ran_fwd} = {MESH_TRAIN_ITERS} train + {val_batches} "
              f"validation forwards, row and weight-gradient kernels {L} x {ran_bwd}"
              f"{', each graph once more' if captured else ''}); plain-version calls "
              f"{[r['train']['plain'] for r in ranks]}")
        if any([x[:2] for x in side] != [x[:2] for x in want] for side in losses):
            fail(f"[mesh {backend}] the 2-rank train CLI logged other lines than one process")
        if not rel <= CLI_LOSS_RTOL:
            fail(f"[mesh {backend}] the 2-rank losses differ from one process's by {rel:.6g}")
        if any(r["train"]["plain"] != [0, 0] for r in ranks):
            fail(f"[mesh {backend}] the plain stack ran on the mesh's training path")
        for n in named:
            fwd, rows, xty = (n["schnet_fwd_wg_kernel<true>"], n["schnet_bwd_rows_wg_kernel"],
                              n["schnet_bwd_xty_wg_kernel"])
            if captured:
                ok = fwd >= ran_fwd and rows >= L * ran_bwd and xty >= L * ran_bwd
            else:
                ok = (fwd, rows, xty) == (ran_fwd, L * ran_bwd, L * ran_bwd)
            if not ok or n["schnet_fwd_wg_kernel<false>"] != 0:
                fail(f"[mesh {backend}] B3's kernels by name {n} do not match the steps")
            result["b3_fwd"] += fwd
            result["b3_bwd"] += rows // L
        # (d) serving
        for flag in MESH_SHAPES:
            ens = int(flag.split(",")[1])
            got = [np.asarray(p, np.float32) for p in ranks[0][f"serve_{flag}"]]
            diffs = np.array([float(np.abs(a - b).max()) for a, b in zip(got, one_serve)])
            print(f"[mesh {backend}] served draft round, tier {MESH_SERVE_TIER}, --mesh {flag} "
                  f"(rank 0 batching, rank 1 in worker_loop; graphs recorded per rank "
                  f"{[r[f'served_graphs_{flag}'] for r in ranks]}): max |pos_gen difference| "
                  f"per request against the one-process service's round {diffs.tolist()} A "
                  f"(limit: " + ("0, bit for bit)" if ens == 1 else
                                 f"median {MESH_WALK_P90})"))
            if len(got) != MESH_SERVE_TIER or not np.isfinite(diffs).all() or (
                    diffs.max() != 0.0 if ens == 1 else np.median(diffs) > MESH_WALK_P90):
                fail(f"[mesh {backend}] --mesh {flag}: the 2-rank served round differs from one "
                     f"process's")
    if "nccl" not in backends:
        print(f"[mesh] NCCL with captured collectives not run here: this machine shows "
              f"{torch.cuda.device_count()} GPU, and NCCL takes one GPU per rank")
    else:
        print(f"[mesh] NCCL with captured collectives run here, ranks on 2 of "
              f"{torch.cuda.device_count()} GPUs")
    return result


LEGACY_DIR = os.path.join(ROOT, ".scratch", "chip_smoke_legacy")  # gitignored
#: configs/geodiff_legacy/qm9_default.yml's model and train blocks, written
#: out so that the script needs no PyYAML
#: (tests/test_torch_legacy_objective.py holds them equal to the file)
QM9_DEFAULT = {
    "model": {"type": "diffusion", "network": "dualenc", "hidden_dim": 128, "num_convs": 6,
              "num_convs_local": 4, "cutoff": 10.0, "mlp_act": "ReLU",
              "beta_schedule": "sigmoid", "beta_start": 1e-7, "beta_end": 2e-3,
              "num_diffusion_timesteps": 5000, "edge_order": 3, "edge_encoder": "mlp",
              "smooth_conv": False},
    "train": {"seed": 2021, "batch_size": 64, "val_freq": 5000, "log_freq": 1000,
              "max_iters": 3000000, "max_grad_norm": 10000.0, "anneal_power": 2.0,
              "optimizer": {"type": "adam", "lr": 1e-3, "weight_decay": 0.0, "beta1": 0.95,
                            "beta2": 0.999},
              "scheduler": {"type": "plateau", "min_lr": 2e-5, "factor": 0.6, "patience": 10}},
}
#: phase 12's sizes: molecules of the synthetic conformer corpus (train,
#: validation, test) with ``conformers`` each; the train runs' iterations and
#: validation interval; samples per test molecule (twice the conformers, as
#: COV/MAT scores 2 K); the diffusion walk's 5000 steps in ``respacing``
#: calls; the DSM walk's ``dsm_steps`` per level over ``sigma_respacing`` of
#: its 50 levels; the sampling batch; the known groups of the clustering
#: self-check
LEGACY_SIZES = dict(train=200, val=20, test=50, conformers=5, iters=40, val_freq=10,
                    samples=10, respacing=625, dsm_steps=20, sigma_respacing=10, batch=100,
                    groups=4)
#: the card's dual-encoder results against the port's on the CPU (of max|CPU|)
LEGACY_AGREE = 1e-4


def legacy_train_run(tag: str, cfg: dict, sizes: dict, device: str) -> dict:
    """The train CLI on the dual-encoder ``cfg`` (JSON): finite losses, the
    last validation loss below the first, a checkpoint, on CUDA every step a
    replay of its (kind, bucket) graph; its graphs/s."""
    import numpy as np

    from tsdiff_tpu_torch.cli import train as train_cli
    from tsdiff_tpu_torch.train import get_checkpoint_path

    path = os.path.join(LEGACY_DIR, f"{tag}.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    t0 = time.monotonic()
    log_dir = train_cli.main([path, "--logdir", os.path.join(LEGACY_DIR, "logs"),
                              "--device", device])
    wall = time.monotonic() - t0
    with open(os.path.join(log_dir, "log.txt")) as f:
        log = f.read()
    train = [float(v) for v in re.findall(r"\[Train\] Iter \d+ \| Loss (\S+)", log)]
    val = [float(v) for v in re.findall(r"\[Validate\] Iter \d+ \| Loss (\S+)", log)]
    tput = re.search(r"\| (\d+) graphs in (\S+) s \| (\S+) graphs/s", log)
    graphs = re.search(r"\[Train\] CUDA graphs \| recorded (\d+): .* \| replays (.*)", log)
    print(f"[legacy] {tag} train CLI: {sizes['iters']} iterations in {wall:.3f} s, train losses "
          f"{train}, validation losses {val}; "
          + (f"{float(tput.group(3)):.4f} graphs/s ({tput.group(1)} graphs in {tput.group(2)} s "
             f"after the first step, validations and checkpoints included)" if tput else "")
          + (f"; CUDA graphs recorded {graphs.group(1)}, replays {graphs.group(2)}"
             if graphs else ""))
    if len(val) != sizes["iters"] // sizes["val_freq"] or not np.isfinite(train + val).all():
        fail(f"legacy {tag}: non-finite or missing losses")
    if not val[-1] < val[0]:
        fail(f"legacy {tag}: the last validation loss {val[-1]} is not below the first {val[0]}")
    if tput is None or (device == "cuda" and graphs is None):
        fail(f"legacy {tag}: no throughput line, or the steps were not replayed from graphs")
    ckpt, _ = get_checkpoint_path(os.path.join(log_dir, "checkpoints"))
    return dict(ckpt=ckpt, val=val, graphs_per_s=float(tput.group(3)), wall=wall)


def legacy_steps(model_cfg: dict, graphs: list, device: str, steps: int = 5) -> dict:
    """The dual encoder's train step on one batch of ``graphs`` (the largest
    bucket), eager and replayed from its CUDA graph (``train/captured.py``),
    from one seeded initialisation in lockstep: before every step the
    captured run takes the eager run's state, in place; its first step runs
    eagerly and records, the later ones replay.  Every step's loss equal
    bit for bit (the forward has no atomics), the parameters after it
    within 1e-5 of max|param| (F.embedding's backward sums with float
    atomics); then ms per step of each (medians of five timings of 10)."""
    import torch

    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.core.graph import from_numpy_graphs
    from tsdiff_tpu_torch.diffusion.objective import draw_timesteps_and_noise
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from tsdiff_tpu_torch.models import get_model
    from tsdiff_tpu_torch.train import (get_objective, init_train_state, make_optimizer,
                                        make_train_step)
    from tsdiff_tpu_torch.train.captured import StepGraphs
    from tsdiff_tpu_torch.train.trainer import on_device

    cfg = Config(model_cfg)
    schedule = DiffusionSchedule.from_config(cfg)
    n = max(len(g["atom_type"]) for g in graphs)
    batch = from_numpy_graphs(graphs, max_nodes=-(-n // 8) * 8, device=device)
    lr = torch.tensor(1e-4, device=device)
    runs = {}
    for name in ("eager", "captured"):
        model = get_model(cfg, generator=torch.Generator().manual_seed(0)).to(device)
        tx = make_optimizer(Config(QM9_DEFAULT["train"]["optimizer"]),
                            QM9_DEFAULT["train"]["max_grad_norm"])
        state = on_device(init_train_state(model, tx))
        step = make_train_step(model, tx, schedule, anneal_power=2.0)
        runs[name] = dict(state=state, fn=(lambda step, state: lambda b, t, noise: step(
            state, b, lr, t=t, noise=noise)[1])(step, state))
    _, (lo, hi) = get_objective(model, schedule)
    gen = torch.Generator(device=device).manual_seed(0)
    t, noise = draw_timesteps_and_noise(gen, batch.pos.shape, lo, hi, device)
    eager = lambda: runs["eager"]["fn"](batch, t, noise)  # noqa: E731
    if device != "cuda":
        t0 = time.monotonic()
        eager()
        return dict(eager_ms=(time.monotonic() - t0) * 1e3, captured_ms=None)

    graphs_ = StepGraphs(device)
    key = ("train", batch.pos.shape[1])
    captured = lambda: graphs_(key, runs["captured"]["fn"], batch, t, noise)  # noqa: E731
    losses, worst = [], 0.0
    for _ in range(steps):
        with torch.no_grad():
            ref = state_tensors(runs["eager"]["state"])
            for k, v in state_tensors(runs["captured"]["state"]).items():
                v.copy_(ref[k])
        m_e, m_c = eager(), captured()
        got, ref = state_tensors(runs["captured"]["state"]), state_tensors(runs["eager"]["state"])
        worst = max(worst, max(float((got[k] - ref[k]).abs().max()) /
                               max(float(ref[k].abs().max()), 1e-30)
                               for k in ref if k.startswith("param")))
        losses.append((float(m_e["loss"]), float(m_c["loss"])))
    same = all(a == b for a, b in losses[1:])
    print(f"[legacy] {model_cfg['type']} train step in lockstep, eager against its CUDA graph "
          f"({steps} steps, the first recording, then {graphs_.replays[key]} replays): losses "
          f"{losses}, equal bit for bit on the replays: {same}; parameters after a step within "
          f"{worst:.3g} of max|param|")
    if not same or worst > 1e-5 or graphs_.replays[key] != steps - 1:
        fail(f"legacy {model_cfg['type']}: the captured train step is not the eager step")
    return dict(eager_ms=cuda_time_ms(eager, 10)[0], captured_ms=cuda_time_ms(captured, 10)[0])


def legacy_agreement(model_cfg: dict, graphs: list, device: str) -> float:
    """The card's ``make_dual_eps_fn`` and both losses against the port's on
    the CPU: weights, inputs and draws injected (seeded), for ``TS`` false and
    true and a ``smooth_conv`` copy (as drugs_default), each as a diffusion
    and a DSM model.  Returns the largest error over max|CPU|."""
    import copy

    import numpy as np
    import torch

    from tsdiff_tpu_torch.chem import NUM_BOND_TYPES
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.core.graph import from_numpy_graphs
    from tsdiff_tpu_torch.diffusion.dual_objective import (dual_diffusion_loss, dual_dsm_loss,
                                                           make_dual_eps_fn)
    from tsdiff_tpu_torch.diffusion.objective import draw_timesteps_and_noise
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from tsdiff_tpu_torch.models import get_model

    worst = 0.0
    n = -(-max(len(g["atom_type"]) for g in graphs) // 8) * 8
    for name, extra in (("TS false", {}), ("TS true", {"TS": True}),
                        ("smooth_conv", {"smooth_conv": True, "beta_end": 9e-3})):
        gs = [dict(g) for g in graphs]
        if extra.get("TS"):   # a reaction's condensed codes r * 22 + p: one bond broken
            for g in gs:
                ei = np.asarray(g["edge_index"])
                code = np.asarray(g["edge_type"]) * (NUM_BOND_TYPES + 1)
                a, b = ei[:, 0]
                broken = ((ei[0] == a) & (ei[1] == b)) | ((ei[0] == b) & (ei[1] == a))
                code[broken] = code[broken] // (NUM_BOND_TYPES + 1) * NUM_BOND_TYPES
                g["edge_type"] = code
        cpu_b = from_numpy_graphs(gs, max_nodes=n)
        dev_b = from_numpy_graphs(gs, max_nodes=n, device=device)
        gen = torch.Generator().manual_seed(5)
        for kind in ("diffusion", "dsm"):
            cfg = Config({**model_cfg, **extra, "type": kind})
            cpu_m = get_model(cfg, generator=torch.Generator().manual_seed(6)).eval()
            dev_m = copy.deepcopy(cpu_m).to(device)
            levels = 50 if kind == "dsm" else cfg.num_diffusion_timesteps
            t, noise = draw_timesteps_and_noise(gen, cpu_b.pos.shape, 0, levels)
            pos = cpu_b.pos + 0.3 * torch.randn(cpu_b.pos.shape, generator=gen)
            pos = pos * cpu_b.node_mask[..., None]
            outs = []
            for m, b in ((cpu_m, cpu_b), (dev_m, dev_b)):
                dv = b.pos.device
                with torch.no_grad():
                    eps = make_dual_eps_fn(m, b, clip=1000.0)(
                        pos.to(dv), torch.tensor(1.0, device=dv), time_step=t.to(dv))
                    if kind == "dsm":
                        loss = dual_dsm_loss(m, b, t=t.to(dv), noise=noise.to(dv))[0]
                    else:
                        loss = dual_diffusion_loss(m, DiffusionSchedule.from_config(cfg), b,
                                                   t=t.to(dv), noise=noise.to(dv))[0]
                outs.append((eps.cpu(), loss.cpu()))
            for what, i in (("make_dual_eps_fn", 0), (f"{kind} loss", 1)):
                ref, got = outs[0][i], outs[1][i]
                err = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
                worst = max(worst, err)
                print(f"[legacy] {name}, {kind} model: {what} on {device} against the CPU: "
                      f"max|CPU| {float(ref.abs().max()):.6g}, max err / max|CPU| {err:.3g} "
                      f"(limit {LEGACY_AGREE})")
                if not (err <= LEGACY_AGREE and torch.isfinite(got).all()):
                    fail(f"legacy {name} {kind}: {what} on {device} disagrees with the CPU")
    return worst


def legacy_sample(tag: str, ckpt: str, test_set: str, sizes: dict, device: str,
                  extra: list) -> tuple[list, dict]:
    """The sampling CLI on a dual-encoder checkpoint, ``samples`` per test
    molecule: finite, no walk flagged NaN, on CUDA every walk captured;
    ``(results, numbers)`` with ms per walk step and samples/s."""
    import numpy as np

    from tsdiff_tpu_torch.cli import sampling

    save_dir = os.path.join(LEGACY_DIR, f"gen_{tag}")
    t0 = time.monotonic()
    path = sampling.main([ckpt, "--test_set", test_set, "--save_dir", save_dir,
                          "--device", device, "--repeat", str(sizes["samples"]),
                          "--batch_size", str(sizes["batch"]), "--sort_by_size", *extra])
    wall = time.monotonic() - t0
    with open(path, "rb") as f:
        results = pickle.load(f)
    attempts = [results[i]["sampling_attempts"] for i in range(0, len(results), sizes["batch"])]
    steps = int(extra[extra.index("--n_steps") + 1])
    if "--timestep_respacing" in extra:
        steps = int(extra[extra.index("--timestep_respacing") + 1])
    if "--sigma_respacing" in extra:
        steps *= int(extra[extra.index("--sigma_respacing") + 1])
    walk_steps = steps * sum(attempts)
    recorded = cli_graphs(save_dir)[0] if device == "cuda" else 0
    numbers = dict(wall=wall, walk_steps=walk_steps, ms_per_step=wall * 1e3 / walk_steps,
                   samples_per_s=len(results) / wall, graphs=recorded)
    print(f"[legacy] {tag} sampling CLI {' '.join(extra)}: {len(results)} samples in "
          f"{wall:.3f} s (checkpoint and test set loaded, sampled, written), attempts {attempts}, "
          f"{walk_steps} walk steps ({numbers['ms_per_step']:.3f} ms per step, "
          f"{numbers['samples_per_s']:.3f} samples/s), CUDA graphs recorded {recorded}")
    if any(a != 1 for a in attempts) or any(r.get("nan_persisted") for r in results):
        fail(f"legacy {tag}: a walk flagged NaN")
    if not all(np.isfinite(r["pos_gen"]).all() and r["pos_gen"].shape == (len(r["atom_type"]), 3)
               for r in results):
        fail(f"legacy {tag}: non-finite or misshaped samples")
    if device == "cuda" and recorded == 0:
        fail(f"legacy {tag}: the walk was not captured")
    return results, numbers


def legacy_walk_equal(tag: str, ckpt: str, graphs: list, device: str, extra: list) -> None:
    """The sampling CLI's walk replayed from its CUDA graphs against the
    same command run eagerly (``main(argv, capture=False)``) on ``graphs``,
    one batch: the samples equal bit for bit."""
    import numpy as np

    from tsdiff_tpu_torch.cli import sampling
    from tsdiff_tpu_torch.data import save_dataset

    test_set = os.path.join(LEGACY_DIR, f"walk_{tag}.pkl")
    save_dataset(test_set, graphs)
    out = {}
    for capture in (True, False):
        argv = [ckpt, "--test_set", test_set, "--device", device, "--repeat", "5",
                "--batch_size", str(5 * len(graphs)), *extra,
                "--save_dir", os.path.join(LEGACY_DIR, f"walk_{tag}_{capture}")]
        t0 = time.monotonic()
        with open(sampling.main(argv, capture=capture), "rb") as f:
            out[capture] = ([r["pos_gen"] for r in pickle.load(f)], time.monotonic() - t0)
    same = all(np.array_equal(a, b) for a, b in zip(out[True][0], out[False][0]))
    print(f"[legacy] {tag} walk, {len(out[True][0])} samples in one batch: replayed from CUDA "
          f"graphs {out[True][1]:.3f} s, eager {out[False][1]:.3f} s; samples equal bit for "
          f"bit: {same}")
    if not same:
        fail(f"legacy {tag}: the captured walk differs from the eager one")


def phase_legacy(smi: str, device: str = "cuda", sizes: dict = LEGACY_SIZES) -> dict:
    """Phase 12: the GeoDiff-legacy family on the card, at the full width of
    configs/geodiff_legacy/qm9_default.yml (H=128, 6 SchNet blocks, 4 GIN
    layers, edge order 3, cutoff 10 A, batch 64, f32) on a synthetic
    conformer corpus of 9-29 atoms: both objectives through the train CLI,
    the card against the CPU, both walks through the sampling CLI, the
    clustering CLI and COV/MAT through the evaluate CLI, with their
    self-checks.  ``device="cpu"`` and smaller ``sizes`` rehearse it on
    the CPU."""
    import numpy as np

    from tsdiff_tpu_torch.cli import clustering as clustering_cli
    from tsdiff_tpu_torch.cli import evaluate as evaluate_cli
    from tsdiff_tpu_torch.data import save_dataset
    from tsdiff_tpu_torch.data.synthetic import (conformers_of, make_conformer_corpus,
                                                 make_molecule)
    from tsdiff_tpu_torch.eval.clustering import cluster_conformers
    from tsdiff_tpu_torch.eval.covmat import CovMatEvaluator

    t_phase = time.monotonic()
    shutil.rmtree(LEGACY_DIR, ignore_errors=True)
    os.makedirs(LEGACY_DIR)
    K = sizes["conformers"]
    corpus = {name: make_conformer_corpus(sizes[name], seed=seed, conformers=K)
              for name, seed in (("train", 61), ("val", 62), ("test", 63))}
    paths = {name: os.path.join(LEGACY_DIR, f"{name}.pkl") for name in ("train", "val")}
    for name in ("train", "val"):
        save_dataset(paths[name], corpus[name])
    test_set = os.path.join(LEGACY_DIR, "test.pkl")
    save_dataset(test_set, corpus["test"][::K])   # one graph per test molecule
    n_atoms = [len(g["atom_type"]) for g in corpus["train"][::K]]
    print(f"[legacy] {smi}: synthetic conformer corpus, {sizes['train']} + {sizes['val']} + "
          f"{sizes['test']} molecules of {min(n_atoms)}-{max(n_atoms)} atoms (train), {K} "
          f"conformers each; qm9_default at full width: {QM9_DEFAULT['model']}")

    train = {**QM9_DEFAULT["train"], "max_iters": sizes["iters"], "val_freq": sizes["val_freq"],
             "log_freq": sizes["val_freq"]}
    dataset = {"train": paths["train"], "val": paths["val"]}
    runs = {}
    for kind in ("diffusion", "dsm"):
        cfg = {"model": {**QM9_DEFAULT["model"], "type": kind}, "train": train, "dataset": dataset}
        runs[kind] = legacy_train_run(kind, cfg, sizes, device)
        runs[kind].update(legacy_steps(cfg["model"], corpus["train"][-train["batch_size"]:],
                                       device))
        eager, captured = runs[kind]["eager_ms"], runs[kind]["captured_ms"]
        print(f"[legacy] {smi}: {kind} train step, batch {train['batch_size']} of the largest "
              f"bucket: {eager:.3f} ms eager, "
              + (f"{captured:.3f} ms replayed from its CUDA graph" if captured else
                 "not captured (CPU)"))

    agree = legacy_agreement(QM9_DEFAULT["model"], corpus["test"][: 16 * K: K], device)

    diffusion, dnum = legacy_sample("diffusion", runs["diffusion"]["ckpt"], test_set, sizes,
                                    device, ["--sampling_type", "ld", "--n_steps", "5000",
                                             "--timestep_respacing", str(sizes["respacing"])])
    _, snum = legacy_sample("dsm", runs["dsm"]["ckpt"], test_set, sizes, device,
                            ["--n_steps", str(sizes["dsm_steps"]),
                             "--sigma_respacing", str(sizes["sigma_respacing"])])

    walk_graphs = corpus["test"][: 4 * K: K]
    legacy_walk_equal("diffusion", runs["diffusion"]["ckpt"], walk_graphs, device,
                      ["--n_steps", "5000", "--timestep_respacing", str(sizes["respacing"])])
    legacy_walk_equal("dsm", runs["dsm"]["ckpt"], walk_graphs, device,
                      ["--n_steps", str(sizes["dsm_steps"]),
                       "--sigma_respacing", str(sizes["sigma_respacing"])])

    printed = io.StringIO()
    clu_dir = os.path.join(LEGACY_DIR, "clustering")
    with contextlib.redirect_stdout(printed):
        clustering_cli.main(["--sample_path", os.path.join(LEGACY_DIR, "gen_diffusion",
                                                           "samples_all.pkl"),
                             "--sample_index", "0", "--save_dir", clu_dir])
    with open(os.path.join(clu_dir, "stat_clustering.pkl"), "rb") as f:
        n_clusters = pickle.load(f)["num_clusters"]
    xyz = sorted(f for f in os.listdir(clu_dir) if f.endswith(".xyz"))
    print(f"[legacy] clustering CLI on sample 0's molecule: {n_clusters} clusters, {len(xyz)} "
          f"xyz files; " + " / ".join(printed.getvalue().strip().splitlines()))
    if n_clusters < 1 or len(xyz) != n_clusters:
        fail("legacy: the clustering CLI wrote no clusters")

    # COV/MAT: the generated conformers grouped by smiles with the test
    # molecule's reference stack, as the evaluate CLI's --covmat takes them
    refs = {g["smiles"]: [] for g in corpus["test"]}
    for g in corpus["test"]:
        refs[g["smiles"]].append(g["pos"])
    gen = {}
    for r in diffusion:
        gen.setdefault(r["smiles"], []).append(r["pos_gen"])
    packed = [dict(g, pos_ref=np.stack(refs[g["smiles"]]), pos_gen=np.stack(gen[g["smiles"]]))
              for g in corpus["test"][::K]]
    covmat_path = os.path.join(LEGACY_DIR, "covmat.pkl")
    with open(covmat_path, "wb") as f:
        pickle.dump(packed, f)
    printed = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(printed):
        stats = evaluate_cli.main(["--samples", covmat_path, "--covmat"])
    cm = stats["covmat"]
    th = list(np.round(cm.thresholds, 2))
    at = {t: th.index(t) for t in (0.5, 1.0, 1.25)}
    summary = ", ".join(f"COV-R@{t} {cm.CoverageR[:, k].mean():.4f} COV-P@{t} "
                        f"{cm.CoverageP[:, k].mean():.4f}" for t, k in at.items())
    print(f"[legacy] evaluate CLI --covmat on {len(packed)} molecules ({K} reference and "
          f"{2 * K} generated conformers each) in {time.monotonic() - t0:.3f} s: {summary}; "
          f"MAT-R {cm.MatchingR.mean():.4f} A, MAT-P {cm.MatchingP.mean():.4f} A (mean)")
    if cm.CoverageR.shape[0] != len(packed) or not np.isfinite(cm.MatchingR).all():
        fail("legacy: COV/MAT did not score every molecule")

    quiet = lambda *_: None  # noqa: E731
    self_cov = CovMatEvaluator(num_workers=1, print_fn=quiet)(
        [dict(p, pos_gen=np.concatenate([p["pos_ref"], p["pos_ref"]])) for p in packed])
    cov_one = bool((self_cov.CoverageR == 1).all() and (self_cov.CoverageP == 1).all())
    mat = max(self_cov.MatchingR.max(), self_cov.MatchingP.max())
    rng = np.random.default_rng(64)
    mol = make_molecule(rng, 0)
    confs = []
    for _ in range(sizes["groups"]):
        base = dict(mol, pos=mol["pos"] + rng.normal(scale=0.8, size=mol["pos"].shape))
        confs += [c["pos"] for c in conformers_of(rng, base, 4, scale=0.005)]
    found = cluster_conformers(confs, [tuple(range(len(mol["atom_type"])))], 0.1)["num_clusters"]
    print(f"[legacy] self-checks: the reference stacks against themselves COV 1.0 at every "
          f"threshold {cov_one}, MAT {mat:.3g} (limit 1e-6); {sizes['groups']} known groups of "
          f"4 conformers: {found} clusters")
    if not (cov_one and mat < 1e-6):
        fail("legacy: COV/MAT of the references against themselves is not 1.0 / 0")
    if found != sizes["groups"]:
        fail(f"legacy: cluster_conformers found {found} clusters for {sizes['groups']} groups")

    wall = time.monotonic() - t_phase
    print(f"[legacy] {smi}: phase 12 wall {wall:.3f} s; train diffusion "
          f"{runs['diffusion']['graphs_per_s']:.4f} graphs/s, dsm {runs['dsm']['graphs_per_s']:.4f}"
          f" graphs/s; sampling diffusion {dnum['ms_per_step']:.3f} ms/step "
          f"{dnum['samples_per_s']:.3f} samples/s, dsm {snum['ms_per_step']:.3f} ms/step "
          f"{snum['samples_per_s']:.3f} samples/s; card against CPU {agree:.3g} of max|CPU|")
    return dict(runs=runs, agree=agree, diffusion=dnum, dsm=snum, clusters=n_clusters,
                covmat=cm, wall=wall)


PROTEIN_DIR = os.path.join(ROOT, ".scratch", "chip_smoke_protein")  # gitignored
#: configs/protein_sidechain.yml's blocks, written out so that the script
#: needs no PyYAML (tests/test_torch_protein.py holds them equal to the file)
PROTEIN_SIDECHAIN = {
    "model": {"type": "dsm", "network": "dualenc", "hidden_dim": 128, "num_convs": 4,
              "num_convs_local": 4, "cutoff": 10.0, "mlp_act": "relu", "edge_encoder": "mlp",
              "edge_order": 3, "smooth_conv": False, "sigma_begin": 2.0, "sigma_end": 0.01,
              "num_noise_level": 50, "beta_schedule": "sigmoid", "beta_start": 1e-7,
              "beta_end": 2e-3, "num_diffusion_timesteps": 5000},
    "train": {"seed": 2021, "batch_size": 32, "val_freq": 1000, "log_freq": 100,
              "max_iters": 200000, "max_grad_norm": 3000.0, "anneal_power": 2.0,
              "ema_decay": 0.999,
              "optimizer": {"type": "adam", "lr": 1e-3, "weight_decay": 0.0, "beta1": 0.95,
                            "beta2": 0.999},
              "scheduler": {"type": "plateau", "factor": 0.6, "patience": 10,
                            "min_lr": 1e-4}},
    "dataset": {"type": "sidechain", "cutoff": 10.0, "subgraphs_per_protein": 50},
}
#: phase 13's sizes: residues per synthetic protein (``compact_protein_pdb``),
#: proteins to train on; the train run's batch, subgraphs per protein,
#: iterations, validation interval and node buckets (10-A balls of 90-400
#: atoms); the sampling run's sigma levels (``--sigma_respacing``) and steps
#: per level; the proteins' residues for the card-against-CPU eps; the
#: gate's iterations, its model seeds and its sampling seeds (the JAX
#: gate's 7 first).  The batch: through the captured train CLI with these
#: buckets, protein_sidechain.yml's 32 and 16 run out of the card's 80 GB
#: (16: 52.14 GiB in the CUDA graphs' pool when the N=400 bucket's eager
#: first step asked for more), 8 peaks at 22.98 GB (PERF.md, PR 17).
PROTEIN_SIZES = dict(residues=128, train_proteins=3, batch=8, subgraphs=24, iters=40,
                     val_freq=20, buckets=(128, 192, 256, 320, 400), sigma_respacing=5,
                     n_steps=10, agree_residues=24, gate_iters=4000, gate_models=(0, 1),
                     gate_seeds=(7, 8, 9, 10, 11, 12))
#: the seed of the full-width model's initialisation whose walks phase 13a
#: compares (captured with eager, dp=2 with one process) and whose eps it
#: holds to the CPU: deterministic weights, where a trained checkpoint's
#: differ from run to run
PROTEIN_INIT_SEED = 13
#: their step: at the CLI's default 1e-6 the seeded model's walk flags NaN
#: (an untrained score; my chip run 13, PR 17), at 1e-7 it stays finite
PROTEIN_INIT_STEP_LR = 1e-7
#: one ``accumulate_protein_eps`` on the card against the CPU, full width from
#: the seeded initialisation (of max|CPU|)
PROTEIN_AGREE = 1e-6
#: the JAX protein gate's configuration and its calibration point
#: (tests/test_protein_gate.py, artifacts/protein_calibration.json)
GATE_CFG = dict(network="dualenc", hidden_dim=64, num_convs=3, num_convs_local=3, cutoff=10.0,
                mlp_act="relu", beta_schedule="sigmoid", beta_start=1e-7, beta_end=2e-3,
                num_diffusion_timesteps=50, edge_order=3, edge_encoder="mlp",
                smooth_conv=False, type="dsm", sigma_begin=2.0, sigma_end=0.01,
                num_noise_level=10)
GATE_CALIBRATION = dict(rmsd=2.71, chi1=0.64, gplus=0.64, circ_R=0.71)


def protein_graphs(seeds, residues: int) -> list:
    from tsdiff_tpu_torch.data.pdb import pdb_to_graph
    from tsdiff_tpu_torch.data.synthetic import compact_protein_pdb

    return [pdb_to_graph(compact_protein_pdb(residues, seed=s), name=f"compact{s}")
            for s in seeds]


def protein_walk_ms(ckpt: str, graph: dict, sizes: dict, device: str) -> dict:
    """ms per walk step of the first covering batch (8 subgraphs), replayed
    from its CUDA graph and eager: each the median of three rounds after one
    that records or warms up."""
    import numpy as np
    import torch

    from tsdiff_tpu_torch.diffusion.captured import WalkRunner
    from tsdiff_tpu_torch.diffusion.ensemble import DualEnsemble, load_members
    from tsdiff_tpu_torch.diffusion.protein import covering_batches, protein_walk
    from tsdiff_tpu_torch.diffusion.sampler import SamplingSettings

    (model,), _ = load_members([ckpt], device, torch.float32)
    _, batch = next(covering_batches(graph, 10.0, 8, 2022, device=device))
    walk = protein_walk(model, 1000.0, n_steps=sizes["n_steps"], step_lr=PROTEIN_INIT_STEP_LR,
                        sigma_respacing=sizes["sigma_respacing"])
    out = {}
    for capture in ((True, False) if device == "cuda" else (False,)):
        runner = WalkRunner(DualEnsemble([model], protein=True), None, SamplingSettings(),
                            capture, None, step_draws=True, walk=walk)
        times = []
        for r in range(4):
            gen = torch.Generator(device=device).manual_seed(r)
            pos_init = torch.randn(batch.pos.shape, generator=gen, device=device)
            t0 = time.monotonic()
            runner.run(batch, pos_init, gen)
            times.append((time.monotonic() - t0) * 1e3 / runner.n_walk)
        out["captured" if capture else "eager"] = float(np.median(times[1:]))
    return dict(out, n_walk=walk.n_walk, n_pad=batch.pos.shape[1])


def protein_agreement(ckpt: str, graph: dict, device: str) -> float:
    """One ``accumulate_protein_eps`` on ``graph`` on the card against the
    port on the CPU, f32, TF32 off, at level 10, with protein_sidechain.yml's
    model at full width from its seeded initialisation (the check: within
    ``PROTEIN_AGREE`` of max|CPU|), then with the phase's trained checkpoint
    (printed: its weights differ from run to run, as the card's training is
    not bitwise reproducible); returns the first error over max|CPU|."""
    import copy

    import torch

    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.diffusion.dual_objective import accumulate_protein_eps
    from tsdiff_tpu_torch.diffusion.ensemble import load_members
    from tsdiff_tpu_torch.models import get_model

    init = get_model(Config(PROTEIN_SIDECHAIN["model"]),
                     generator=torch.Generator().manual_seed(PROTEIN_INIT_SEED)).eval()
    trained, _ = load_members([ckpt], "cpu", torch.float32)
    errs = {}
    for tag, cpu_model in (("initialised", init), ("trained", trained[0])):
        out = {}
        for dev, model in (("cpu", cpu_model), (device, copy.deepcopy(cpu_model).to(device))):
            t0 = time.monotonic()
            out[dev] = accumulate_protein_eps(model, graph, time_step=10, cutoff=10.0,
                                              batch_size=8)
            out[dev + "_s"] = time.monotonic() - t0
        (ref, rc), (got, gc) = out["cpu"], out[device]
        errs[tag] = float(abs(got - ref).max()) / max(float(abs(ref).max()), 1e-30)
        print(f"[protein] accumulate_protein_eps, {tag} weights, on {len(graph['atom_type'])} "
              f"atoms ({int((rc > 0).sum())} covered, up to {int(rc.max())} subgraphs each), "
              f"level 10: {device} {out[device + '_s']:.3f} s against the CPU "
              f"{out['cpu_s']:.3f} s; max|CPU| {float(abs(ref).max()):.6g}, max err / max|CPU| "
              f"{errs[tag]:.3g}" + (f" (limit {PROTEIN_AGREE})" if tag == "initialised" else ""))
        if not (rc == gc).all():
            fail("[protein] accumulate_protein_eps covered other atoms on the card")
    if not errs["initialised"] <= PROTEIN_AGREE:
        fail("[protein] accumulate_protein_eps on the card disagrees with the CPU")
    return errs["initialised"]


def protein_sample(tag: str, ckpt: str, protein_set: str, flags: list, device: str,
                   capture: bool = True, complete: bool = False) -> tuple[list, float]:
    """The protein_sampling CLI: ``(results, wall s)``; every backbone atom
    exactly its input and every position finite (a subgraph whose walk is
    NaN is skipped: its atoms keep their input and count 0).  ``complete``:
    a walk to compare with another, so no NaN flag and every sidechain atom
    scored."""
    import numpy as np

    from tsdiff_tpu_torch.cli import protein_sampling

    t0 = time.monotonic()
    path = protein_sampling.main([ckpt, "--protein_set", protein_set, "--device", device,
                                  "--save_dir", os.path.join(PROTEIN_DIR, f"gen_{tag}"),
                                  *flags], capture=capture)
    wall = time.monotonic() - t0
    with open(path, "rb") as f:
        results = pickle.load(f)
    for r in results:
        sc = np.asarray(r["is_sidechain"], bool)
        if not np.array_equal(r["pos_gen"][~sc], r["pos_gt"][~sc]):
            fail(f"[protein] {tag}: the backbone of pos_gen differs from the input")
        if not np.isfinite(r["pos_gen"]).all():
            fail(f"[protein] {tag}: a position is not finite")
        if complete and (r["nan"] or not (np.asarray(r["coverage_counts"])[sc] > 0).all()):
            fail(f"[protein] {tag}: the walk flagged a NaN or left a sidechain atom unscored")
    return results, wall


def protein_mesh(ckpt: str, protein_set: str, flags: list, ref: list) -> None:
    """Phase 13c: the protein_sampling CLI at dp=2, two Gloo ranks on one
    card, against one process (``ref``) bit for bit."""
    import numpy as np

    d = os.path.join(PROTEIN_DIR, "mesh")
    os.makedirs(d, exist_ok=True)
    port = free_port()
    env = dict(os.environ, TSDIFF_DIST_TIMEOUT_S="300")
    logs = [open(os.path.join(d, f"rank{r}.log"), "w") for r in range(2)]
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tsdiff_tpu_torch.cli.protein_sampling", ckpt, "--protein_set",
         protein_set, "--save_dir", os.path.join(d, f"gen{r}"), "--device", "cuda", *flags,
         "--mesh", "2", "--dist_backend", "gloo", "--multihost", "--coordinator",
         f"127.0.0.1:{port}", "--nprocs", "2", "--procid", str(r)],
        stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env) for r, log in enumerate(logs)]
    try:
        for p in procs:
            p.wait(timeout=MESH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        fail("[protein mesh] the ranks did not finish")
    finally:
        for log in logs:
            log.close()
    wall = time.monotonic() - t0
    if any(p.returncode for p in procs):
        with open(os.path.join(d, "rank0.log")) as f:
            fail(f"[protein mesh] a rank failed:\n{f.read()[-3000:]}")
    with open(os.path.join(d, "gen0", "proteins_gen.pkl"), "rb") as f:
        got = pickle.load(f)
    same = len(got) == len(ref) and all(
        np.array_equal(a["pos_gen"], b["pos_gen"])
        and np.array_equal(a["coverage_counts"], b["coverage_counts"]) for a, b in zip(got, ref))
    worst = max(float(np.abs(a["pos_gen"] - b["pos_gen"]).max()) for a, b in zip(got, ref))
    wrote1 = os.path.exists(os.path.join(d, "gen1", "proteins_gen.pkl"))
    print(f"[protein mesh] protein_sampling at dp=2, two Gloo ranks on one card: {wall:.3f} s "
          f"(processes started, eager walks); against one process: equal bit for bit {same} "
          f"(max |diff| {worst:.3g} A); rank 1 wrote nothing: {not wrote1}")
    if not same or wrote1:
        fail("[protein mesh] dp=2 differs from one process, or rank 1 wrote results")


def mirror_chi1(pos_gen, pos_gt, graph, coverage_counts=None) -> tuple:
    """chi1 read modulo the reflection through the gate chains' backbone
    plane: ``(hits, gauche, angles)`` over the coverage-filtered chi1 quads
    (as ``chi1_accuracy`` filters them), each angle taken as |chi1|, a hit
    within 40 degrees of the reference's |chi1|, gauche when nearer 60 than
    180 degrees; ``angles`` the generated |chi1| in degrees."""
    import numpy as np

    from tsdiff_tpu_torch.eval.protein import angular_diff_deg, chi1_quads, dihedral_deg

    quads = chi1_quads(graph)
    if coverage_counts is not None and len(quads):
        cov = np.asarray(coverage_counts)
        quads = quads[(cov[quads[:, 2]] > 0) & (cov[quads[:, 3]] > 0)]
    if len(quads) == 0:
        return 0, 0, np.zeros(0)
    gen = np.abs(dihedral_deg(pos_gen, quads))
    ref = np.abs(dihedral_deg(pos_gt, quads))
    hits = int((angular_diff_deg(gen, ref) <= 40.0).sum())
    gauche = int((angular_diff_deg(gen, 60.0) < angular_diff_deg(gen, 180.0)).sum())
    return hits, gauche, gen


def _gate_metrics(results) -> dict:
    """``tests/test_protein_gate.py::_metrics_from_results``: mean covered
    sidechain RMSD, coverage-filtered chi1 accuracy and its count, the
    aggregated rotamer distribution's g+ share and circular resultant; and
    the same three read modulo the backbone plane's reflection
    (``mirror_chi1``: ``m_chi1``, ``m_gauche``, ``m_circ_R``)."""
    import numpy as np

    from tsdiff_tpu_torch.eval.protein import chi1_accuracy, rotamer_distribution

    rms, hits, ntot = [], 0.0, 0
    z_sum, n_rot, wells = 0.0 + 0.0j, 0, {}
    m_hits, m_gauche, m_angles = 0, 0, []
    for r in results:
        sc = np.asarray(r["is_sidechain"], bool)
        cov = np.asarray(r["coverage_counts"])[sc] > 0
        d = np.asarray(r["pos_gen"])[sc][cov] - np.asarray(r["pos_gt"])[sc][cov]
        # a diverged walk scores no atom: its RMSD is NaN, as the JAX gate's
        rms.append(float(np.sqrt((d ** 2).sum(-1).mean())) if cov.any() else float("nan"))
        acc, n = chi1_accuracy(r["pos_gen"], r["pos_gt"], r, coverage_counts=r["coverage_counts"])
        if n:
            hits += acc * n
            ntot += n
        rot = rotamer_distribution(r["pos_gen"], r, coverage_counts=r["coverage_counts"])
        if rot["n"]:
            z_sum += rot["circ_R"] * np.exp(1j * np.radians(rot["circ_mean_deg"])) * rot["n"]
            n_rot += rot["n"]
            for k, v in rot["wells"].items():
                wells[k] = wells.get(k, 0.0) + v * rot["n"]
        h, g, a = mirror_chi1(r["pos_gen"], r["pos_gt"], r, r["coverage_counts"])
        m_hits, m_gauche = m_hits + h, m_gauche + g
        m_angles.append(a)
    m_angles = np.concatenate(m_angles) if m_angles else np.zeros(0)
    m_n = len(m_angles)
    nan = float("nan")
    return dict(rmsd=float(np.mean(rms)), chi1=hits / ntot if ntot else nan, n=ntot,
                gplus=wells.get("g+", 0.0) / n_rot if n_rot else nan,
                circ_R=float(abs(z_sum / n_rot)) if n_rot else nan,
                m_chi1=m_hits / m_n if m_n else nan, m_gauche=m_gauche / m_n if m_n else nan,
                m_circ_R=float(abs(np.exp(1j * np.radians(m_angles)).mean())) if m_n else nan)


def gate_sample(tag: str, ckpt: str, test_pkl: str, seeds, device: str) -> dict:
    """The gate's held-out chains through the protein_sampling CLI once per
    sampling seed: ``{seed: results}``."""
    from tsdiff_tpu_torch.cli import protein_sampling

    out = {}
    for seed in seeds:
        flags = ["--cutoff", "8.0", "--step_lr", "1e-5", "--seed", str(seed), "--n_steps", "300"]
        path = protein_sampling.main([ckpt, "--protein_set", test_pkl, "--device", device,
                                      "--save_dir", os.path.join(PROTEIN_DIR,
                                                                 f"gate_{tag}_{seed}"), *flags])
        with open(path, "rb") as f:
            out[seed] = pickle.load(f)
    return out


def protein_gate(sizes: dict, device: str, check: bool = True) -> dict:
    """Phase 13b: ``tests/test_protein_gate.py::run_gate``'s pipeline on the
    port: the gate's corpus and model, Adam at 3e-4 for ``gate_iters`` steps
    of its fixed batch (a captured step on the card), the held-out chains
    through the protein_sampling CLI beside the untrained model and the
    trans-180 template baseline.  One model per seed of
    ``sizes["gate_models"]`` (the first, 0, as the JAX gate's), each
    sampled once per seed of ``sizes["gate_seeds"]`` (the first, 7, the JAX
    gate's); the untrained model of the first.

    The gate's chains have a planar backbone (jittered by 0.02 A), so the
    mirror image of a sidechain through that plane keeps every distance,
    and a distance-only score cannot prefer g+ to g-: each residue falls
    into one mirror or the other by the walk's noise, in the JAX package as
    in the port (ROADMAP §C.3).  So with ``check`` the run fails on the
    RMSD threshold, read on the RMSD pooled over every model and seed, and
    on the rotamer thresholds read modulo that reflection (``mirror_chi1``:
    g+ and g- both gauche, trans apart), which a trained model meets at
    1.000 on every run so far and the untrained model and the template do
    not; the signed thresholds are printed, as missed where they miss."""
    import copy

    import numpy as np
    import torch

    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.core.graph import from_numpy_graphs
    from tsdiff_tpu_torch.data import save_dataset
    from tsdiff_tpu_torch.data.pdb import SidechainConformationDataset, pdb_to_graph
    from tsdiff_tpu_torch.data.synthetic import GATE_GAMMAS, res_chain
    from tsdiff_tpu_torch.diffusion.objective import draw_timesteps_and_noise
    from tsdiff_tpu_torch.eval.protein import chi1_accuracy, chi1_quads, place_dihedral
    from tsdiff_tpu_torch.models import get_model
    from tsdiff_tpu_torch.train import init_train_state, make_train_step, save_checkpoint
    from tsdiff_tpu_torch.train.captured import StepGraphs
    from tsdiff_tpu_torch.train.trainer import Adam, on_device

    t_gate = time.monotonic()
    os.makedirs(PROTEIN_DIR, exist_ok=True)
    train_graphs = [pdb_to_graph(res_chain(6 + (i % 3), seed=i)) for i in range(6)]
    test_graphs = [pdb_to_graph(res_chain(n, seed=s)) for n, s in ((6, 6), (8, 7))]
    test_pkl = os.path.join(PROTEIN_DIR, "gate_test.pkl")
    save_dataset(test_pkl, test_graphs)
    ds = SidechainConformationDataset(train_graphs, cutoff=8.0, seed=0)
    subs = [s for s in (ds[i] for i in range(len(ds))) if s is not None][:8]
    n_pad = 8 * ((max(len(s["atom_type"]) for s in subs) + 7) // 8)
    batch = from_numpy_graphs(subs, max_nodes=n_pad, device=device)
    seeds = sizes["gate_seeds"]
    fmt = lambda m: (f"RMSD {m['rmsd']:.3f} chi1 {m['chi1']:.3f} g+ {m['gplus']:.3f} "  # noqa
                     f"circ_R {m['circ_R']:.3f} | mirror-blind chi1 {m['m_chi1']:.3f} gauche "
                     f"{m['m_gauche']:.3f} circ_R {m['m_circ_R']:.3f}")

    runs = {"trained": [], "untrained": []}
    per_model, train_ms, nan = {}, [], {"trained": 0, "untrained": 0}
    for train_seed in sizes["gate_models"]:
        model = get_model(Config(GATE_CFG), generator=torch.Generator().manual_seed(train_seed))
        model = model.to(device)
        untrained = copy.deepcopy(model)
        tx = Adam(0.9, 0.999, float("inf"))   # optax.adam(3e-4): no clip
        state = on_device(init_train_state(model, tx))
        step = make_train_step(model, tx, None, anneal_power=2.0)
        lr = torch.tensor(3e-4, device=device)
        fn = lambda b, t, noise: step(state, b, lr, t=t, noise=noise)[1]  # noqa: E731
        graphs = StepGraphs(device) if device == "cuda" else None
        gen = torch.Generator(device=device).manual_seed(train_seed)
        t0 = time.monotonic()
        losses = []
        for it in range(sizes["gate_iters"]):
            t, noise = draw_timesteps_and_noise(gen, batch.pos.shape, 0,
                                                GATE_CFG["num_noise_level"], device)
            m = fn(batch, t, noise) if graphs is None else graphs(("train", n_pad), fn, batch,
                                                                 t, noise)
            if (it + 1) % 500 == 0:
                losses.append(float(m["loss"]))
        train_s = time.monotonic() - t0
        train_ms.append(train_s * 1e3 / sizes["gate_iters"])
        print(f"[protein gate] model seed {train_seed}: {len(subs)} subgraphs of 6 chains at "
              f"cutoff 8 (N={n_pad}), hidden 64, 3+3 convs, 10 levels from sigma 2.0: "
              f"{sizes['gate_iters']} Adam steps at 3e-4 in {train_s:.3f} s "
              f"({train_ms[-1]:.3f} ms per step"
              + (f", {graphs.replays[('train', n_pad)]} replays of its CUDA graph" if graphs
                 else "")
              + f"); loss every 500 steps {[round(x, 1) for x in losses]}")
        if not np.isfinite(losses).all():
            fail("[protein gate] non-finite training loss")
        tags = (("trained", model), ("untrained", untrained))
        for tag, m in tags[:2 if train_seed == sizes["gate_models"][0] else 1]:
            ck = os.path.join(PROTEIN_DIR, f"gate_{tag}_{train_seed}.ckpt")
            save_checkpoint(ck, Config(model=GATE_CFG), init_train_state(m, tx))
            t0 = time.monotonic()
            by_seed = gate_sample(f"{tag}_{train_seed}", ck, test_pkl, seeds, device)
            results = [r for rs in by_seed.values() for r in rs]
            runs[tag] += results
            nan[tag] += sum(bool(r["nan"]) for r in results)
            if tag == "trained":
                per_model[train_seed] = _gate_metrics(results)
                print(f"[protein gate] model seed {train_seed}, held-out chains (6, 6) and "
                      f"(8, 7) through the protein_sampling CLI (--cutoff 8.0 --step_lr 1e-5 "
                      f"--n_steps 300), sampling seeds {list(seeds)} in "
                      f"{time.monotonic() - t0:.3f} s: per seed "
                      + "; ".join(f"{s}: {fmt(_gate_metrics(rs))}" for s, rs in by_seed.items())
                      + f"; pooled: {fmt(per_model[train_seed])}")
    tr, un = _gate_metrics(runs["trained"]), _gate_metrics(runs["untrained"])
    hits, m_hits, n_b, rms_b = 0.0, 0, 0, []
    for g in test_graphs:
        pos = np.asarray(g["pos"], float).copy()
        for iN, iCA, iCB, iG in chi1_quads(g):
            bond = GATE_GAMMAS[g["res_name"][int(iG)]][2]
            pos[iG] = place_dihedral(pos[iN], pos[iCA], pos[iCB], bond, 110.5, 180.0)
        acc, n = chi1_accuracy(pos, g["pos"], g)
        sc = np.asarray(g["is_sidechain"], bool)
        rms_b.append(float(np.sqrt(((pos[sc] - np.asarray(g["pos"])[sc]) ** 2).sum(-1).mean())))
        hits += acc * n
        m_hits += mirror_chi1(pos, g["pos"], g)[0]
        n_b += n
    base = dict(chi1=hits / n_b, m_chi1=m_hits / n_b, rmsd=float(np.mean(rms_b)))
    print(f"[protein gate] {len(per_model)} models x {len(seeds)} sampling seeds pooled "
          f"({tr['n']} angles): {fmt(tr)} (NaN flags {nan['trained']}); per model RMSD "
          + ", ".join(f"{k}: {m['rmsd']:.3f}" for k, m in per_model.items())
          + f" (limit 3.4); calibration point RMSD {GATE_CALIBRATION['rmsd']}, chi1 "
          f"{GATE_CALIBRATION['chi1']}, g+ {GATE_CALIBRATION['gplus']}, circ_R "
          f"{GATE_CALIBRATION['circ_R']}; untrained (model seed {sizes['gate_models'][0]}) "
          f"pooled RMSD {un['rmsd']:.3f}, chi1 {un['chi1']:.3f} over {un['n']} (NaN flags "
          f"{nan['untrained']}); trans-180 template chi1 {base['chi1']:.3f}, RMSD "
          f"{base['rmsd']:.3f}; phase 13b wall {time.monotonic() - t_gate:.3f} s")

    # every threshold of tests/test_protein_gate.py:301-328: those on RMSD
    # and counts, and those on the rotamer read as named
    common = [
        ("n_chi1 > 0", tr["n"] > 0),
        ("trained RMSD < 3.4", np.isfinite(tr["rmsd"]) and tr["rmsd"] < 3.4),
        ("untrained diverges or RMSD > trained / 0.85",
         (not np.isfinite(un["rmsd"])) or tr["rmsd"] < 0.85 * un["rmsd"]),
    ]
    rotamer = lambda chi1, gplus, circ: [  # noqa: E731
        ("baseline chi1 < 0.1", base[chi1] < 0.1),
        ("trained chi1 >= 0.45", tr[chi1] >= 0.45),
        ("g+ >= 0.45", tr[gplus] >= 0.45),
        ("circ_R >= 0.45", tr[circ] >= 0.45),
        ("untrained has no chi1 or trained chi1 >= untrained + 0.1",
         un["n"] == 0 or tr[chi1] >= un[chi1] + 0.1),
        ("trained chi1 >= baseline + 0.4", tr[chi1] >= base[chi1] + 0.4),
    ]
    failed = [name for name, ok in common + rotamer("m_chi1", "m_gauche", "m_circ_R")
              if not ok]
    signed = [name for name, ok in rotamer("chi1", "gplus", "circ_R") if not ok]
    print(f"[protein gate] thresholds of tests/test_protein_gate.py, RMSD on the pooled RMSD "
          f"and the rotamer read modulo the backbone plane's reflection (saturated: a trained "
          f"model reads 1.000): {'all met' if not failed else 'MISSED: ' + '; '.join(failed)}")
    print(f"[protein gate] the signed rotamer thresholds (ROADMAP §C.3, open: a distance-only "
          f"score cannot tell g+ from its mirror g- on the gate's planar backbone): "
          + ("all met" if not signed else "MISSED: " + "; ".join(signed)))
    if check and failed:
        fail("[protein gate] the port misses the protein gate")
    return dict(trained=tr, untrained=un, baseline=base, per_model=per_model,
                train_ms=train_ms, failed=failed, signed_missed=signed)


def phase_protein(smi: str, device: str = "cuda", sizes: dict = PROTEIN_SIZES) -> dict:
    """Phase 13: the protein sidechain path at the full width of
    configs/protein_sidechain.yml, then the JAX package's protein gate, then
    protein sampling at dp=2.  ``device="cpu"`` and smaller ``sizes``
    rehearse it on the CPU (no mesh part there)."""
    import numpy as np
    import torch

    from tsdiff_tpu_torch.cli import evaluate as evaluate_cli
    from tsdiff_tpu_torch.cli import preprocessing
    from tsdiff_tpu_torch.cli import train as train_cli
    from tsdiff_tpu_torch.data.pdb import SidechainConformationDataset, cover_protein_with_subgraphs
    from tsdiff_tpu_torch.data.synthetic import compact_protein_pdb
    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.models import get_model
    from tsdiff_tpu_torch.train import get_checkpoint_path, init_train_state, save_checkpoint
    from tsdiff_tpu_torch.train.trainer import Adam

    t_phase = time.monotonic()
    shutil.rmtree(PROTEIN_DIR, ignore_errors=True)
    paths = {}
    for name, seeds in (("train", range(71, 71 + sizes["train_proteins"])), ("val", (74,)),
                        ("test", (75,))):
        src = os.path.join(PROTEIN_DIR, f"pdb_{name}")
        os.makedirs(src)
        for s in seeds:
            with open(os.path.join(src, f"compact{s}.pdb"), "w") as f:
                f.write(compact_protein_pdb(sizes["residues"], seed=s))
        with contextlib.redirect_stdout(io.StringIO()):
            paths[name] = preprocessing.main(["--pdb_glob", os.path.join(src, "*.pdb"),
                                              "--save_dir", os.path.join(PROTEIN_DIR, name)])
    train_graphs = protein_graphs(range(71, 71 + sizes["train_proteins"]), sizes["residues"])
    test = protein_graphs((75,), sizes["residues"])[0]
    ds = SidechainConformationDataset(train_graphs, cutoff=10.0, seed=0)
    subs = [ds[i] for i in range(len(ds)) for _ in range(8)]
    n_sub = [len(s["atom_type"]) for s in subs]
    cover = cover_protein_with_subgraphs(test, np.random.default_rng(2022), 10.0)
    n_pad = 8 * ((max(len(s["atom_type"]) for s in cover) + 7) // 8)
    print(f"[protein] {smi}: synthetic compact proteins of {sizes['residues']} residues "
          f"({len(test['atom_type'])} heavy atoms in the test protein); 10-A training balls of "
          f"{min(n_sub)}-{max(n_sub)} atoms (median {int(np.median(n_sub))}); the test protein "
          f"takes {len(cover)} covering subgraphs of {min(len(s['atom_type']) for s in cover)}-"
          f"{max(len(s['atom_type']) for s in cover)} atoms, n_pad {n_pad}; "
          f"protein_sidechain.yml at full width: {PROTEIN_SIDECHAIN['model']}")

    model_cfg = PROTEIN_SIDECHAIN["model"]
    batch = sizes["batch"]
    cfg = {"model": model_cfg,
           "train": {**PROTEIN_SIDECHAIN["train"], "batch_size": batch,
                     "max_iters": sizes["iters"], "val_freq": sizes["val_freq"],
                     "log_freq": sizes["val_freq"]},
           "dataset": {**PROTEIN_SIDECHAIN["dataset"], "train": paths["train"],
                       "val": paths["val"], "subgraphs_per_protein": sizes["subgraphs"]},
           "tpu": {"bucket_sizes": list(sizes["buckets"])}}
    cfg_path = os.path.join(PROTEIN_DIR, "protein_sidechain.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    log_dir = train_cli.main([cfg_path, "--logdir", os.path.join(PROTEIN_DIR, "logs"),
                              "--device", device])
    train_wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else 0.0
    with open(os.path.join(log_dir, "log.txt")) as f:
        log = f.read()
    losses = [float(v) for v in re.findall(r"\[Train\] Iter \d+ \| Loss (\S+)", log)]
    val = [float(v) for v in re.findall(r"\[Validate\] Iter \d+ \| Loss (\S+)", log)]
    tput = re.search(r"\| (\d+) graphs in (\S+) s \| (\S+) graphs/s", log)
    graphs = re.search(r"\[Train\] CUDA graphs \| recorded (\d+): (.*) \| replays (.*)", log)
    replays = sum(int(x) for x in re.findall(r"train \d+ (\d+)", graphs.group(3))) if graphs \
        else 0
    print(f"[protein] train CLI, dataset.type sidechain, batch {batch} (the config's "
          f"{PROTEIN_SIDECHAIN['train']['batch_size']} does not fit the card), buckets "
          f"{list(sizes['buckets'])}, {sizes['subgraphs']} subgraphs per protein per epoch: "
          f"{sizes['iters']} iterations in {train_wall:.3f} s, train losses {losses}, validation "
          f"{val}; "
          + (f"{float(tput.group(3)):.4f} graphs/s ({tput.group(1)} graphs in {tput.group(2)} s);"
             if tput else "")
          + (f" CUDA graphs recorded {graphs.group(1)} ({graphs.group(2)}), replays "
             f"{graphs.group(3)};" if graphs else "")
          + f" peak memory {peak:.2f} GB")
    if not (losses and val and np.isfinite(losses + val).all()):
        fail("[protein] the sidechain train run logged non-finite or no losses")
    if "sidechain mode" not in log or (device == "cuda" and replays == 0):
        fail("[protein] the train CLI did not train in sidechain mode on replayed steps")
    ckpt, _ = get_checkpoint_path(os.path.join(log_dir, "checkpoints"))

    # the walks compared bit for bit run on the seeded initialisation: the
    # card's training is not bitwise reproducible, and a trained
    # checkpoint's walks may flag NaNs and skip subgraphs.  An untrained
    # model's walk diverges at the default step_lr (as the JAX gate's
    # untrained model does), so these take PROTEIN_INIT_STEP_LR
    init_ckpt = os.path.join(PROTEIN_DIR, "init.ckpt")
    init = get_model(Config(model_cfg), generator=torch.Generator().manual_seed(PROTEIN_INIT_SEED))
    save_checkpoint(init_ckpt, Config(model=model_cfg),
                    init_train_state(init, Adam(0.95, 0.999, float("inf"))))
    flags = ["--sigma_respacing", str(sizes["sigma_respacing"]), "--n_steps",
             str(sizes["n_steps"])]
    init_flags = flags + ["--step_lr", str(PROTEIN_INIT_STEP_LR)]
    captured, wall = protein_sample("captured", init_ckpt, paths["test"], init_flags, device,
                                    complete=True)
    eager, eager_wall = protein_sample("eager", init_ckpt, paths["test"], init_flags, device,
                                       capture=False, complete=True)
    same = all(np.array_equal(a["pos_gen"], b["pos_gen"]) for a, b in zip(captured, eager))
    steps = protein_walk_ms(init_ckpt, test, sizes, device)
    n_batches = -(-len(cover) // 8)
    default_s = n_batches * 50 * 100 * steps.get("captured", steps["eager"]) / 1e3
    sc0 = captured[0]["is_sidechain"]
    print(f"[protein] protein_sampling CLI on the seeded model, {' '.join(init_flags)} "
          f"({steps['n_walk']} walk steps per batch, {n_batches} batches of up to 8 at n_pad "
          f"{steps['n_pad']}): {wall:.3f} s per protein (checkpoint and set loaded, walked, "
          f"written), eagerly {eager_wall:.3f} s; pos_gen captured against eager equal bit for "
          f"bit: {same}, every one of {int(sc0.sum())} sidechain atoms scored, no NaN flag; ms "
          "per walk step "
          + (f"{steps['captured']:.3f} replayed, " if "captured" in steps else "")
          + f"{steps['eager']:.3f} eager; the default walk (50 levels x 100 steps) extrapolated "
          f"to {default_s:.1f} s per protein; backbone exact")
    if not same:
        fail("[protein] the captured protein walk differs from the eager one")
    trained, trained_wall = protein_sample("trained", ckpt, paths["test"], flags, device)
    r0 = trained[0]
    covered = int((r0["coverage_counts"][sc0] > 0).sum())
    rmsd = float(np.sqrt(((r0["pos_gen"] - r0["pos_gt"])[sc0] ** 2).sum(-1).mean()))
    print(f"[protein] protein_sampling CLI on the trained checkpoint: {trained_wall:.3f} s, "
          f"backbone exact, {covered} of {int(sc0.sum())} sidechain atoms scored (NaN flagged: "
          f"{r0['nan']}), sidechain RMSD {rmsd:.3f} A ({sizes['iters']} steps of training)")
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        stats = evaluate_cli.main(["--samples", os.path.join(PROTEIN_DIR, "gen_trained",
                                                             "proteins_gen.pkl"), "--protein"])
    print(f"[protein] evaluate CLI --protein: " + " / ".join(printed.getvalue().strip()
                                                              .splitlines()))
    if not {"sidechain_rmsd", "nan_flagged", "chi1_accuracy", "chi1_n"} <= set(stats):
        fail("[protein] evaluate --protein returned no protein statistics")

    agree = protein_agreement(ckpt, protein_graphs((76,), sizes["agree_residues"])[0], device)
    gate = protein_gate(sizes, device)
    if device == "cuda":
        protein_mesh(init_ckpt, paths["test"], init_flags, eager)
    wall13 = time.monotonic() - t_phase
    print(f"[protein] {smi}: phase 13 wall {wall13:.3f} s")
    return dict(batch=batch, peak=peak, steps=steps, agree=agree, gate=gate, wall=wall13)


#: phase 14: the optional encoders at the JAX defaults' widths
ENCODERS = {
    "egnn": dict(name="egnn", hidden_dim=128, num_convs=5),
    "dimenetpp": dict(name="dimenetpp", hidden_dim=128, num_convs=4, cutoff=5.0,
                      num_spherical=7, num_radial=6, num_before_skip=1, num_after_skip=2),
    "comenet": dict(name="comenet", hidden_dim=256, num_convs=4, cutoff=8.0, num_radial=3,
                    num_spherical=2),
}
#: the card's encoder outputs and gradients against the CPU's, of max|CPU|:
#: within this, or within ``ENCODER_F32_FACTOR`` times the CPU's own float32
#: error against float64 where that is larger.  DimeNet++'s gradients at its
#: random initialisation reach ~1e10 (its output ~1e9, the JAX module's as
#: much) and f32 sums over its triplets lose ~1e-4 to 1e-3 of that on either
#: device (measured by this phase on an H100 against the CPU's float64)
ENCODER_AGREE = 1e-5
ENCODER_F32_FACTOR = 4.0


def encoder_inputs(name: str, B: int, N: int, H: int, seed: int) -> dict:
    """B graphs of N atoms at normal positions (sigma 2 A, generic: no
    coplanar or collinear atoms, where ComENet's folded angles would turn on
    rounding), the last ``b % 4`` atoms of graph b padding; edges within the
    encoder's cutoff (8 A for EGNN); node states, edge attributes, R/P edge
    types and the output's weights from the seed."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    pos = rng.normal(scale=2.0, size=(B, N, 3))
    node_mask = np.arange(N)[None, :] < (N - np.arange(B) % 4)[:, None]
    d = np.linalg.norm(pos[:, :, None] - pos[:, None, :], axis=-1)
    cutoff = ENCODERS[name].get("cutoff", 8.0)
    emask = (d < cutoff) & ~np.eye(N, dtype=bool) & node_mask[:, :, None] & node_mask[:, None, :]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    x = dict(pos=t(pos.astype(np.float32)), emask=t(emask), node_mask=t(node_mask),
             node=t(rng.normal(size=(B, N, H)).astype(np.float32)),
             attr=t(rng.normal(size=(B, N, N, H)).astype(np.float32)),
             type_r=t(rng.integers(0, 26, size=(B, N, N))),
             type_p=t(rng.integers(0, 26, size=(B, N, N))))
    x["out_w"] = t(rng.normal(size=(B, N, H)).astype(np.float32))
    return x


def encoder_call(name: str, model, x: dict):
    if name == "egnn":
        return model(x["node"], x["emask"], x["attr"], x["attr"].flip(-1), x["emask"], x["pos"])
    if name == "dimenetpp":
        return model(x["node"], x["pos"], x["emask"], x["attr"], x["node_mask"])
    return model(x["node"], x["pos"], x["emask"], x["type_r"], x["type_p"], x["node_mask"])


def phase_encoders(smi: str, device: str = "cuda", shapes=((8, 24), (8, 32))) -> dict:
    """Phase 14: EGNN, DimeNet++ and ComENet from ``load_encoder`` at the JAX
    defaults' widths, f32 with TF32 off, eval mode: forward and backward on
    the card against the port on the CPU (the output, and the gradients of
    ``sum(out * w)`` for every parameter as one vector, each over its
    max|CPU|; the limit ``ENCODER_AGREE`` or ``ENCODER_F32_FACTOR`` times the
    CPU's float32 error against a float64 run of the same module), ms per
    forward and per backward."""
    import copy

    import torch

    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.models import load_encoder
    from tsdiff_tpu_torch.ops import dimenet_triplet as dt

    try:
        import sympy
        have = f"sympy {sympy.__version__} imports"
    except ImportError:
        have = "sympy does not import"
    print(f"[encoders] {have} on this machine (for information: ops/basis.py needs none)")
    out = {}
    for name, enc in ENCODERS.items():
        cpu = load_encoder(Config(encoder=enc), "encoder",
                           generator=torch.Generator().manual_seed(14)).eval()
        if name == "comenet":   # lin_out starts at zero: give the gradients a path
            with torch.no_grad():
                cpu.lin_out.weight.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
        dev = copy.deepcopy(cpu).to(device)
        for B, N in shapes:
            x = encoder_inputs(name, B, N, enc["hidden_dim"], seed=80 + N)
            xd = {k: v.to(device) for k, v in x.items()}
            x64 = {k: v.double() if v.is_floating_point() else v for k, v in x.items()}
            res = {}
            for tag, model, inp in (("cpu", cpu, x), ("f64", copy.deepcopy(cpu).double(), x64),
                                    (device, dev, xd)):
                model.zero_grad()
                y = encoder_call(name, model, inp)
                (y * inp["out_w"]).sum().backward()
                res[tag] = (y.detach().cpu().double(),
                            {k: p.grad.detach().cpu().double() for k, p in model.named_parameters()
                             if p.grad is not None})

            def errs(a, b):
                """(output, gradients as one vector) of ``a`` against ``b``,
                each over b's max."""
                (ya, ga), (yb, gb) = res[a], res[b]
                scale = max(float(g.abs().max()) for g in gb.values())
                return (float((ya - yb).abs().max()) / max(float(yb.abs().max()), 1e-30),
                        max(float((ga[k] - gb[k]).abs().max()) for k in gb) / scale, scale)

            err_y, err_g, g_scale = errs(device, "cpu")
            f32_y, f32_g, _ = errs("cpu", "f64")
            dev_y, dev_g, _ = errs(device, "f64")
            lim_y = max(ENCODER_AGREE, ENCODER_F32_FACTOR * f32_y)
            lim_g = max(ENCODER_AGREE, ENCODER_F32_FACTOR * f32_g)
            y_got = res[device][0]
            pad_zero = bool((y_got[~x["node_mask"]] == 0).all()) if name != "egnn" else True
            fwd = bwd = None
            err_ng = 0.0
            if device == "cuda":
                launches = dt.triplet_sum.launches
                with torch.no_grad():
                    y_ng = encoder_call(name, dev, xd).cpu().double()
                # without autograd DimeNet++'s blocks take the triplet kernel,
                # with it the plain version: the same function
                err_ng = float((y_ng - y_got).abs().max()) / max(float(y_got.abs().max()), 1e-30)
                ng_launches = dt.triplet_sum.launches - launches
                want_launches = enc["num_convs"] if name == "dimenetpp" else 0
                print(f"[encoders] {name} at B={B} N={N}: the card's forward without autograd "
                      f"against its forward with it: {err_ng:.3g} of max (limit {lim_y:.3g}), "
                      f"{ng_launches} triplet kernel launches (want {want_launches})")
                if not err_ng <= lim_y or ng_launches != want_launches:
                    fail(f"[encoders] {name} at B={B} N={N}: the forward without autograd "
                         f"disagrees with the forward with it, or launched the triplet kernel "
                         f"{ng_launches} times")
                with torch.no_grad():
                    fwd = cuda_time_ms(lambda: encoder_call(name, dev, xd), 5)[0]
                y = encoder_call(name, dev, xd)
                loss = (y * xd["out_w"]).sum()
                bwd = cuda_time_ms(lambda: loss.backward(retain_graph=True), 5)[0]
            print(f"[encoders] {name} {enc} at B={B} N={N}: {device} against the CPU, output "
                  f"{err_y:.3g} of max|CPU| (limit {lim_y:.3g}), gradients of its "
                  f"{len(res['cpu'][1])} parameters {err_g:.3g} of their max|CPU| {g_scale:.4g} (limit {lim_g:.3g}); "
                  f"the CPU's float32 against float64: {f32_y:.3g}, {f32_g:.3g}, the card's: "
                  f"{dev_y:.3g}, {dev_g:.3g}; padded rows zero "
                  f"{pad_zero}" + (f"; {fwd:.3f} ms per forward, {bwd:.3f} ms per backward"
                                   if fwd else ""))
            if not (err_y <= lim_y and err_g <= lim_g and pad_zero
                    and torch.isfinite(y_got).all()):
                fail(f"[encoders] {name} at B={B} N={N} disagrees with the CPU")
            out[(name, N)] = dict(err=max(err_y, err_g, err_ng), fwd_ms=fwd, bwd_ms=bwd)
    print(f"[encoders] {smi}: phase 14 done")
    return out


# -- phase 15: checkpoint directories and the build cache ---------------------

CKPT_PHASE_DIR = os.path.join(ROOT, ".scratch", "chip_smoke_ckpt")   # gitignored
#: the JAX package's orbax directory committed with its leaves (.npz)
ORBAX_FIXTURE = os.path.join(ROOT, "tests", "torch_data", "orbax_jax_small")
RESUME_ITERS = 10


def checkpoint_arrays(payload: dict) -> dict:
    """Every array leaf of a payload's trees by its path joined with ``/``;
    sequences by index, bfloat16 (a torch tensor) as its uint16 bits; the
    optimizer chain's empty states hold none (as the fixture's .npz)."""
    import numpy as np
    import torch

    out = {}

    def walk(tree, path):
        if isinstance(tree, dict) and tree:
            for k in sorted(tree):
                walk(tree[k], f"{path}/{k}")
        elif isinstance(tree, (list, tuple)) and tree:
            for i, v in enumerate(tree):
                walk(v, f"{path}/{i}")
        elif tree is not None and not isinstance(tree, (dict, list, tuple)):
            out[path] = (tree.view(torch.int16).numpy().view(np.uint16)
                         if isinstance(tree, torch.Tensor) else np.asarray(tree))

    for part in ("params", "opt_state", "ema_params"):
        walk(payload.get(part), part)
    return out


def same_arrays(a: dict, b: dict) -> bool:
    import numpy as np

    return set(a) == set(b) and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                                    for k in a)


def ckpt_log_numbers(log: str) -> dict:
    """The train CLI's checkpoint lines: ms each save held the loop, and
    with orbax the wait at the loop's end and each write's ms."""
    held = [float(m) for m in re.findall(r"the loop held (\S+) ms\]", log)]
    m = re.search(r"\[Train\] Checkpoint writes \| orbax, waited (\S+) ms at the loop's end \| "
                  r"(\d+) written, ms from each save call to its directory: (.*)", log)
    out = dict(held_ms=held)
    if m:
        out.update(wait_ms=float(m.group(1)), written=int(m.group(2)),
                   write_ms=[float(x) for x in m.group(3).split(", ") if x])
    return out


def resume_losses(tag: str, run_dir: str, backend: str, logdir: str) -> tuple:
    """The train CLI resumed from ``run_dir``'s best checkpoint for
    ``RESUME_ITERS`` more iterations: ``(losses, checkpoint read, iteration)``."""
    from tsdiff_tpu_torch.cli import train as train_cli
    from tsdiff_tpu_torch.train import get_checkpoint_path

    path, it = get_checkpoint_path(os.path.join(run_dir, "checkpoints"))
    resumed = train_cli.main([run_dir, "--logdir", os.path.join(CKPT_PHASE_DIR, logdir),
                              "--max_iters", str(it + RESUME_ITERS), "--dtype", "bfloat16",
                              "--ckpt_backend", backend, "--device", "cuda"])
    with open(os.path.join(resumed, "log.txt")) as f:
        log = f.read()
    if f"Resuming from {path} (iteration {it})" not in log:
        fail(f"{tag}: the resumed run does not log reading {path}")
    losses = [(kind, int(i), float(v))
              for kind, i, v in re.findall(r"\[(Train|Validate)\] Iter (\d+) \| Loss (\S+)", log)]
    import numpy as np

    if not losses or not np.all(np.isfinite([v for _, _, v in losses])):
        fail(f"{tag}: the resumed run logged no or non-finite losses")
    return losses, path, it


def cache_probe(cache: str) -> None:
    """``python3 chip_smoke.py --cache-probe DIR``, run by phase 15 with
    ``TSDIFF_COMPILE_CACHE`` set: enable the cache as the CLIs do, build the
    kernels and the packer (or find them there), launch B1 once at the
    sampling path's shape, and print one JSON line with the build seconds,
    the roots and the time from this process's start to that launch."""
    import torch

    sys.path.insert(0, ROOT)
    from tsdiff_tpu_torch.data import native
    from tsdiff_tpu_torch.diffusion.ensemble import stack_params
    from tsdiff_tpu_torch.ops import _build
    from tsdiff_tpu_torch.ops import packed_score as ps
    from tsdiff_tpu_torch.utils.compile_cache import build_roots, maybe_enable_compile_cache

    if not maybe_enable_compile_cache():
        fail("--cache-probe: TSDIFF_COMPILE_CACHE is not set")
    roots = build_roots()
    if roots != {"kernels": os.path.abspath(cache), "packer": os.path.abspath(cache)}:
        fail(f"--cache-probe: build roots {roots}, expected {cache}")
    t0 = time.monotonic()
    _build.build(list(SOURCES))
    kernels_s = time.monotonic() - t0
    packer_built = not os.path.exists(native.library_path())
    t1 = time.monotonic()
    native.build()
    packer_s = time.monotonic() - t1
    batch, pos = kernel_batch(24, seed=1234 + 24)
    members = load_members(torch.bfloat16, torch.device("cuda"))
    model = members[0]
    pp = model.precompute_packed_pairs(batch.bond_mat, batch.node_mask)
    info = model.build_packed_pair_info(pos, batch.node_mask, pp)
    with torch.no_grad():
        z = torch.stack([m.node_states(batch.atom_type, batch.r_feat, batch.p_feat,
                                       batch.node_mask) for m in members]).contiguous()
    w = stack_params([m.kernel_weights() for m in members])
    out = ps.packed_score(w, z, info.d_in.contiguous(), info.cmask.contiguous(), pp.type_r_in,
                          pp.type_p_in, pp.type_r_out, pp.type_p_out, num_blocks=model.num_convs)
    torch.cuda.synchronize()
    print(json.dumps({
        "roots": roots, "build_seconds": {n: _build.build_info[n]["seconds"] for n in SOURCES},
        "kernels_wall_s": kernels_s, "packer_built": packer_built, "packer_s": packer_s,
        "b1_launches": ps.packed_score.launches, "b1_finite": bool(torch.isfinite(out).all()),
        "start_to_first_launch_s": time.monotonic() - PROCESS_T0}))


def stop_processes(procs: list) -> None:
    """Kill each process still running, with the processes it started (each
    leads its own session: a cache probe's nvcc children)."""
    for proc in procs:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def phase_checkpoints(smi: str, setup: tuple, interop: dict) -> dict:
    """Phase 15: orbax checkpoint directories on the training and sampling
    paths, the JAX package's directory read on the card, and the build
    cache.  (a) the train CLI with 6a's flags and ``--ckpt_backend orbax``,
    under torch.profiler with a ``.ckpt`` of the same state written beside
    each save (every ``.orbax`` loads to that ``.ckpt``'s arrays bit for
    bit; B3 counted by kernel name), then unprofiled with ``orbax``,
    ``pickle``, ``pickle``, ``orbax`` (ms each save held the loop, the wait
    at the loop's end, each write's ms, graphs/s); (b) the twin run resumed for ``RESUME_ITERS``
    iterations from its ``.orbax`` and from its ``.ckpt`` files (logged
    losses within ``CLI_LOSS_RTOL``: the F.embedding caveat of phase 6);
    (c) the 8 members written as ``.orbax`` directories, sampled with phase
    10's command on its 100 reactions: equal to phase 10's ``.ckpt`` samples
    bit for bit, B1 once per walk step by kernel name; (d) the committed
    JAX-written directory (OCDBT, zstd) against its ``.npz``; (e) two fresh
    processes in turn on one empty ``TSDIFF_COMPILE_CACHE``: the second
    builds nothing; ``tsdiff_tpu_torch/_build/`` untouched."""
    import numpy as np
    import torch

    from tsdiff_tpu_torch.ops import _build
    from tsdiff_tpu_torch.ops import schnet_stack as ss
    from tsdiff_tpu_torch.train import get_checkpoint_path, load_checkpoint, save_checkpoint
    from tsdiff_tpu_torch.train import orbax_io

    t_phase = time.monotonic()
    shutil.rmtree(CKPT_PHASE_DIR, ignore_errors=True)
    os.makedirs(CKPT_PHASE_DIR)

    # (a) the train CLI with orbax saves
    model_cfg, train_cfg, paths, buckets = setup
    model_cfg = {**model_cfg, "packed_train": False, "use_pallas": True}
    cfg_path = write_train_config("train_config_ckpt", model_cfg, train_cfg, paths, buckets)
    flags = ["--dtype", "bfloat16"]
    real_save = orbax_io.save_checkpoint_orbax
    twins = []

    def save_with_twin(path, config, state, *args, **kwargs):
        real_save(path, config, state, *args, **kwargs)
        twin_dir = os.path.join(os.path.dirname(os.path.dirname(path)), "checkpoints_pickle")
        os.makedirs(twin_dir, exist_ok=True)
        twin = os.path.join(twin_dir, os.path.basename(path)[:-len(".orbax")] + ".ckpt")
        save_checkpoint(twin, config, state, *args, **kwargs)
        twins.append((path, twin))

    ss.schnet_stack_fwd.launches = ss.schnet_stack_bwd.launches = 0
    orbax_io.save_checkpoint_orbax = save_with_twin
    try:
        twin_run = run_train_cli("ckpt orbax+twin", cfg_path, train_cfg,
                                 flags + ["--ckpt_backend", "orbax"], "ckpt_twin", profiled=True)
    finally:
        orbax_io.save_checkpoint_orbax = real_save
    counters = (ss.schnet_stack_fwd.launches, ss.schnet_stack_bwd.launches)
    L = model_cfg["encoder"]["num_convs"]
    g = twin_run["graphs"]
    n_train = sum(k == "train" for k, _ in g["recorded"])
    n_eval = len(g["recorded"]) - n_train
    rep = {kind: sum(n for (k, _), n in g["replays"].items() if k == kind)
           for kind in ("train", "eval")}
    ran_fwd, ran_bwd = n_train + n_eval + rep["train"] + rep["eval"], n_train + rep["train"]
    named = {kernel: sum(n for name, n in twin_run["kernels"].items() if kernel in name)
             for kernel in ("schnet_fwd_wg_kernel<true>", "schnet_bwd_rows_wg_kernel",
                            "schnet_bwd_xty_wg_kernel")}
    b3 = (named["schnet_fwd_wg_kernel<true>"], named["schnet_bwd_rows_wg_kernel"] // L,
          named["schnet_bwd_xty_wg_kernel"] // L)
    print(f"[ckpt] (a) B3 by kernel name in the orbax run: {named} (expected forward "
          f"{ran_fwd}, row and weight-gradient kernels {L} x {ran_bwd}); wrapper counters "
          f"{counters} (expected {2 * (n_train + n_eval)}, {2 * n_train})")
    if b3 != (ran_fwd, ran_bwd, ran_bwd) or counters != (2 * (n_train + n_eval), 2 * n_train):
        fail("the orbax training run did not run B3 at every step")
    written = sorted(f for f in os.listdir(os.path.join(twin_run["log_dir"], "checkpoints"))
                     if f.endswith(".orbax"))
    if not twins or sorted(os.path.basename(p) for p, _ in twins) != written:
        fail(f"the orbax run wrote {written}, its saves were {twins}")
    for orbax_path, twin in twins:
        got, want = load_checkpoint(orbax_path), load_checkpoint(twin)
        a, b = checkpoint_arrays(got), checkpoint_arrays(want)
        same = same_arrays(a, b) and got["opt_state"][0] == () and all(
            got[k] == want[k] for k in ("config", "scheduler", "iteration", "avg_val_loss"))
        with open(os.path.join(orbax_path, "_METADATA")) as f:
            layout = "use_ocdbt false" if '"use_ocdbt": false' in f.read() else "?"
        print(f"[ckpt] (a) {os.path.basename(orbax_path)} ({layout}, {len(a)} arrays, "
              f"{sum(v.nbytes for v in a.values()):,} bytes) against the .ckpt of the same "
              f"state: equal bit for bit in params, opt_state and ema_params: {same}")
        if not same:
            fail(f"{orbax_path} does not load to the arrays of {twin}")
    # unprofiled, in turns (the host sets these runs' pace and drifts between them)
    runs = {"orbax": [], "pickle": []}
    for i, backend in enumerate(("orbax", "pickle", "pickle", "orbax")):
        run = run_train_cli(f"ckpt {backend}", cfg_path, train_cfg,
                            flags + ["--ckpt_backend", backend], f"ckpt_{i}_{backend}")
        run["numbers"] = ckpt_log_numbers(run["log"])
        o = run["numbers"]
        if not o["held_ms"] or (backend == "orbax") != ("wait_ms" in o) or (
                backend == "orbax" and o["written"] != len(o["held_ms"])):
            fail(f"the train CLI's checkpoint lines are missing or wrong: {backend} {o}")
        runs[backend].append(run)
    o = [r["numbers"] for r in runs["orbax"]]
    print(f"[ckpt] (a) {smi}, in the order orbax, pickle, pickle, orbax: ms each save held the "
          f"loop: orbax {[n['held_ms'] for n in o]}, pickle "
          f"{[r['numbers']['held_ms'] for r in runs['pickle']]}; orbax writes, ms from each save "
          f"call to its directory {[n['write_ms'] for n in o]}, wait at the loop's end "
          f"{[n['wait_ms'] for n in o]} ms; graphs/s: orbax "
          f"{[r['graphs_per_s'] for r in runs['orbax']]}, pickle "
          f"{[r['graphs_per_s'] for r in runs['pickle']]} (the profiled twin run "
          f"{twin_run['graphs_per_s']:.4f})")

    # (b) resume from the .orbax and from the .ckpt of the same states
    pickle_src = os.path.join(CKPT_PHASE_DIR, "twin_as_pickle")
    shutil.copytree(twin_run["log_dir"], pickle_src,
                    ignore=shutil.ignore_patterns("checkpoints", "checkpoints_pickle"))
    shutil.copytree(os.path.join(twin_run["log_dir"], "checkpoints_pickle"),
                    os.path.join(pickle_src, "checkpoints"))
    from_orbax, path_o, it_o = resume_losses("resume .orbax", twin_run["log_dir"], "orbax",
                                             "resume_orbax")
    from_pickle, path_p, it_p = resume_losses("resume .ckpt", pickle_src, "pickle",
                                              "resume_pickle")
    if (it_o, [x[:2] for x in from_orbax]) != (it_p, [x[:2] for x in from_pickle]):
        fail(f"the two resumes logged different lines ({it_o}, {it_p})")
    rel = max(abs(x[2] - y[2]) / max(abs(y[2]), 1e-12) for x, y in zip(from_orbax, from_pickle))
    print(f"[ckpt] (b) resumed {os.path.relpath(path_o, ROOT)} and "
          f"{os.path.relpath(path_p, ROOT)} (iteration {it_o}) for {RESUME_ITERS} iterations: "
          f"{len(from_orbax)} logged losses, equal: {from_orbax == from_pickle}, largest "
          f"relative difference {rel:.6g} (limit {CLI_LOSS_RTOL}: {NONDETERMINISTIC} can move "
          f"a step by a bf16 ulp between two runs from one state, as phase 6 shows); "
          f"from .orbax {from_orbax}")
    if not rel <= CLI_LOSS_RTOL:
        fail(f"the resume from the .orbax differs from the resume from the .ckpt by {rel:.6g}")

    # (c) sampling from the 8 members written as .orbax directories
    members = []
    t_conv = time.monotonic()
    for seed in MEMBER_SEEDS:
        members.append(os.path.join(CKPT_PHASE_DIR, "members", f"seed{seed}_best.orbax"))
        os.makedirs(os.path.dirname(members[-1]), exist_ok=True)
        orbax_io.write_checkpoint_orbax(members[-1], load_checkpoint(
            os.path.join(CKPT_DIR, f"seed{seed}_best.ckpt")))
    conv_s = time.monotonic() - t_conv
    got, n_b1, dmae, evaluated = sample_cli(".orbax members", members, interop["test_set"],
                                            os.path.join(CKPT_PHASE_DIR, "samples_orbax"))
    want = interop["ckpt_results"]
    same = len(got) == len(want) > 0 and all(
        a["smiles"] == b["smiles"] and np.array_equal(a["pos_gen"], b["pos_gen"])
        for a, b in zip(got, want))
    print(f"[ckpt] (c) {len(members)} members written as .orbax directories in {conv_s:.3f} s; sampled with "
          f"phase 10's command: pos_gen of {len(got)} samples equal to phase 10's .ckpt samples "
          f"bit for bit: {same}; "
          f"B1 by kernel name {n_b1}; D-MAE mean {dmae:.4f}; evaluate CLI: {evaluated}")
    if not same:
        fail("sampling from the .orbax members differs from sampling from the .ckpt members")

    # (d) the JAX package's directory, read on the card
    with open(os.path.join(ORBAX_FIXTURE, "7.orbax", "_METADATA")) as f:
        ocdbt = '"use_ocdbt": true' in f.read()
    ck = load_checkpoint(os.path.join(ORBAX_FIXTURE, "7.orbax"))
    arrays = checkpoint_arrays(ck)
    npz = np.load(os.path.join(ORBAX_FIXTURE, "7.npz"))
    fixture_ok = ocdbt and same_arrays(arrays, {k: npz[k] for k in npz.files})
    print(f"[ckpt] (d) {os.path.relpath(ORBAX_FIXTURE, ROOT)}/7.orbax (written by the JAX "
          f"package, OCDBT: {ocdbt}): {len(arrays)} arrays equal to the committed .npz: "
          f"{fixture_ok}; zstd decoder: {orbax_io.zstd_library}")
    if not fixture_ok or not orbax_io.zstd_library:
        fail("the JAX package's orbax directory does not read to its .npz on the card")

    # (e) the build cache: two processes in turn on one empty directory
    cache = os.path.join(CKPT_PHASE_DIR, "compile_cache")
    os.makedirs(cache)

    def default_listing():
        root = _build.BUILD_ROOT
        return sorted((dirpath, name, os.stat(os.path.join(dirpath, name)).st_mtime_ns)
                      for dirpath, _, names in os.walk(root) for name in names)

    before = default_listing()
    torch.cuda.empty_cache()   # the probes share the card with this process
    free, total = torch.cuda.mem_get_info()
    with open("/proc/meminfo") as f:
        host = {k: int(v.split()[0]) / 2**20 for k, v in (line.split(":", 1) for line in f)}
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"[ckpt] (e) before the probes: card {free / 2**30:.3f} GiB free of {total / 2**30:.3f} "
          f"(this process reserves {torch.cuda.memory_reserved() / 2**30:.3f}); host "
          f"{host['MemAvailable']:.3f} GiB available of {host['MemTotal']:.3f} (this process's "
          f"peak resident {rss:.3f})")
    env = {**os.environ, "TSDIFF_COMPILE_CACHE": cache}
    probe_cmd = [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--cache-probe", cache]
    probes = []
    atexit.register(stop_processes, probes)   # a failed check stops them too
    results = []
    for i in range(2):
        probes.append(subprocess.Popen(probe_cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True, env=env, start_new_session=True))
        t_probe0 = time.monotonic()
        out, err = probes[i].communicate(timeout=600)
        wall = time.monotonic() - t_probe0
        if probes[i].returncode != 0:
            fail(f"--cache-probe process {i + 1} failed:\n{out[-2000:]}\n{err[-3000:]}")
        results.append(json.loads(out.strip().splitlines()[-1]))
        r = results[-1]
        print(f"[ckpt] (e) process {i + 1} with TSDIFF_COMPILE_CACHE={os.path.relpath(cache, ROOT)}"
              f"{' (empty)' if i == 0 else ' (as the first left it)'}: build "
              f"seconds from _build.build_info {r['build_seconds']} (kernels' wall "
              f"{r['kernels_wall_s']:.3f} s), packer built: {r['packer_built']} "
              f"({r['packer_s']:.3f} s); start to the first B1 launch "
              f"{r['start_to_first_launch_s']:.3f} s (process wall {wall:.3f} s); B1 launches "
              f"{r['b1_launches']}, finite {r['b1_finite']}; roots {r['roots']}")
    first, second = results
    if not (all(s > 0 for s in first["build_seconds"].values()) and first["packer_built"]):
        fail("the first process did not build into the empty cache")
    if any(second["build_seconds"].values()) or second["packer_built"]:
        fail(f"the second process built again: {second['build_seconds']}")
    if not all(r["b1_launches"] == 1 and r["b1_finite"] for r in results):
        fail("a cache probe did not launch B1 once")
    untouched = default_listing() == before
    print(f"[ckpt] (e) {os.path.relpath(_build.BUILD_ROOT, ROOT)}/ untouched by both: {untouched}")
    if not untouched:
        fail("the cache probes touched the default build directory")
    print(f"[ckpt] phase 15 took {time.monotonic() - t_phase:.3f} s")
    return dict(b1_launches=n_b1, b3_fwd=b3[0], b3_bwd=b3[1], xty=b3[2])


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
    dk = phase_dense_kernels()
    sk = phase_stack_kernels()
    smooth = phase_stack_smooth()
    main_path = phase_main_path()
    phase_profile()
    setup = train_setup()
    tr = phase_train(setup)
    packed = phase_train_packed(setup)
    dense_path = phase_dense_path()
    int8_path = phase_main_path(quant="int8")
    delta = abs(int8_path["dmae_mean"] - main_path["dmae_mean"])
    print(f"[main int8] D-MAE mean {int8_path['dmae_mean']:.4f} against {main_path['dmae_mean']:.4f} "
          f"in bf16 on the same reactions and seeds: |difference| {delta:.4f} (limit "
          f"{DMAE_INT8_DELTA}); {int8_path['wall']:.3f} s against {main_path['wall']:.3f} s")
    if not delta <= DMAE_INT8_DELTA:
        fail(f"the int8 run's mean D-MAE differs from the bf16 run's by {delta:.4f}")
    served = phase_serving()
    interop = phase_reference_interop(setup, packed)
    phase_packer(tr["graphs_per_s"], packed["graphs_per_s"])
    mk = phase_mesh_kernels()
    mesh = phase_mesh(main_path, setup)
    phase_legacy(smi)
    phase_protein(smi)
    phase_encoders(smi)
    ckpt = phase_checkpoints(smi, setup, interop)
    dimenet = phase_dimenet_walk(smi)

    def entry(name, source, replaces, launches, numbers, by_path=None):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "ms_by",
                "library_ms_by")
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches, **{key: numbers.get(key) for key in keys}}
        if by_path:
            out["launches_by_path"] = by_path
        return out

    stack_src = "tsdiff_tpu_torch/csrc/schnet_stack.cu"
    vjp = "tsdiff_tpu/ops/pallas/schnet_stack_vjp.py"
    bf = sk[(24, "bfloat16")]
    serving = f"serving, profiled captured rounds of {PROFILED_WALK} steps"
    mesh_path = "sampling CLI on the (1, 2) and (2, 1) meshes, 2 ranks over gloo, both ranks"
    b1 = entry("packed_score", "tsdiff_tpu_torch/csrc/packed_score.cu",
               "tsdiff_tpu/ops/pallas/condensed_score_packed.py:164",
               main_path["launches"] + served["b1_launches"] + interop["launches"] + mesh["b1"]
               + ckpt["b1_launches"],
               k[(24, "bfloat16")],
               {"sampling CLI": main_path["launches"], serving: served["b1_launches"],
                "reference interop (phase 10)": interop["launches"], mesh_path: mesh["b1"],
                "sampling CLI from .orbax members (phase 15)": ckpt["b1_launches"]})
    # every launch here is counted by kernel name in a profiled run of its
    # path; the served requests' walk steps, not all profiled, stand apart
    b1["serving_walk_steps"] = served["walk_steps"]
    b1["serving_max_abs_err"] = served["b1_err"]
    shape_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")

    def at_shape(numbers: dict, what: str) -> dict:
        return {"what": what, **{key: numbers[key] for key in shape_keys}}

    b1["mesh_shapes"] = [at_shape(mk[("packed_score", 4, 100)], "M=4 B=100 N=24 bf16 (ens=2)"),
                         at_shape(mk[("packed_score", 8, 50)], "M=8 B=50 N=24 bf16 (dp=2)")]
    mesh_train = "train CLI, 2 ranks over gloo (dp=2), both ranks"
    orbax_train = "train CLI --ckpt_backend orbax (phase 15)"
    b3_fwd = entry("schnet_stack_fwd", stack_src, f"{vjp}:44",
                   tr["launches"][0] + mesh["b3_fwd"] + ckpt["b3_fwd"], bf["fwd"],
                   {"train CLI": tr["launches"][0], mesh_train: mesh["b3_fwd"],
                    orbax_train: ckpt["b3_fwd"]})
    b3_fwd["mesh_shapes"] = [at_shape(mk[("fwd", n)], f"B=100 N={n} bf16 (dp=2)")
                             for n in (16, 24)]
    b3_bwd = entry("schnet_stack_bwd", stack_src, f"{vjp}:72",
                   tr["launches"][1] + mesh["b3_bwd"] + ckpt["b3_bwd"], bf["bwd"],
                   {"train CLI": tr["launches"][1], mesh_train: mesh["b3_bwd"],
                    orbax_train: ckpt["b3_bwd"]})
    b3_bwd["mesh_shapes"] = [at_shape(mk[("bwd", n)], f"B=100 N={n} bf16 (dp=2)")
                             for n in (16, 24)]
    # phase 3's check on the smooth cutoff's fractional mask, N=24
    for b3, part in ((b3_fwd, "fwd"), (b3_bwd, "bwd")):
        b3["smooth_mask_max_abs_err"] = {d: smooth[d][part] for d in smooth}
    print(json.dumps({"kernels": [
        b1,
        entry("condensed_score", "tsdiff_tpu_torch/csrc/condensed_score.cu",
              "tsdiff_tpu/ops/pallas/condensed_score.py:152", dense_path["launches"],
              dk[(24, "bfloat16")]),
        # the train CLI's calls, eager and replayed, counted by kernel name
        b3_fwd,
        b3_bwd,
        # the backward's weight gradients alone: a launch is one backward call's
        # products, its time the 7 blocks' (the library call: torch.mm for each)
        entry("schnet_stack_bwd_xty", stack_src, f"{vjp}:72", tr["xty_launches"] + ckpt["xty"],
              bf["xty"], {"train CLI": tr["xty_launches"], orbax_train: ckpt["xty"]}),
        # B4 has no caller on a path in either package: the training run counts 0
        entry("schnet_stack", stack_src, "tsdiff_tpu/ops/pallas/schnet_stack.py:53",
              tr["b4_launches"], bf["stack"]),
        entry("packed_score_int8", "tsdiff_tpu_torch/csrc/packed_score_int8.cu",
              "tsdiff_tpu/ops/pallas/condensed_score_packed_int8.py:188",
              int8_path["launches"] + served["b5_launches"], k[("int8", 24, "bfloat16")],
              {"sampling CLI": int8_path["launches"], serving: served["b5_launches"]})
        | {"serving_max_abs_err": served["b5_err"],
           "mesh_shapes": [at_shape(mk[("packed_score_int8", 4, 100)],
                                    "M=4 B=100 N=24 bf16 (ens=2)")]},
        # no TPU kernel: the JAX package leaves the chain to XLA (its einsums)
        entry("dimenet_triplet", "tsdiff_tpu_torch/csrc/dimenet_triplet.cu",
              "tsdiff_tpu/models/dimenetpp.py:199", dimenet["launches"],
              dimenet["by_n"][24],
              {"DimeNet++ captured walk (phase 16)": dimenet["launches"]})
        | {"shapes": [at_shape(dimenet["by_n"][16], "B=100 N=16 bf16")],
           "walk_us_by_n": {n: v["walk_us"] for n, v in dimenet["by_n"].items()}},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


# -- phase 16: DimeNet++ through the captured walk ------------------------------

#: the benchmark's configuration of the condensed network with DimeNet++
#: (published widths, bf16) and, named in it, its committed stand-in weights
DIMENET_CONFIG = os.path.join(ROOT, "portbench", "configs", "tsdiff-condensed-dimenetpp-h128.json")
#: the triplet kernel against its plain version in bf16, of max|ref|, as
#: tests/test_torch_dimenet_triplet.py holds it: the kernel read 4.0e-8 to
#: 2.2e-7 on an H100 (only the sum over k is taken in another order); one
#: bf16 ulp of S or of lin_sbf2's output flipped reads ~1.2e-5; a chain that
#: leaves either rounding out 1.9e-3 to 6.0e-3
TOL_TRIPLET = 1e-4
#: reactions a walk of phase 16, as the campaign's batches
DIMENET_BATCH = 100


def triplet_cost(args: tuple) -> dict:
    """Flop and bytes of one triplet kernel launch on ``args`` (rbf_bes,
    sbf1, cbf, w2, x_kj, dtype): 2 (ns Bb + Bb I + I) a triplet of the
    padded grid and the rw fold; the inputs read once, T written once."""
    rbf_bes, sbf1, cbf, w2, x_kj, _ = args
    B, N, _, ns, nr = rbf_bes.shape
    I, Bb = w2.shape
    flops = 2 * B * N ** 3 * (ns * Bb + Bb * I + I) + 2 * B * N * N * ns * nr * Bb
    read = sum(t.numel() * t.element_size() for t in (rbf_bes, sbf1, cbf, w2, x_kj))
    return {"flops": flops, "bytes": read + x_kj.numel() * 4}


def phase_dimenet_walk(smi: str) -> dict:
    """Phase 16: the condensed network with DimeNet++ at its published
    widths in bf16, with the benchmark's stand-in weights, walked by a
    ``WalkRunner`` (one CUDA graph of the step) over ``PROFILED_WALK`` steps
    of the 5000-step ``ld`` schedule, B=100 synthetic reactions in the N=16
    and the N=24 bucket, under torch.profiler: the triplet kernel once a
    block at each replayed step and at the eager first step by kernel name,
    its counter at the eager step and the recording, no call of the plain
    version; then the four blocks' inputs recorded from a forward at the
    reactions' jittered geometry, the kernel on each against the plain version
    (``TOL_TRIPLET``) and two launches equal bit for bit; the kernel timed
    on the first block's inputs (CUDA events, and device time under
    torch.profiler, which the JSON line keeps) beside its bound and beside
    the plain version's three einsums."""
    import numpy as np
    import torch

    from tsdiff_tpu_torch.config import Config
    from tsdiff_tpu_torch.core.graph import from_numpy_graphs
    from tsdiff_tpu_torch.diffusion.captured import WalkRunner
    from tsdiff_tpu_torch.diffusion.ensemble import make_ensemble
    from tsdiff_tpu_torch.diffusion.sampler import SamplingSettings
    from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
    from tsdiff_tpu_torch.models import dimenetpp, get_model
    from tsdiff_tpu_torch.ops import dimenet_triplet as dt

    with open(DIMENET_CONFIG) as f:
        cfg = json.load(f)
    model_cfg = Config(cfg["model"])
    dev = torch.device("cuda")
    model = get_model(model_cfg, dtype=torch.bfloat16).to(dev).eval()
    model.load_state_dict(torch.load(os.path.join(ROOT, cfg["weights"]), map_location=dev,
                                     weights_only=True))
    blocks = cfg["model"]["encoder"]["num_convs"]
    ensemble = make_ensemble([model])
    schedule = DiffusionSchedule.from_config(model_cfg)
    settings = SamplingSettings(sampling_type="ld", n_steps=5000, step_lr=1e-7, clip=1000.0,
                                timestep_respacing=PROFILED_WALK)
    pool = torch.cuda.graph_pool_handle()
    runners = []        # alive to the end: a graph's pool goes with the last graph that holds it
    out = {"launches": 0, "by_n": {}, "max_abs_err": 0.0}
    for N in (16, 24):
        tag = f"[dimenet] B={DIMENET_BATCH} N={N} bf16"
        batch, pos_jit = kernel_batch(N, seed=1600 + N, count=DIMENET_BATCH)
        runner = WalkRunner(ensemble, schedule, settings, True, pool, step_draws=True)
        runners.append(runner)
        gen = torch.Generator(device="cuda").manual_seed(1600 + N)
        pos_init = torch.randn((DIMENET_BATCH, N, 3), generator=gen, device="cuda")
        noise = torch.randn((runner.n_walk, DIMENET_BATCH, N, 3), generator=gen, device="cuda")
        dt.triplet_sum.launches = dt.triplet_sum_reference.calls = 0
        (pos, nan), prof = profiled_call(lambda: runner.run(batch, pos_init, noise),
                                         device_only=True)
        counter, plain_calls = dt.triplet_sum.launches, dt.triplet_sum_reference.calls
        launched = sum(n for name, n in kernel_counts(prof).items() if "dimenet_triplet" in name)
        walk_ms = sum(ms for ms, _, name in device_kernels(prof, 1) if "dimenet_triplet" in name)
        step_ms = sum(ms for ms, _, _ in device_kernels(prof, runner.n_walk + 1))
        want = blocks * (runner.n_walk + 1)
        print(f"{tag}: a captured walk of {runner.n_walk} steps ({runner.captures} graph) under "
              f"torch.profiler: the triplet kernel launched {launched} times by name (want "
              f"{want}: {blocks} blocks at each replayed step and at the eager first step), "
              f"{walk_ms / max(launched, 1) * 1e3:.2f} us a launch there, {step_ms:.3f} ms of "
              f"device time a step over all kernels; its counter {counter} (want {2 * blocks}: "
              f"the eager first step and the recording), the plain version called {plain_calls} "
              f"times (want 0); NaN flag {nan}")
        if launched != want or counter != 2 * blocks or plain_calls != 0:
            fail(f"{tag}: the walk did not run the triplet kernel once a block a step")
        if nan or not np.isfinite(pos).all():
            fail(f"{tag}: the walk flagged NaN or returned non-finite positions")
        out["launches"] += launched

        # the blocks' inputs from a forward at the reactions' jittered
        # geometry (a walk of PROFILED_WALK steps ends far from it: beyond
        # the cutoff, where the Bessel basis is zero)
        calls = []

        def record(*args):
            calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
            return dt.triplet_sum_reference(*args)

        orig, dimenetpp.triplet_sum = dimenetpp.triplet_sum, record
        try:
            with torch.no_grad():
                model(batch.atom_type, batch.r_feat, batch.p_feat, pos_jit, batch.bond_mat,
                      batch.node_mask)
        finally:
            dimenetpp.triplet_sum = orig
        if len(calls) != blocks or any(c[-1] != torch.bfloat16 for c in calls):
            fail(f"{tag}: recorded {len(calls)} block calls, not {blocks} in bf16")
        err_n = 0.0
        for layer, args in enumerate(calls):
            with torch.no_grad():
                if not dt.takes_kernel(*args):
                    fail(f"{tag}: block {layer}'s inputs do not take the kernel")
                got, again = dt.triplet_sum(*args), dt.triplet_sum(*args)
                want_t = dt.triplet_sum_reference(*args)
            torch.cuda.synchronize()
            err = check_close(f"{tag} block {layer}", got, want_t, "bfloat16",
                              tol=(TOL_TRIPLET, TOL_TRIPLET))
            if not torch.equal(got, again):
                fail(f"{tag} block {layer}: two launches differ")
            err_n = max(err_n, err)
        kernel = lambda: dt.triplet_sum(*calls[0])  # noqa: E731
        library = lambda: dt.triplet_sum_reference(*calls[0])  # noqa: E731
        with torch.no_grad():
            timing = time_and_bound(
                f"dimenet_triplet B={DIMENET_BATCH} N={N} bf16", kernel, library,
                triplet_cost(calls[0]), "bfloat16", library=library,
                library_what="the plain version's three einsums")
            # a launch from Python takes longer on the host than the kernel on
            # the card: the events time the host; the profiler the card
            kernel_dev, library_dev = profiled_ms(kernel), profiled_ms(library)
        print(f"[kernels] dimenet_triplet B={DIMENET_BATCH} N={N} bf16 by device time under "
              f"torch.profiler: the kernel {fmt_ms(kernel_dev)} ms, the einsums "
              f"{fmt_ms(library_dev)} ms")
        timing.update(ms_events=timing["ms"], library_ms_events=timing["library_ms"])
        if kernel_dev is not None and library_dev is not None:
            timing.update(ms=kernel_dev, ms_by="profiler", library_ms=library_dev,
                          library_ms_by="profiler")
        out["by_n"][N] = dict(timing, max_abs_err=err_n, walk_us=walk_ms / launched * 1e3,
                              step_ms=step_ms)
        out["max_abs_err"] = max(out["max_abs_err"], err_n)
    print(f"[dimenet] {smi}: phase 16 done")
    return out


def mesh_nccl() -> None:
    """``python3 chip_smoke.py --mesh-nccl``, on a machine with two or more
    GPUs: phase 11's mesh runs over NCCL alone, two ranks on two GPUs with
    their collectives captured, after what they are held against (the
    build, phase 4's one-process run, the training corpus)."""
    import torch

    if torch.cuda.device_count() < 2:
        fail(f"--mesh-nccl needs two GPUs; this machine shows {torch.cuda.device_count()}")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    phase_build()
    main_path = phase_main_path()
    phase_mesh(main_path, train_setup(), backends=["nccl"])
    print(smi)
    print(json.dumps({"ok": True, "mesh": "nccl"}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:   # one rank of phase 11, started by phase_mesh
        mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    elif sys.argv[1:2] == ["--mesh-nccl"]:
        mesh_nccl()
    elif sys.argv[1:2] == ["--cache-probe"]:   # one process of phase 15 (e)
        cache_probe(sys.argv[2])
    else:
        main()
