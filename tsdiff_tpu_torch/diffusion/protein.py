"""Full-protein sidechain generation through covering subgraphs.

Port of the JAX package's ``diffusion/protein.py``: regenerate every
sidechain of a protein whose backbone is known.  The protein is covered
with alpha-centred residue-complete subgraphs (``data/pdb.py``), padded
batches of them walk the backbone-pinned dual-encoder sampler, and the
sampled sidechain coordinates are written back onto the whole protein.
Since the backbone is pinned to the input frame in every subgraph, every
subgraph samples in the same global frame.  Each residue takes all its
sidechain atoms from one owning subgraph, the one whose centre lies
nearest its CA: overlapping subgraphs draw independent samples, and the
average of two rotamers is no rotamer, so overlaps are resolved by
ownership, never by averaging.

The walk of each batch is a ``WalkRunner`` (``diffusion/captured.py``) on
the dual encoder's ``DualWalk``, one runner per (node count, clip) and one
CUDA graph of its step per batch shape with ``capture``, as the JAX package
compiles its scan once per shape.  Its draws come from the caller's
generator: each batch's unit-variance start, then one draw per step, each
of the batch's real subgraphs only.  On a mesh (``parallel/``) the tail
batch is padded to ``batch_size``, as in the JAX package; each rank packs
and walks its rows, every rank draws the real rows' start and noise, pads
them with zeros and keeps its rows (so ``dp=2`` walks the rows of one
process), and the walk's result is gathered onto every rank before the
ownership logic.
"""

from __future__ import annotations

import numpy as np
import torch


def covering_batches(graph: dict, cutoff: float, batch_size: int, seed: int,
                     pad_batches: bool = False, device="cpu", rows: slice | None = None):
    """Yield ``(chunk, batch)``: the covering subgraphs of ``graph`` (drawn
    with ``np.random.default_rng(seed)``), padded to one node count (a
    multiple of 8) and cut into chunks of ``batch_size``.  ``batch`` carries
    ``is_sidechain``; each subgraph of ``chunk`` carries ``mapping`` (its
    atoms' indices in ``graph``) and ``center`` (the ball's centre atom).
    ``pad_batches`` pads the tail chunk with empty graphs to ``batch_size``;
    ``chunk`` lists only the real subgraphs.  ``rows``: pack only these rows
    of each (padded) batch."""
    from tsdiff_tpu_torch.core.graph import from_numpy_graphs
    from tsdiff_tpu_torch.data.dataset import _empty_graph
    from tsdiff_tpu_torch.data.pdb import cover_protein_with_subgraphs

    rng = np.random.default_rng(seed)
    subs = cover_protein_with_subgraphs(graph, rng, cutoff)
    if not subs:
        return
    n_pad = 8 * ((max(len(s["atom_type"]) for s in subs) + 7) // 8)
    feat_dim = int(subs[0]["r_feat"].shape[-1])
    for start in range(0, len(subs), batch_size):
        chunk = subs[start:start + batch_size]
        graphs = list(chunk)
        if pad_batches:
            graphs += [_empty_graph(feat_dim, sidechain=True)
                       for _ in range(batch_size - len(chunk))]
        if rows is not None:
            graphs = graphs[rows]
        yield chunk, from_numpy_graphs(graphs, max_nodes=n_pad, device=device)


def _pad_draws(pos_init: torch.Tensor, noise, rows: int, n_walk: int):
    """A tail batch's draws padded with zero rows to ``rows``: the step
    noise drawn now, one step at a time as ``WalkRunner`` draws it from a
    generator, so that a mesh's padded tail walks what one process's
    unpadded tail walks."""
    pad = lambda x: torch.cat([x, x.new_zeros((rows - x.shape[0], *x.shape[1:]))])  # noqa: E731
    if isinstance(noise, torch.Generator):
        noise = torch.stack([torch.randn(pos_init.shape, generator=noise,
                                         device=pos_init.device) for _ in range(n_walk)])
    return pad(pos_init), torch.stack([pad(step) for step in noise])


def protein_walk(model, clip: float, schedule=None, n_steps: int | None = None,
                 step_lr: float = 1e-6, global_start_sigma: float = float("inf"),
                 w_global: float = 0.2, sigma_respacing: int | None = None):
    """The ``DualWalk`` of a protein run: for a ``dsm`` model annealed
    Langevin with ``n_steps`` per sigma level (default 100), for a
    ``diffusion`` model ``ld`` over ``n_steps`` of the schedule counted back
    from T (default the whole schedule).  No frame rescale in either mode:
    the pinned backbone keeps the walk in the physical frame."""
    from tsdiff_tpu_torch.diffusion.dual_objective import DualWalk
    from tsdiff_tpu_torch.diffusion.sampler import SamplingSettings

    if model.model_type == "dsm":
        return DualWalk.dsm(model.sigmas, n_steps=100 if n_steps is None else n_steps,
                            step_lr=step_lr, clip=clip, global_start_sigma=global_start_sigma,
                            sigma_respacing=sigma_respacing, w_global=w_global)
    if sigma_respacing is not None:
        raise ValueError("sigma_respacing is the DSM sigma-ladder respacing; diffusion-"
                         "family models use timestep respacing (cli/sampling.py)")
    if schedule is None:
        raise ValueError("diffusion mode needs a schedule")
    T = len(schedule.betas)
    settings = SamplingSettings(sampling_type="ld", n_steps=T if n_steps is None else
                                min(n_steps, T), step_lr=step_lr, clip=clip)
    walk = DualWalk.diffusion(schedule, settings, global_start_sigma, w_global)
    walk.scale = 1.0  # the pinned backbone is physical: no final rescale
    return walk


def sample_protein_sidechains(model, graph: dict, generator: torch.Generator | None = None,
                              schedule=None, cutoff: float = 10.0, batch_size: int = 8,
                              n_steps: int | None = None, step_lr: float = 1e-6,
                              global_start_sigma: float = float("inf"), w_global: float = 0.2,
                              clip: float = 1000.0, seed: int = 0, mesh=None,
                              sigma_respacing: int | None = None, capture: bool = False,
                              runners: dict | None = None, pool=None, draws=None):
    """Regenerate all sidechains of one protein from noise with the dual
    encoder ``model`` (on its device, eval mode).

    ``generator``: the draws, each batch's start ``(rows, n_pad, 3)`` then
    its step noise, one draw of that shape per step.  ``draws(i, shape,
    n_walk) -> (pos_init, noise)`` replaces them for batch ``i`` (tests feed
    another implementation's draws).  ``capture``: each batch shape's step
    replays a CUDA graph (from ``pool``); ``runners``: a dict the caller
    keeps, so that later proteins and the clip-20 retry reuse the runners
    and their graphs.  ``mesh``: a data-parallel mesh of ranks, over which
    the tail batch is padded with empty graphs to ``batch_size``; the draws
    stay those of the real subgraphs, padded with zeros.

    Returns ``(pos (n, 3), counts (n,), nan_flag)``: ``pos`` equals the
    input exactly on the backbone; each residue's sidechain comes from the
    covering subgraph whose centre is nearest its CA (``counts``: how many
    scored subgraphs covered each atom); a subgraph whose walk has a NaN on
    its sidechain is skipped, and atoms no subgraph scored keep their input
    coordinates with count 0."""
    from tsdiff_tpu_torch.diffusion.captured import WalkRunner
    from tsdiff_tpu_torch.diffusion.ensemble import DualEnsemble
    from tsdiff_tpu_torch.diffusion.sampler import SamplingSettings

    device = next(model.parameters()).device
    walk_args = dict(schedule=schedule, n_steps=n_steps, step_lr=step_lr,
                     global_start_sigma=global_start_sigma, w_global=w_global,
                     sigma_respacing=sigma_respacing)
    protein_walk(model, clip, **walk_args)  # the arguments' errors before any work
    runners = {} if runners is None else runners

    n = len(np.asarray(graph["atom_type"]))
    pos_in = np.asarray(graph["pos"], np.float32)
    atom2res = np.asarray(graph["atom2res"])
    pos_out = pos_in.copy()
    counts = np.zeros(n, np.int64)
    # each residue's owner: the covering-ball centre nearest its anchor, the
    # CA (atom2alpha_index), or the residue's centroid where it has none
    n_res = int(atom2res.max()) + 1
    owner_dist = np.full(n_res, np.inf)
    res_anchor = np.zeros((n_res, 3), np.float32)
    a2a = np.asarray(graph.get("atom2alpha_index", -np.ones(n, np.int64)))
    for r in range(n_res):
        in_r = atom2res == r
        ca = a2a[in_r]
        ca = ca[ca >= 0]
        res_anchor[r] = pos_in[ca[0]] if len(ca) else pos_in[in_r].mean(0)
    any_nan = False

    rows = None
    if mesh is not None:
        from tsdiff_tpu_torch.parallel.sharding import batch_spec

        if batch_size % mesh.dp:
            raise ValueError(f"batch_size {batch_size} does not split over dp={mesh.dp}")
        rows = batch_spec(mesh).slice(batch_size)
    batches = covering_batches(graph, cutoff, batch_size, seed, pad_batches=mesh is not None,
                               device=device, rows=rows)
    for i, (chunk, batch) in enumerate(batches):
        n_pad = batch.pos.shape[1]
        key = (n_pad, clip)
        if key not in runners:
            runners[key] = WalkRunner(DualEnsemble([model], protein=True), schedule, SamplingSettings(), capture, pool,
                                      step_draws=True, mesh=mesh,
                                      walk=protein_walk(model, clip, **walk_args))
        runner = runners[key]
        shape = (len(chunk), n_pad, 3)
        if draws is not None:
            pos_init, noise = draws(i, shape, runner.n_walk)
            pos_init, noise = pos_init.to(device), noise.to(device)
        else:
            pos_init = torch.randn(shape, generator=generator, device=device)
            noise = generator
        if mesh is not None and len(chunk) < batch_size:
            pos_init, noise = _pad_draws(pos_init, noise, batch_size, runner.n_walk)
        pos, nan = runner.run(batch, pos_init, noise)
        any_nan |= nan
        for b, s in enumerate(chunk):
            m = len(s["atom_type"])
            scm = np.asarray(s["is_sidechain"], bool)
            idx = s["mapping"][scm]
            if nan and not np.isfinite(pos[b, :m][scm]).all():
                continue  # keep the input coordinates; count no NaN'd prediction
            counts[idx] += 1
            # residues whose anchor lies nearer this subgraph's centre than
            # any earlier owner's take their whole sidechain from this sample
            res_here = np.unique(atom2res[idx])
            d_center = np.linalg.norm(res_anchor[res_here] - pos_in[s["center"]], axis=-1)
            better = d_center < owner_dist[res_here]
            take_res = set(res_here[better].tolist())
            if not take_res:
                continue
            take = np.asarray([int(atom2res[j]) in take_res for j in idx])
            pos_out[idx[take]] = pos[b, :m][scm][take].astype(np.float32)
            owner_dist[res_here[better]] = d_center[better]
    return pos_out, counts, any_nan
