"""The JAX protein gate's trained checkpoint sampled by both packages.

``tests/test_protein_gate.py::train_gate_model`` trains the gate's model in
JAX (4000 Adam steps on its fixed batch); its held-out chains are then
regenerated by the JAX package's ``protein_sampling`` CLI and by the port's
(``--device cpu``), each over the sampling seeds 7-12, with the gate's
flags.  The seeds draw different noise in the two packages (JAX keys, torch
generators), so per seed the two differ; pooled over the seeds, the two
samplers' RMSD and chi1 are what the gate reads.  JAX's draws injected
into the port's sampler: through the ladder at one step a level the two
walks agree to float32 rounding; over the gate's 3,000 steps the walk
amplifies rounding, and the port's distance from JAX's walk is printed
beside the port's distance from its own walk with the start moved by 1e-6.
Slow
(minutes on the CPU):

    python -m pytest tests/test_torch_protein_gate.py -m slow -s
"""

import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from tsdiff_tpu.config import Config as JConfig
from tsdiff_tpu.models import get_model as jget_model
from tsdiff_tpu.train import save_checkpoint as jsave
from tsdiff_tpu.train.trainer import TrainState as JState
from tsdiff_tpu_torch.config import Config
from tsdiff_tpu_torch.convert import params_from_jax
from tsdiff_tpu_torch.models import get_model

from test_protein_gate import CFG, train_gate_model
from test_torch_protein import jax_protein_draws

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

SEEDS = (7, 8, 9, 10, 11, 12)
FLAGS = ["--cutoff", "8.0", "--step_lr", "1e-5", "--n_steps", "300"]
#: the walk through the 10 levels at one step each, the port against JAX on
#: the same draws: float32 rounding apart, within this many Angstrom
INJECTED_ATOL = 1e-4


def _sample(cli, ckpt, test_pkl, save_dir, seed, extra=()):
    path = cli.main([ckpt, "--protein_set", test_pkl, "--save_dir", save_dir, *FLAGS,
                     "--seed", str(seed), *extra])
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.slow
def test_both_samplers_on_the_jax_gate_checkpoint(tmp_path):
    from tsdiff_tpu.cli import protein_sampling as jcli
    from tsdiff_tpu.data import load_dataset
    from tsdiff_tpu.diffusion.protein import sample_protein_sidechains as jsample
    from tsdiff_tpu_torch.cli import protein_sampling
    from tsdiff_tpu_torch.diffusion.protein import sample_protein_sidechains

    torch.set_num_threads(4)
    _, params, loss, test_pkl, _ = train_gate_model(tmp_path, 4000)
    ckpt = str(tmp_path / "gate.ckpt")
    jsave(ckpt, JConfig(model=CFG.to_dict()),
          JState(params=params, opt_state=None, step=jax.numpy.asarray(0)))

    runs = {"jax": {}, "port": {}}
    for seed in SEEDS:
        runs["jax"][seed] = _sample(jcli, ckpt, test_pkl, str(tmp_path / f"j{seed}"), seed)
        runs["port"][seed] = _sample(protein_sampling, ckpt, test_pkl,
                                     str(tmp_path / f"t{seed}"), seed, ["--device", "cpu"])
    metrics = {}
    for pkg, by_seed in runs.items():
        per_seed = {s: chip_smoke._gate_metrics(r) for s, r in by_seed.items()}
        pooled = chip_smoke._gate_metrics([r for rs in by_seed.values() for r in rs])
        metrics[pkg] = pooled
        print(f"\n{pkg} sampler, JAX gate checkpoint (final loss {loss:.1f}): per seed "
              + "; ".join(f"{s}: RMSD {m['rmsd']:.3f} chi1 {m['chi1']:.3f}"
                          for s, m in per_seed.items())
              + f"; pooled over {len(SEEDS)} seeds ({pooled['n']} angles): RMSD "
              f"{pooled['rmsd']:.3f} chi1 {pooled['chi1']:.3f} g+ {pooled['gplus']:.3f} "
              f"circ_R {pooled['circ_R']:.3f} | mirror-blind chi1 {pooled['m_chi1']:.3f} "
              f"circ_R {pooled['m_circ_R']:.3f}; NaN flags "
              f"{sum(bool(r['nan']) for rs in by_seed.values() for r in rs)}")

    # the same walks: JAX's draws for the first chain at seed 7 (the CLI's
    # key for protein 0) injected into the port's sampler
    jmodel = jget_model(CFG)
    tmodel = get_model(Config(CFG.to_dict()))
    tmodel.load_state_dict(params_from_jax(jax.device_get(params)))
    graph = load_dataset(test_pkl)[0][0]
    _, key = jax.random.split(jax.random.PRNGKey(SEEDS[0]))
    err = {}
    for n_steps in (1, 300):
        kw = dict(cutoff=8.0, batch_size=8, n_steps=n_steps, step_lr=1e-5, seed=SEEDS[0])
        want, wc, wnan = jsample(jmodel, params, graph, key, **kw)
        got, counts, nan = sample_protein_sidechains(tmodel.eval(), graph,
                                                     draws=jax_protein_draws(key, True), **kw)
        assert not wnan and not nan
        np.testing.assert_array_equal(counts, wc)
        err[n_steps] = float(np.abs(got - want).max())
    # the port against itself, the first batch's unit-variance start moved by 1e-6
    jax_draws = jax_protein_draws(key, True)
    nudged = lambda i, shape, n_walk: tuple(  # noqa: E731
        x + 1e-6 * (i == 0 and j == 0) for j, x in enumerate(jax_draws(i, shape, n_walk)))
    again, _, _ = sample_protein_sidechains(tmodel.eval(), graph, draws=nudged, **kw)
    self_err = float(np.abs(again - got).max())
    print(f"injected JAX draws, chain 0 at seed {SEEDS[0]}, max |port - JAX| over "
          f"{len(graph['pos'])} atoms: {err[1]:.3g} A after one step a level, {err[300]:.3g} A "
          f"after the gate's 300 a level; the port against itself, its start moved by 1e-6: "
          f"{self_err:.3g} A")
    assert err[1] <= INJECTED_ATOL
    # both samplers learn the rotamer well and stay finite
    for pkg in runs:
        assert np.isfinite(metrics[pkg]["rmsd"]) and metrics[pkg]["m_chi1"] >= 0.45
