"""The port's device-resident corpus and prefetcher against the JAX package's
(``tsdiff_tpu/data/resident.py``, ``tsdiff_tpu/data/prefetch.py``) on the same
graphs, on the CPU: the packed arrays, ``nbytes``, the epoch schedule, the
fixed plans and ``gather_batch`` on one plan equal JAX's and equal the host
loader's batch for those indices; a drawn plan is a permutation plus padding
(JAX's PRNG cannot be reproduced, so the draw itself differs);
``CorpusTooLarge`` is raised before any upload; the prefetcher yields the
host loader's batches in order and raises a worker's error again."""

import threading
import time

import numpy as np
import jax
import pytest
import torch

from tsdiff_tpu.data.resident import DeviceResidentData as JaxResident
from tsdiff_tpu.data.resident import gather_batch as jax_gather_batch

from tsdiff_tpu_torch.config import Config
from tsdiff_tpu_torch.core.graph import from_numpy_graphs
from tsdiff_tpu_torch.data import PaddedBatchLoader, TSDataset
from tsdiff_tpu_torch.data.dataset import _empty_graph
from tsdiff_tpu_torch.data.prefetch import Prefetcher, to_device
from tsdiff_tpu_torch.data.resident import (
    FIELDS,
    CorpusTooLarge,
    DeviceResidentData,
    gather_batch,
)
from tsdiff_tpu_torch.data.synthetic import make_corpus
from tsdiff_tpu_torch.diffusion.schedules import DiffusionSchedule
from tsdiff_tpu_torch.models import CondenseEncoderEpsNetwork
from tsdiff_tpu_torch.train import (
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_resident_eval_step,
    make_resident_train_step,
    make_train_step,
)

from test_condensenc import MODEL_CFG

BATCH = 4
BUCKETS = [8, 16, 24]


@pytest.fixture(scope="module")
def corpus():
    graphs = make_corpus(23, seed=5)
    # one graph in the sparse edge_index form, as reference pickles store them
    g = dict(graphs[0])
    bond = g.pop("bond_mat") if "bond_mat" in g else None
    if bond is not None:
        ei = np.stack(np.nonzero(bond))
        g["edge_index"], g["edge_type"] = ei, bond[ei[0], ei[1]]
        graphs[0] = g
    return graphs


def both(graphs, seed=3):
    return (DeviceResidentData(graphs, BATCH, BUCKETS, seed=seed),
            JaxResident(graphs, BATCH, bucket_sizes=BUCKETS, seed=seed))


def test_packing_schedule_and_fixed_plans_match_jax(corpus):
    mine, ref = both(corpus)
    assert mine.nbytes == ref.nbytes
    assert mine.epoch_schedule() == ref.epoch_schedule()
    assert mine.n_graphs == ref.n_graphs and mine.n_batches == ref.n_batches
    assert list(mine.buckets) == list(ref.buckets)
    for b in ref.buckets:
        for k in FIELDS:
            got, want = mine.buckets[b][k], np.asarray(ref.buckets[b][k])
            assert got.dtype == {np.uint8: torch.uint8, np.float32: torch.float32,
                                 np.bool_: torch.bool}[want.dtype.type]
            np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(mine.fixed_plan(b).numpy(), np.asarray(ref.fixed_plan(b)))


def host_batch(graphs, bucket_of, idx, bsize):
    """The host loader's packing of the plan entries ``idx`` of one bucket."""
    members = [g for g in graphs if bucket_of(g) == bsize]
    feat = graphs[0]["r_feat"].shape[-1]
    chosen = [members[i] if i < len(members) else _empty_graph(feat) for i in idx]
    return from_numpy_graphs(chosen, max_nodes=bsize)


@pytest.mark.parametrize("cursor", [0, 1, 5])
def test_gather_batch_matches_jax_and_the_host_loader(corpus, cursor):
    mine, ref = both(corpus)
    for b in ref.buckets:
        jplan = ref.make_plan(b, 2)   # one plan, JAX's draw, given to both
        plan = torch.from_numpy(np.asarray(jplan).astype(np.int64))
        got = gather_batch(mine.buckets[b], plan, cursor, BATCH)
        want = jax_gather_batch(ref.buckets[b], jplan, jax.numpy.int32(cursor), BATCH)
        slot = (cursor % mine.n_batches[b]) * BATCH
        host = host_batch(corpus, lambda g: next(x for x in BUCKETS if len(g["atom_type"]) <= x),
                          plan[slot:slot + BATCH].tolist(), b)
        for k in FIELDS:
            t = getattr(got, k)
            assert t.dtype == getattr(host, k).dtype, k
            np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(want, k)))
            assert torch.equal(t, getattr(host, k)), k


def test_make_plan_is_a_permutation_plus_padding(corpus):
    mine, _ = both(corpus, seed=7)
    for b, M in mine.n_graphs.items():
        plans = [mine.make_plan(b, e) for e in range(3)]
        for p in plans:
            assert p.dtype == torch.int64 and len(p) == mine.n_batches[b] * BATCH
            assert sorted(p[:M].tolist()) == list(range(M))
            assert (p[M:] == M).all()   # the empty row
        assert torch.equal(plans[0], mine.make_plan(b, 0))   # the same (seed, epoch): the same plan
        if M > 3:
            assert not torch.equal(plans[0], plans[1])
    other, _ = both(corpus, seed=8)
    assert any(not torch.equal(mine.make_plan(b, 0), other.make_plan(b, 0))
               for b, M in mine.n_graphs.items() if M > 3)


def test_real_graphs_counts_the_plan_without_padding(corpus):
    mine, _ = both(corpus)
    for b, M in mine.n_graphs.items():
        plan = mine.make_plan(b, 0)
        for c in range(2 * mine.n_batches[b]):
            slot = (c % mine.n_batches[b]) * BATCH
            assert mine.real_graphs(b, c) == int((plan[slot:slot + BATCH] < M).sum())


def test_corpus_too_large_before_any_upload(corpus, monkeypatch):
    uploads = []
    monkeypatch.setattr(DeviceResidentData, "upload", lambda self: uploads.append(self))
    size = DeviceResidentData(corpus, BATCH, BUCKETS, upload=False).nbytes
    with pytest.raises(CorpusTooLarge, match="budget"):
        DeviceResidentData(corpus, BATCH, BUCKETS, max_bytes=size - 1)
    assert uploads == []
    DeviceResidentData(corpus, BATCH, BUCKETS, max_bytes=size)
    assert len(uploads) == 1


def test_upload_is_deferred_and_idempotent(corpus):
    res = DeviceResidentData(corpus, BATCH, BUCKETS, upload=False)
    assert res.buckets == {}
    res.upload()
    first = res.buckets
    assert res.upload().buckets is first and set(first) == set(res.n_graphs)


def test_resident_steps_equal_steps_on_the_gathered_batch(corpus):
    """The resident train and eval steps run the plain steps on the batch
    ``gather_batch`` makes, and advance the cursor by one."""
    cfg = Config({**MODEL_CFG.to_dict(), "feat_dim": corpus[0]["r_feat"].shape[-1],
                  "hidden_dim": 16, "packed_train": True})
    cfg["encoder"] = {**cfg["encoder"], "hidden_dim": 16}
    res = DeviceResidentData(corpus, BATCH, BUCKETS)
    b = res.epoch_schedule()[-1]
    plan = res.make_plan(b, 0)
    batch = gather_batch(res.buckets[b], plan, 1, BATCH)
    schedule = DiffusionSchedule.from_config(cfg)
    losses = []
    for resident in (False, True):
        model = CondenseEncoderEpsNetwork.from_config(cfg, generator=torch.Generator().manual_seed(0))
        tx = make_optimizer(Config(type="adam", beta1=0.9, beta2=0.999), 100.0)
        step = make_train_step(model, tx, schedule)
        state = init_train_state(model, tx)
        gen = torch.Generator().manual_seed(4)
        if resident:
            state, m, cursor = make_resident_train_step(step, BATCH)(
                state, res.buckets[b], plan, 1, 1e-3, generator=gen)
            assert cursor == 2
            ev = make_resident_eval_step(make_eval_step(model, schedule), BATCH)(
                res.buckets[b], plan, 1, generator=torch.Generator().manual_seed(6))
        else:
            state, m = step(state, batch, 1e-3, generator=gen)
            ev = make_eval_step(model, schedule)(batch, generator=torch.Generator().manual_seed(6))
        losses.append((float(m["loss"]), float(ev[0]), float(ev[1])))
    assert losses[0] == losses[1]


def test_prefetcher_yields_the_loaders_batches_in_order(corpus):
    ds = TSDataset(corpus)
    loader = PaddedBatchLoader(ds, BATCH, shuffle=True, bucket_sizes=BUCKETS, seed=2,
                               with_indices=True)
    # a comprehension, not list(): list() asks the loader's len(), which draws a plan
    want = [item for item in PaddedBatchLoader(ds, BATCH, shuffle=True, bucket_sizes=BUCKETS,
                                                seed=2, with_indices=True)]
    got = list(Prefetcher(loader, depth=2,
                          transfer=lambda item: (to_device(item[0], "cpu"), item[1])))
    assert len(got) == len(want)
    for (gb, gi), (wb, wi) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        for k in FIELDS:
            assert torch.equal(getattr(gb, k), getattr(wb, k))


def test_prefetcher_raises_a_workers_error_and_stops_when_closed():
    def items():
        yield 1
        yield 2
        raise KeyError("packing failed")

    it = iter(Prefetcher(items()))
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(KeyError, match="packing failed"):
        next(it)

    def endless():
        i = 0
        while True:
            i += 1
            yield i

    before = threading.active_count()
    it = iter(Prefetcher(endless(), depth=1))
    assert [next(it) for _ in range(3)] == [1, 2, 3]
    it.close()
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
