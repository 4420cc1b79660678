"""PyTorch port vs the JAX reference: multi-process scale-out
(``parallel/multihost.py``) and the all-reduce paths of the data mesh.

``host_shard_files`` is host logic, equal to the reference's for 1-8
simulated hosts; ``multihost_batched_frames`` names pad slots
``"__pad__"``.  Real collectives run in gloo process groups of 2 and 8
ranks (``torch.multiprocessing``, one CPU shard or two a rank, joined
through a file store under the test's own directory), each rank holding
against a one-process mesh of the same shards:

* ``psum`` and ``pmean``: exact;
* ``distributed_statistics``: counts exact;
* ``distributed_lda_fit`` and ``fit_classifier_distributed`` heads: within
  1e-4 of the largest coefficient (the ranks' sums meet in another order);
* the SPMD CNN step on 2 ranks of one shard: losses and parameters after
  two steps within 1e-6 of one process of two shards.

No module-level import of JAX: the ranks import this file to find their
worker, and the reference is imported only inside the tests that use it.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import opencv_traffic_sign_detector_tpu_torch.parallel.mesh as tmesh
import opencv_traffic_sign_detector_tpu_torch.parallel.multihost as tmh
from opencv_traffic_sign_detector_tpu_torch.data.synthetic import write_test_dir

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

GROUP_TIMEOUT_S = 240


def test_host_shard_files_equals_reference():
    from opencv_traffic_sign_detector_tpu.parallel.multihost import (
        host_shard_files as ref_host_shard_files,
    )

    for n_files in (150, 7, 1):
        files = [f"{i:05d}.jpg" for i in range(n_files)]
        for pc in range(1, 9):
            for batch in (1, 8):
                for p in range(pc):
                    assert tmh.host_shard_files(files, batch, p, pc) == ref_host_shard_files(
                        files, batch, p, pc), (n_files, pc, batch, p)
    # rank and count default to the process group's: 0 and 1 without one
    assert tmh.host_shard_files(files, 8) == ref_host_shard_files(files, 8, 0, 1)


def test_initialize_distributed_without_coordinator_is_a_no_op(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert tmh.initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("process_index,process_count", [(0, 1), (0, 3), (2, 3), (1, 2)])
def test_multihost_batched_frames_names_pads(tmp_path, process_index, process_count):
    """Each rank yields its slice's frames split over its 2 shards; slots
    past its real files are named ``"__pad__"``; the ranks' real names
    cover the files once, in order."""
    names = write_test_dir(str(tmp_path), 7, 48, 64, seed=5)
    from opencv_traffic_sign_detector_tpu_torch.data.images import load_image_bgr

    mesh = tmesh.data_mesh(2, device="cpu")
    got, steps = [], 0
    for shards, batch_names in tmh.multihost_batched_frames(
            str(tmp_path), names, 4, mesh, process_index=process_index,
            process_count=process_count):
        assert len(shards) == 2 and all(s.shape == (2, 48, 64, 3) for s in shards)
        frames = torch.cat(shards).numpy()
        for f, n in zip(frames, batch_names):
            if n != "__pad__":
                np.testing.assert_array_equal(f, load_image_bgr(str(tmp_path / n)))
        got += batch_names
        steps += 1
    shard = tmh.host_shard_files(names, 4, process_index, process_count)
    assert steps == len(shard) // 4 and len(got) == len(shard)
    per = -(-len(names) // process_count)
    real = names[process_index * per:(process_index + 1) * per]
    assert [n for n in got if n != "__pad__"] == real
    assert got[len(real):] == ["__pad__"] * (len(got) - len(real))


# --- gloo process groups ---------------------------------------------------------


def _run_group(world: int, local: int, store: str, kind: str) -> None:
    """``world`` ranks of ``_rank`` in processes of their own; raises what a
    rank raised, or after GROUP_TIMEOUT_S."""
    ctx = mp.start_processes(_rank, args=(world, local, store, kind), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"gloo group of {world} ranks still running after "
                                   f"{GROUP_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)


def _rank(rank: int, world: int, local: int, store: str, kind: str) -> None:
    torch.set_num_threads(1)
    assert tmh.initialize_distributed(f"file://{store}", world, rank, device="cpu")
    try:
        mesh = tmesh.data_mesh(local, device="cpu")
        assert (mesh.rank, mesh.world, mesh.shards) == (rank, world, world * local)
        alone = tmesh.Mesh((torch.device("cpu"),) * mesh.shards)  # one process, no group
        _collectives(mesh, alone)
        if kind == "cnn":
            _cnn_step(mesh, alone)
    finally:
        dist.destroy_process_group()


def _collectives(mesh, alone) -> None:
    from opencv_traffic_sign_detector_tpu_torch.config import ClassifierConfig
    from opencv_traffic_sign_detector_tpu_torch.eval.device_stats import distributed_statistics
    from opencv_traffic_sign_detector_tpu_torch.parallel.train import (
        distributed_lda_fit,
        fit_classifier_distributed,
    )

    rank, local = mesh.rank, mesh.size
    # psum and pmean: shard k of the mesh holds k
    parts = [torch.tensor([float(mesh.shard_index(i)), 1.0]) for i in range(local)]
    n = mesh.shards
    assert tmesh.psum(mesh, parts).tolist() == [n * (n - 1) / 2, n]
    assert tmesh.pmean(mesh, parts).tolist() == [(n - 1) / 2, 1.0]
    assert tmesh.psum(mesh, [torch.tensor([rank])] * local).item() == local * sum(
        range(mesh.world))

    # the statistics fit: every rank holds the whole (seeded) data
    rng = np.random.default_rng(13)
    X = rng.normal(0, 1, (n * 20, 16)).astype(np.float32)
    y = rng.integers(0, 7, len(X)).astype(np.int32)
    for c in range(7):
        X[y == c, c] += 4.0
    w = np.ones(len(X), np.float32)

    def fit(m):
        return distributed_lda_fit(m)(*(tmesh.shard_batch(m, tmesh.rank_slice(m, a))
                                        for a in (X, y, w)))

    for got, want in zip(fit(mesh), fit(alone)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * want.abs().max().item())
    feats = {0: X[y == 0]}
    feats.update({t: X[y == t][: 5 + 3 * t] for t in range(1, 7)})
    cfg = ClassifierConfig.from_string("HOG_LDA_LDABAYES")
    for g, a in zip(fit_classifier_distributed(feats, cfg, mesh).heads,
                    fit_classifier_distributed(feats, cfg, alone).heads):
        np.testing.assert_allclose(g.coef, a.coef, rtol=0, atol=1e-4 * np.abs(a.coef).max())
        np.testing.assert_allclose(g.intercept, a.intercept, rtol=0,
                                   atol=1e-4 * np.abs(a.intercept).max())

    # detection counts
    b = n * 2
    db = rng.integers(0, 700, (b, 16, 4)).astype(np.int32)
    db[..., 2:] = db[..., :2] + rng.integers(20, 60, (b, 16, 2))
    dt = rng.integers(1, 7, (b, 16)).astype(np.int32)
    dv = rng.random((b, 16)) < 0.5
    gt = np.where(rng.random((b, 8)) < 0.7, dt[:, :8], 0).astype(np.int32)
    batch = (db, dt, dv, db[:, :8].copy(), gt)

    def counts(m):
        return distributed_statistics(m)(*(tmesh.shard_batch(m, tmesh.rank_slice(m, a))
                                           for a in batch))

    for got, want in zip(counts(mesh), counts(alone)):
        assert torch.equal(got, want)
    assert tmh.host_shard_files(list("abcdefg"), 2) == tmh.host_shard_files(
        list("abcdefg"), 2, rank, mesh.world)
    try:
        tmesh.data_mesh(devices=["cuda:0"])
    except ValueError as e:
        assert "reduces over nccl, not gloo" in str(e)
    else:
        raise AssertionError("a CUDA mesh took a gloo group")


def _cnn_step(mesh, alone) -> None:
    from opencv_traffic_sign_detector_tpu_torch.data.synthetic import make_labelled_frames
    from opencv_traffic_sign_detector_tpu_torch.models import cnn_detector as cd
    from opencv_traffic_sign_detector_tpu_torch.models import cnn_train as ct
    from opencv_traffic_sign_detector_tpu_torch.parallel.cnn import (
        make_spmd_cnn_train_step,
        put_sharded_cnn_dataset,
        shard_cnn_dataset,
    )

    frames, found = make_labelled_frames(mesh.shards, 480, 640, seed=3)
    data = shard_cnn_dataset(ct.pack_dataset(frames, found), mesh.shards)
    cfg = ct.TrainConfig(batch_size=1, steps=4, warmup_steps=1, lr=1e-3)
    model_cfg = cd.CNNDetectorConfig(arch="slim", dtype="float32", stem_features=16,
                                     mid_features=24, deep_features=32, head_features=24)
    runs = []
    for m in (mesh, alone):
        model = cd.init_params(cd.SignCenterNet(model_cfg), 0)
        step = make_spmd_cnn_train_step(m, model_cfg, cfg)
        sharded = put_sharded_cnn_dataset(m, data)
        losses = [step(model, sharded, s)["loss"].item() for s in range(2)]
        runs.append((losses, cd.flat_params(model)))
    (losses, params), (want_losses, want_params) = runs
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    for k, v in want_params.items():
        np.testing.assert_allclose(params[k], v, rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("world,local,kind", [(2, 1, "cnn"), (2, 2, "collectives"),
                                              (8, 1, "collectives")])
def test_gloo_group_reductions(tmp_path, world, local, kind):
    """``world`` ranks of ``local`` CPU shards each: the reduction helper,
    the statistics fits and the detection counts over the group equal one
    process's mesh of the same shards; on 2 ranks also the SPMD CNN step."""
    _run_group(world, local, str(tmp_path / "store"), kind)
