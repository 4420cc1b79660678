"""The level sweep's candidate select (``ops/level_topk.py``) on the CPU.

The kernel pair (``csrc/level_topk.cu``) runs only on a card, where
``chip_smoke.py`` holds it bit for bit against the plain version on these
maps and on the recognition frames.  Here: the plain per-level merge equals
one ``torch.topk`` over the whole ``[L, P]`` map of each frame, zero-byte
fillers and ties included; a model of the kernel pair's algorithm (keep the
nonzero keys above the running n-th, append them in any order, rank them
against the list a chunk at a time, the first level's fillers from its zero
bytes below n) equals the plain version and counts the keys the plain
version counts; the wrapper takes the plain path for CPU tensors without a
build or a launch and refuses what the kernel does not take; and the count
of kept keys reaches the tracer's batch.
"""

import bisect
import random

import pytest
import torch

import opencv_traffic_sign_detector_tpu_torch.config as tcfg
import opencv_traffic_sign_detector_tpu_torch.ops.mser as tmser
from opencv_traffic_sign_detector_tpu_torch.ops import level_topk as lt
from opencv_traffic_sign_detector_tpu_torch.runtime import build as rt
from opencv_traffic_sign_detector_tpu_torch.runtime import trace

torch.set_num_threads(1)

B, P, L, N = 2, 70, 5, 8  # frames, keys a level (2 x 5 x 7), levels, list length


def _maps(kind: str, seed: int = 0) -> list[torch.Tensor]:
    """L byte maps [B, P] of one adversarial kind."""
    g = torch.Generator().manual_seed(seed)
    maps = [torch.zeros((B, P), dtype=torch.uint8) for _ in range(L)]
    if kind == "all zero":  # the list stays fillers
        pass
    elif kind == "fewer than n":
        maps[1][0, 40], maps[3][0, 5], maps[4][1, 69] = 9, 200, 1
    elif kind == "a level evicts part of the list":
        maps[0][:, 10:16] = 50
        maps[2][:, 20:40] = torch.randint(1, 255, (B, 20), generator=g, dtype=torch.uint8)
        maps[4][:, 50:53] = 255
    elif kind == "equal bytes":  # the lower index of [L, P] first
        for t in range(L):
            maps[t][:, 3 * t:3 * t + 4] = 77
        maps[3][:, 60:] = 77
    elif kind == "level 0's lowest indices":  # where the fillers begin
        maps[0][0, :3] = 5
        maps[0][1, [0, 2, 7]] = 9
        maps[2][1, 1] = 4
    elif kind == "one frame dense, one empty":
        for t in range(L):
            maps[t][0] = torch.randint(1, 256, (P,), generator=g, dtype=torch.uint8)
    elif kind == "random sparse":
        for t in range(L):
            hit = torch.rand((B, P), generator=g) < 0.08
            maps[t] = torch.where(hit, torch.randint(1, 256, (B, P), generator=g),
                                  0).to(torch.uint8)
    else:
        raise ValueError(kind)
    return maps


KINDS = ["all zero", "fewer than n", "a level evicts part of the list", "equal bytes",
         "level 0's lowest indices", "one frame dense, one empty", "random sparse"]


def _merged(maps, n=N, merge=lt.level_topk_plain, **kw):
    best, kept = None, torch.zeros((), dtype=torch.int64)
    for t, sb in enumerate(maps):
        best = merge(best, sb, t, n, kept=kept, **kw)
    return best, int(kept)


def _kernel_model(best, sb, t, n, kept, chunk=3, seed=0):
    """csrc/level_topk.cu's algorithm a frame at a time: the compaction's
    keys (nonzero, above the list's n-th, every nonzero at the first level)
    in a shuffled order, as the atomics append them; the first level's list
    its zero bytes below n; chunks ranked against the list."""
    rng = random.Random(seed + t)
    b, p = sb.shape
    low_t = (1 << lt.IDX_BITS) - 1 - t * p
    rows = []
    for f in range(b):
        row = sb[f].tolist()
        thr = -1 if best is None else int(best[f, -1])
        keys = [(v << lt.LEVEL_BITS) | i for i, v in enumerate(row)
                if v and ((v << lt.IDX_BITS) | (low_t - i)) > thr]
        rng.shuffle(keys)
        kept += len(keys)
        mask = (1 << lt.LEVEL_BITS) - 1
        lst = ([low_t - i for i in range(n) if row[i] == 0] if best is None
               else best[f].tolist())
        for off in range(0, len(keys), chunk):
            th = lst[n - 1] if len(lst) == n else -1
            ch = [x for x in (((k >> lt.LEVEL_BITS) << lt.IDX_BITS) | (low_t - (k & mask))
                              for k in keys[off:off + chunk]) if x > th]
            m, nxt = len(lst), [None] * n
            desc = [-x for x in lst]
            for e, x in enumerate(lst + ch):
                r = e if e < m else bisect.bisect_left(desc, -x)
                r += sum(c > x for c in ch)
                if r < n:
                    nxt[r] = x
            lst = nxt[:min(n, m + len(ch))]
        assert len(lst) == n and None not in lst
        rows.append(lst)
    return torch.tensor(rows, dtype=torch.int64)


@pytest.mark.parametrize("kind", KINDS)
def test_the_plain_merge_is_one_topk_over_the_whole_map(kind):
    maps = _maps(kind)
    best, _ = _merged(maps)
    whole = torch.cat([lt.level_keys(sb, t) for t, sb in enumerate(maps)], dim=1)
    assert torch.equal(best, torch.topk(whole, N, dim=1).values)
    assert torch.equal(best, torch.sort(whole, dim=1, descending=True).values[:, :N])


@pytest.mark.parametrize("chunk", [1, 3, 1024])
@pytest.mark.parametrize("kind", KINDS)
def test_the_kernel_models_merge_equals_the_plain_one_and_counts_alike(kind, chunk):
    maps = _maps(kind, seed=3)
    want, want_kept = _merged(maps)
    got, got_kept = _merged(maps, merge=_kernel_model, chunk=chunk, seed=chunk)
    assert torch.equal(got, want)
    assert got_kept == want_kept


def test_the_fillers_are_level_0s_zero_bytes_lowest_first():
    maps = _maps("level 0's lowest indices")
    best, kept = _merged(maps)
    valid = (best >> lt.IDX_BITS) > 0
    flat = (1 << lt.IDX_BITS) - 1 - (best & ((1 << lt.IDX_BITS) - 1))
    assert valid.sum(1).tolist() == [3, 4] and kept == 7
    assert flat[0, 3:].tolist() == [3, 4, 5, 6, 7]  # level 0's zero bytes, 0-2 set
    assert flat[1, 4:].tolist() == [1, 3, 4, 5]     # 0, 2 and 7 set at level 0


def test_cpu_tensors_take_the_plain_path_without_a_build_or_launch(monkeypatch):
    rt.reset_launch_counts()

    def no_library():
        raise AssertionError("built the kernels for CPU tensors")

    monkeypatch.setattr(rt, "library", no_library)
    maps = _maps("random sparse", seed=5)
    assert torch.equal(_merged(maps, merge=lt.level_topk)[0], _merged(maps)[0])
    assert lt.topk_work(B, P, torch.device("cpu")) is None
    assert rt.launch_counts() == dict.fromkeys(rt.KERNELS, 0)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    sb = torch.zeros((B, P), dtype=torch.uint8)
    best = lt.level_topk(None, sb, 0, N)
    with pytest.raises(TypeError):
        lt.level_topk(None, sb.to(torch.int32), 0, N)
    with pytest.raises(ValueError, match="contiguous"):
        lt.level_topk(None, torch.zeros((B, 2 * P), dtype=torch.uint8)[:, ::2], 0, N)
    with pytest.raises(ValueError, match="dims"):
        lt.level_topk(None, sb.reshape(B, 2, P // 2), 0, N)
    with pytest.raises(ValueError, match="keys a frame"):
        lt.level_topk(None, sb, 0, P + 1)
    with pytest.raises(ValueError, match="keys a frame"):
        lt.level_topk(None, sb, 0, 0)
    with pytest.raises(ValueError, match="best"):
        lt.level_topk(best[:, :N - 1].contiguous(), sb, 1, N)
    with pytest.raises(TypeError):
        lt.level_topk(best.to(torch.int32), sb, 1, N)
    with pytest.raises(ValueError, match="index bits"):
        lt.level_topk(best, sb, (1 << lt.IDX_BITS) // P, N)
    with pytest.raises(ValueError, match="counter"):
        lt.level_topk(best, sb, 1, N, kept=torch.zeros(2, dtype=torch.int64))


def test_the_sweeps_kept_keys_reach_the_tracers_batch(monkeypatch):
    maps = _maps("a level evicts part of the list", seed=7)
    monkeypatch.setattr(tmser, "_level_sweep", lambda *a: iter(
        [m.reshape(B, 2, 5, 7) for m in maps]))
    cfg = tcfg.MSERConfig(delta=3, level_step=3, max_regions=N)
    _, want = _merged(maps)
    tracer = trace.TRACER
    with tracer.dispatch() as batch:
        fn, stamps = tracer.stamped(lambda x: tmser._sweep_topk(x, cfg, 1, L), "cpu")
        untraced = tmser._sweep_topk(torch.zeros((B, 2, 5, 7)), cfg, 1, L)
        traced = fn(torch.zeros((B, 2, 5, 7)))
        tracer.record(stamps)
    tracer.resolve(batch)
    assert all(torch.equal(a, b) for a, b in zip(traced, untraced))
    assert stamps.counted and want > N
    assert batch.topk_kept == want and batch.as_dict()["topk_kept"] == want


def test_resolve_adds_the_counters_after_the_stamps_and_leaves_them_none_without():
    tracer = trace.Tracer()
    marks = (("h2d", trace.POINT), ("topk", trace.ENTER), ("topk", trace.EXIT))
    with tracer.dispatch() as batch:
        pass
    batch.pending += [(torch.device("cpu"), torch.tensor([1, 2, 5, 11]), marks),
                      (torch.device("cpu"), torch.tensor([1, 2, 4, 30]), marks)]
    tracer.resolve(batch)
    assert batch.topk_kept == 41
    assert [d.stages_ns for d in batch.devices] == [{"topk": 3}, {"topk": 2}]
    with tracer.dispatch() as bare:
        pass
    bare.pending.append((torch.device("cpu"), torch.tensor([1, 2, 5]), marks))
    tracer.resolve(bare)
    assert bare.topk_kept is None
