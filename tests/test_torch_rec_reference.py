"""The port's recognition path against the benchmark's plain reference
(``benchmark/reference/recognition.py``) on the CPU.

``RecognitionPipeline``, built and driven as the benchmark's recognition
cell builds it (``benchmark/drivers/recognition.py``: dispatch, then
collect), runs on 3 seeded synthetic frames of 144x192 from the cell's own
generator, at the cell's configuration but 64 regions a frame (so that the
cap binds and the order of the top-k counts), with the shipped r5 heads and
with six heads drawn from a seed and scaled so that most frames assert
signs.  Boxes, labels and order must be exact, and scores within
:data:`SCORE_TOL`.  That tolerance is tight enough that the reference with
its HOG descriptors cast to bf16, and the benchmark's control (HOG's
contraction and the heads' product with their operands in TF32), fail it,
and the comparison (``numbers``) catches a changed label, a score moved
by 1e-3 and a frame's records dropped.  The reference loads without JAX and
without the program, and the K5 count of the cell's roofline follows its
shapes.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import counts, counts_rec, harness
from benchmark.drivers import recognition as drv
from benchmark.reference import recognition as ref
from benchmark.traffic import make_pool
from opencv_traffic_sign_detector_tpu_torch.config import (
    ClassifierConfig,
    MSERConfig,
    PipelineConfig,
)
from opencv_traffic_sign_detector_tpu_torch.models.lda import LDAParams
from opencv_traffic_sign_detector_tpu_torch.models.recognizer import SignClassifier

# the suite runs several test processes side by side: one intra-op
# thread each keeps torch from oversubscribing the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "rec_mser_hog_lda.gtsdb_b8"
# |score - the reference's|: the port and the reference compute HOG's cell
# contraction and the heads' 324-term products in another order (an einsum
# against a matrix product and a matrix-vector product), which moves a
# probability by a few units of f32 rounding (~6e-8 each); 1e-5 leaves two
# orders of magnitude above that, and a bf16 cast of the features (8 bits of
# mantissa) moves unsaturated probabilities by ~1e-3.
SCORE_TOL = 1e-5


def _cell(classifier: str | None = None) -> tuple[dict, dict]:
    c = harness.cell(CELL)
    config = {**c["config_data"], "max_regions": 64}
    config["limits"] = {"frames_differing": 0, "score_gap": SCORE_TOL}
    if classifier is not None:
        config["classifier"] = classifier
    mix = {**c["traffic_data"], "batch": 3, "pool_batches": 1, "height": 144, "width": 192}
    return config, mix


def _seeded_heads(directory: str, seed: int = 7) -> str:
    """Six heads drawn from ``seed``: class-score rows 0.3 N(0, 1) over
    HOG's 324 features and a sign intercept of 0.6, so that a head's sign
    probability spreads over (0, 1), unsaturated, and most proposals have a
    head that asserts."""
    rng = np.random.default_rng(seed)
    heads = []
    for _ in range(6):
        coef = (0.3 * rng.standard_normal((2, ref.HOG_DIM))).astype(np.float32)
        heads.append(LDAParams(classes=np.array([0, 1]),
                               xbar=np.zeros(ref.HOG_DIM, np.float32),
                               scalings=np.zeros((ref.HOG_DIM, 1), np.float32), coef=coef,
                               intercept=np.array([0.0, 0.6], np.float32)))
    SignClassifier(config=ClassifierConfig.from_string("HOG_LDA_BAYES"), heads=heads).save(
        directory)
    return directory


@dataclasses.dataclass
class Compared:
    kind: str
    config: dict
    mix: dict
    batch: np.ndarray
    got: list
    want: list
    reference: drv.Reference


@pytest.fixture(scope="module")
def compare(tmp_path_factory):
    """``compare(kind)``: the program's and the reference's records of one
    pool batch with the ``shipped`` or the ``seeded`` heads, each made once."""
    made = {}

    def run(kind: str) -> Compared:
        if kind not in made:
            clf = None
            if kind == "seeded":
                clf = _seeded_heads(str(tmp_path_factory.mktemp("heads")))
            config, mix = _cell(clf)
            (batch,) = make_pool(mix, 2**31 + 29)
            prog = drv.Program(config, mix, "cpu")
            got = prog.collect(prog.dispatch(batch))
            reference = drv.Reference(config, mix, "cpu")
            made[kind] = Compared(kind, config, mix, batch, got, reference.records(batch),
                                  reference)
        return made[kind]

    return run


def _numbers(c, got):
    tally = harness.Tally()
    tally.add(0, got)
    return drv.numbers(c.config, c.mix, tally.frames, {0: c.want})


@pytest.mark.parametrize("kind", ["shipped", "seeded"])
def test_the_port_gives_the_references_records(compare, kind):
    c = compare(kind)
    assert [[r[:5] for r in f] for f in c.got] == [[r[:5] for r in f] for f in c.want]
    gap = max((abs(a[5] - b[5]) for f, g in zip(c.got, c.want) for a, b in zip(f, g)),
              default=0.0)
    assert gap <= SCORE_TOL
    assert _numbers(c, c.got) == ({"frames_differing": 0, "score_gap": gap}, 0)
    if c.kind == "seeded":   # most frames assert signs, of several labels
        assert sum(bool(f) for f in c.want) >= 2
        assert len({r[4] for f in c.want for r in f}) >= 2


@pytest.mark.parametrize("kind", ["shipped", "seeded"])
def test_a_bf16_cast_of_the_hog_features_fails_the_tolerance(compare, kind):
    c = compare(kind)
    frames = torch.from_numpy(np.ascontiguousarray(c.batch))
    low = ref.recognize(frames, c.reference.coefs, c.reference.ints, c.reference.params,
                        hog_fn=lambda g, _: ref.hog(g).to(torch.bfloat16).to(torch.float32))
    nums, failed = _numbers(c, low)
    assert failed > 0 and (nums["frames_differing"] > 0 or nums["score_gap"] > SCORE_TOL), nums


@pytest.mark.parametrize("kind", ["shipped", "seeded"])
def test_the_tf32_control_fails_the_tolerance(compare, kind):
    c = compare(kind)
    frames = torch.from_numpy(np.ascontiguousarray(c.batch))
    low = ref.recognize(frames, c.reference.coefs, c.reference.ints, c.reference.params,
                        tf32=True)
    nums, failed = _numbers(c, low)
    assert failed > 0 and (nums["frames_differing"] > 0 or nums["score_gap"] > SCORE_TOL), nums


def _label_changed(frames):
    out = [list(f) for f in frames]
    i = next(i for i, f in enumerate(out) if f)
    x1, y1, x2, y2, t, s = out[i][0]
    out[i][0] = (x1, y1, x2, y2, t % 6 + 1, s)
    return out


def _score_moved(frames):
    out = [list(f) for f in frames]
    i = next(i for i, f in enumerate(out) if f)
    out[i][0] = out[i][0][:5] + (out[i][0][5] - 1e-3,)
    return out


def _records_dropped(frames):
    out = [list(f) for f in frames]
    out[next(i for i, f in enumerate(out) if f)] = []
    return out


@pytest.mark.parametrize("fault", [_label_changed, _score_moved, _records_dropped],
                         ids=["label_changed", "score_moved", "records_dropped"])
@pytest.mark.parametrize("kind", ["shipped", "seeded"])
def test_the_comparison_catches_a_fault(compare, kind, fault):
    c = compare(kind)
    assert any(c.got), "no records to alter: pick another seed"
    nums, failed = _numbers(c, fault(c.got))
    limits = c.config["limits"]
    assert failed == 1 and any(nums[k] > limits[k] for k in limits), nums


def test_the_cells_configuration_is_the_clis_default():
    config = harness.cell(CELL)["config_data"]
    mser = MSERConfig.from_string(config["detector"])
    assert {f.name: config[f.name] for f in dataclasses.fields(MSERConfig)} == \
        dataclasses.asdict(mser)
    cli = PipelineConfig(mser=mser)
    assert (config["rec_grows"], config["no_sign_tol"], config["max_detections"]) == (
        list(cli.rec_grows), cli.no_sign_tol, cli.max_detections)
    assert harness.cell(CELL)["traffic_data"]["batch"] == cli.batch_size
    heads = SignClassifier.load(os.path.join(REPO, config["classifier"])).heads
    assert all(h.coef.shape == (2, ref.HOG_DIM) for h in heads)


def test_the_reference_loads_without_jax_or_the_program():
    code = ("import sys; import benchmark.reference.recognition; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'opencv_traffic_sign_detector_tpu', "
            "'opencv_traffic_sign_detector_tpu_torch'}); print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_k5_count_follows_the_cells_shapes():
    c = harness.cell(CELL)
    s = counts_rec.k5_shape(c["config_data"], c["traffic_data"])
    # 39 levels of 7 (0..266), two rounds of 8 passes a level, each a call
    assert s == {"planes": 16, "h": 802, "w": 1362, "passes": 8, "calls": 78}
    px = 16 * 802 * 1362
    assert counts_rec.k5_bytes(s) == 9 * px and counts_rec.k5_ops(s) == 16 * px
    bound, by = counts_rec.k5_bound_s(c["config_data"], c["traffic_data"])
    assert by == "bytes" and bound == pytest.approx(9 * px / counts.PEAK_HBM_BYTES)
    rolls_only = counts_rec.k5_shape({**c["config_data"], "ccl_jumps": 0}, c["traffic_data"])
    assert (rolls_only["passes"], rolls_only["calls"]) == (16, 39)
