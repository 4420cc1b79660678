"""The crop kernel's premise and its taps, on the CPU (``csrc/crop_resize.cu``).

The kernel runs only on a card, where ``chip_smoke.py`` holds it exact
against the window path's hat-weight products.  Here: each sample's hat
weights over the 192 window rows (or columns) are exactly 0 but at
floor(rel) and floor(rel) + 1, the second only inside the window, and equal
the kernel's two-tap weights bit for bit; a model of the kernel's reads (the
frame at the window origin plus each tap, no window gathered) equals the
dense products in float64, where every product is exact and each two-term
sum rounds once in any order; and the wrapper takes the plain path for CPU
tensors, building and launching nothing.
"""

import numpy as np
import pytest
import torch

from opencv_traffic_sign_detector_tpu_torch.ops import resize
from opencv_traffic_sign_detector_tpu_torch.runtime import build as rt

torch.set_num_threads(1)

WIN = resize._CROP_WIN


def _two_taps(rel: torch.Tensor):
    """The kernel's taps: k = floor(rel) and the f32 weights of rows k and
    k + 1 by the plain expression, k + 1's 0 where it lies past the window."""
    k = torch.floor(rel)
    lo = torch.clamp(1.0 - torch.abs(rel - k), min=0.0)
    hi = torch.clamp(1.0 - torch.abs(rel - (k + 1)), min=0.0)
    return k.long(), lo, torch.where(k + 1 < WIN, hi, torch.zeros_like(hi))


def _up(x, n=1):
    x = np.float32(x)
    for _ in range(n):
        x = np.nextafter(x, np.float32(np.inf))
    return float(x)


def _down(x):
    return float(np.nextafter(np.float32(x), np.float32(-np.inf)))


REL = {
    "integral": [0.0, 1.0, 17.0, 100.0, 189.0, 190.0],
    "tiny fractions": [_up(0.0), _up(1.0), _up(37.0, 3), _up(190.0), 1 + 2.0 ** -20,
                       _down(1.0), _down(38.0), _down(190.0), _down(191.0)],
    "halves": [0.5, 12.5, 95.5, 189.5, 190.5],
    "exactly 191": [191.0],
    "clamped": [-3.7, -0.0, -1e6, 191.2, _up(191.0), 250.0, 1e6],
}


@pytest.mark.parametrize("kind", list(REL))
def test_hat_weights_are_the_two_taps(kind):
    rel = torch.tensor(REL[kind], dtype=torch.float32)
    if kind == "clamped":  # as _window_coords clamps to the window
        rel = torch.clamp(rel, 0.0, WIN - 1.0)
    ry = resize._hat_weights(rel)
    k, lo, hi = _two_taps(rel)
    assert ry.shape == (len(rel), WIN) and ry.dtype == torch.float32
    bits = ry.view(torch.int32)
    for i in range(len(rel)):
        ki = int(k[i])
        assert 0 <= ki <= WIN - 1
        assert set(torch.nonzero(ry[i]).flatten().tolist()) <= {ki, ki + 1}
        assert bits[i, ki] == lo[i].view(torch.int32) and lo[i] > 0
        if ki + 1 < WIN:
            assert bits[i, ki + 1] == hi[i].view(torch.int32)
        else:
            assert hi[i] == 0
        rest = torch.ones(WIN, dtype=torch.bool)
        rest[ki:ki + 2] = False
        assert (bits[i][rest] == 0).all()  # +0.0 exactly: the sums add exact zeros


def _random_boxes(b, n, h, w, seed, big=False):
    rng = np.random.default_rng(seed)
    x1 = rng.integers(-20, w + 5, (b, n))
    y1 = rng.integers(-20, h + 5, (b, n))
    lo, hi = (193, 500) if big else (0, 200)
    side = rng.integers(lo, hi, (2, b, n))
    return torch.from_numpy(np.stack([x1, y1, x1 + side[0], y1 + side[1]], -1).astype(np.int32))


def _edge_boxes(b, h, w):
    cases = [(-5, -5, 30, 40), (w - 30, h - 20, w + 10, h + 5), (0, h - 1, 25, h),
             (w - 1, 0, w, 25), (w - 1, h - 1, w, h), (0, 0, w, h), (-50, -50, w + 50, h + 50),
             (0, 0, 0, 0), (17, 23, 18, 24), (17, 23, 17, 80), (w + 3, 10, w + 40, 50),
             (w - 192, 0, w, 192), (0, h - 192, 193, h)]
    return torch.tensor(cases, dtype=torch.int32)[None].expand(b, -1, -1).contiguous()


def _whole_boxes(b, h, w, seed):
    rng = np.random.default_rng(seed)
    sides = np.stack([rng.integers(1, w + 1, b), rng.integers(1, h + 1, b)], -1)
    return torch.from_numpy(np.concatenate([np.zeros_like(sides), sides], -1)
                            .astype(np.int32)[:, None])


def _taps_model(image, boxes, s, reciprocal):
    """The kernel's reads in float64: each sample's rows k, k + 1 and
    columns k, k + 1 straight from the frame at the window's origin (the
    second tap, where it lies past the window, at weight 0), the row pass's
    two tap columns rounded to f32 as the first product stores them, then
    the column pass."""
    b, h, w, c = image.shape
    wy0, wx0, rel_y, rel_x = resize._window_coords(boxes, h, w, s, reciprocal)
    ky, ylo, yhi = _two_taps(rel_y)
    kx, xlo, xhi = _two_taps(rel_x)
    img = image.to(torch.float64)
    frame = torch.arange(b)[:, None, None, None]

    def taps(dy, dx):
        ys = wy0[..., None] + (ky + dy).clamp(max=WIN - 1)
        xs = wx0[..., None] + (kx + dx).clamp(max=WIN - 1)
        return img[frame, ys[..., :, None], xs[..., None, :]]  # [B, N, S, S, C]

    wlo, whi = ylo.double()[..., :, None, None], yhi.double()[..., :, None, None]
    t_lo = (wlo * taps(0, 0) + whi * taps(1, 0)).float().double()
    t_hi = (wlo * taps(0, 1) + whi * taps(1, 1)).float().double()
    return xlo.double()[..., None, :, None] * t_lo + xhi.double()[..., None, :, None] * t_hi


def _dense(image, boxes, s, reciprocal):
    """The window path's two products over whole windows, in float64."""
    b, h, w, c = image.shape
    wy0, wx0, rel_y, rel_x = resize._window_coords(boxes, h, w, s, reciprocal)
    ar = torch.arange(WIN)
    frame = torch.arange(b)[:, None, None, None]
    wins = image[frame, (wy0[..., None] + ar)[..., :, None],
                 (wx0[..., None] + ar)[..., None, :]].to(torch.float64)
    ry = resize._hat_weights(rel_y).double()
    rx = resize._hat_weights(rel_x).double()
    tmp = torch.einsum("bnik,bnkxc->bnixc", ry, wins).float().double()
    return torch.einsum("bnjx,bnixc->bnijc", rx, tmp)


def _frames(b, h, w, c, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (b, h, w, c), dtype=np.uint8))


CASES = {  # frames (b, h, w, c), out_size, reciprocal, boxes
    "main path": ((2, 256, 320, 3), 25, True, lambda b, h, w: _random_boxes(b, 24, h, w, 1)),
    "C 1, out 32, divided": ((2, 200, 300, 1), 32, False,
                             lambda b, h, w: _random_boxes(b, 24, h, w, 2)),
    "one window, edges": ((2, 192, 192, 3), 25, True, _edge_boxes),
    "edges, C 1": ((2, 250, 400, 1), 25, False, _edge_boxes),
    "boxes over 192 px, out 64": ((2, 200, 400, 3), 64, True,
                                  lambda b, h, w: _random_boxes(b, 6, h, w, 3, big=True)),
    "whole images": ((12, 320, 288, 3), 25, False, lambda b, h, w: _whole_boxes(b, h, w, 4)),
    "out 1": ((2, 300, 250, 3), 1, True, lambda b, h, w: _random_boxes(b, 24, h, w, 5)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_taps_model_equals_dense_products(case):
    (b, h, w, c), s, reciprocal, make = CASES[case]
    image = _frames(b, h, w, c, seed=len(case))
    boxes = make(b, h, w)
    model = _taps_model(image, boxes, s, reciprocal)
    dense = _dense(image, boxes, s, reciprocal)
    assert model.shape == dense.shape == (b, boxes.shape[1], s, s, c)
    assert torch.equal(model, dense)
    # the f32 window path lies within one count of it (its sums round in f32)
    plain = resize.crop_resize_window_plain(image, boxes, s, reciprocal).to(torch.int64)
    assert (plain - torch.round(model).clamp(0, 255).to(torch.int64)).abs().max() <= 1


def test_cpu_crops_take_the_plain_path_without_a_launch():
    rt.reset_launch_counts()
    image = _frames(2, 256, 320, 3, seed=9)
    boxes = _random_boxes(2, 24, 256, 320, seed=10)
    want = resize.crop_resize_window_plain(image, boxes, 25, True)
    got = resize.crop_and_resize(image, boxes, 25)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert torch.equal(resize.crop_resize_window(image, boxes, 25), got)
    gray = image[..., 0].contiguous()
    assert torch.equal(resize.crop_and_resize(gray, boxes, 32, reciprocal=False),
                       resize.crop_resize_window_plain(gray[..., None], boxes, 32, False)[..., 0])
    assert rt.launch_counts() == dict.fromkeys(rt.KERNELS, 0)
    assert not rt.is_loaded()
