"""The level sweep's area counts (``ops/mser.py: _anchor_counts``): a row's
run of one component summed before its one add at the anchor gives each
component's pixel count, as one add a pixel does, at every level."""

import pytest
import torch

import opencv_traffic_sign_detector_tpu_torch.ops.mser as tmser
from opencv_traffic_sign_detector_tpu_torch.ops.ccl import propagate_min_keys

torch.set_num_threads(1)


def _per_pixel(keys, mask, idx, plane_off):
    """One add of 1 a masked pixel at its component's anchor."""
    b, p, h, w = mask.shape
    hw = h * w
    slot = torch.where(mask, keys % hw, idx) + plane_off
    counts = torch.zeros(b * p * hw, dtype=torch.int32)
    counts.index_add_(0, slot.reshape(-1), mask.reshape(-1).to(torch.int32))
    return counts.reshape(b, p, h, w)


def _frames(kind: str, gen) -> torch.Tensor:
    """[2, 21, 34] uint8 gray frames of a kind."""
    h, w = 21, 34
    if kind == "noise":
        return torch.randint(0, 256, (2, h, w), generator=gen, dtype=torch.uint8)
    if kind == "stripes":   # vertical bands: runs end at every band's edge
        cols = (torch.arange(w) // 3 * 40 % 256).to(torch.uint8)
        return cols.expand(2, h, w).contiguous()
    if kind == "checker":   # one-pixel components at every level they exist
        yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        return (((yy + xx) % 2) * 200).to(torch.uint8).expand(2, h, w).contiguous()
    if kind == "flat":      # one component the whole plane
        return torch.full((2, h, w), 90, dtype=torch.uint8)
    # rings: components that wrap around others, so a row holds several runs of one
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    r = ((yy - h / 2) ** 2 + (xx - w / 2) ** 2).sqrt()
    return ((r.long() // 3 % 2) * 150 + torch.randint(0, 20, (h, w), generator=gen)).to(
        torch.uint8).expand(2, h, w).contiguous()


@pytest.mark.parametrize("kind", ["noise", "stripes", "checker", "flat", "rings"])
def test_anchor_counts_equal_one_add_a_pixel_at_every_level(kind):
    gen = torch.Generator().manual_seed(31)
    im = tmser.pad_pol(_frames(kind, gen)).to(torch.int32)
    b, p, h, w = im.shape
    hw = h * w
    idx = torch.arange(hw, dtype=torch.int32).reshape(h, w)
    keys0 = im * hw + idx
    plane_off = (torch.arange(b * p) * hw).reshape(b, p, 1, 1)
    big = 256 * hw
    for level in range(0, 267, 7):   # past 255, where the border joins in
        mask = im <= level
        keys = propagate_min_keys(torch.where(mask, keys0, big), mask, big, num_rolls=8,
                                  num_jumps=1, edges_safe=True)
        got = tmser._anchor_counts(keys, mask, idx, plane_off)
        assert torch.equal(got, _per_pixel(keys, mask, idx, plane_off)), level
        assert int(got.sum()) == int(mask.sum())
