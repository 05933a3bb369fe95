"""The yardstick's arithmetic against hand counts."""

import json

import numpy as np
import pytest

from portbench.harness import BENCH_DIR
from portbench.yardstick import arith


def _cfg(name):
    with open(BENCH_DIR / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_vgg_flops_match_the_hand_count():
    cfg = _cfg("vgg16_largefov")
    # conv1_1 .. conv5_3 at 321 / 161 / 81 / 41 and the four heads at 41:
    # 160.2 GFLOP forward per image, ~481 to train (3x, less conv1_1's data gradient)
    assert arith.forward_flops(cfg, 321) / 1e9 == pytest.approx(160.24, abs=0.01)
    assert arith.train_flops(cfg, 321) / 1e9 == pytest.approx(480.37, abs=0.01)
    hand = 2 * 321 ** 2 * 3 * 9 * 64
    assert arith.train_flops(cfg, 321) == pytest.approx(3 * arith.forward_flops(cfg, 321) - hand)


def test_resnet_flops_match_the_hand_count():
    cfg = _cfg("resnet101_deeplabv2")
    # conv1 at 161, res2 at 81, res3-res5 and four 3x3 heads at 41
    conv1 = 2 * 161 ** 2 * 3 * 49 * 64
    heads = 4 * 2 * 41 ** 2 * 2048 * 9 * 21
    assert arith.forward_flops(cfg, 321) / 1e9 == pytest.approx(150.27, abs=0.01)
    shapes = arith.conv_shapes(cfg, 321)
    assert shapes[0][1] == 161 and shapes[-1][1] == 41
    assert 2.0 * 3 * 49 * 64 * shapes[0][1] ** 2 == conv1
    assert sum(2.0 * c.cin * c.k ** 2 * c.cout * h * w for c, h, w in shapes[-4:]) == heads
    assert len(shapes) == 1 + 4 + 3 * (3 + 4 + 23 + 3) + 4


def test_pool_backward_bytes():
    cfg = _cfg("vgg16_largefov")
    shapes = arith.max_pool_shapes(cfg, 321, 20)
    assert [y[2] for _, y in shapes] == [161, 81, 41, 41, 41]
    pool1 = 4 * (2 * 20 * 64 * 321 ** 2 + 20 * 64 * 161 ** 2)
    assert pool1 / 1e9 == pytest.approx(1.19, abs=0.005)
    total = arith.pool_backward_bytes(cfg, 321, 20)
    assert total / 1e9 == pytest.approx(2.502, abs=0.001)
    assert 1e3 * total / arith.PEAK_BYTES == pytest.approx(0.747, abs=0.001)
    assert arith.pool_backward_bytes(_cfg("resnet101_deeplabv2"), 321, 20) == 4 * (2 * 20 * 64 * 161 ** 2
                                                                                  + 20 * 64 * 81 ** 2)


def test_mmgrid_bytes_count_the_reached_cells():
    # one tile of 40 x 40 px of one colour reaches 8 cells; the slab is gc^3 C fp32
    canvas = np.full((1, 40, 40, 3), 100, np.uint8)
    splat, slice_ = arith.mmgrid_bytes(canvas, 21)
    px, gc = 1600, 21
    assert splat == 16 * px + 4 * px + 4 * 21 * px + 4 * gc ** 3 * 21
    assert slice_ == 16 * px + 2 * 8 * 21 + 4 * 21 * px
    # two colours in the tile that share no bin: 16 cells
    canvas[0, :20] = 10
    assert arith.mmgrid_bytes(canvas, 1)[1] == 16 * px + 2 * 16 + 4 * px


def test_the_configuration_files_describe_the_reference():
    """The widths and strides the files state are the ones the reference runs."""
    from portbench.reference import models

    vgg, res = _cfg("vgg16_largefov"), _cfg("resnet101_deeplabv2")
    assert vgg["pool_strides"] == list(models.VGG_POOL_STRIDES)
    assert vgg["conv5_dilation"] == models.VGG_STAGES[-1][3]
    assert res["widths"] == list(models.RESNET_WIDTHS) and res["dilations"] == list(models.RESNET_DILATIONS)
    assert res["expansion"] == 4 and res["frozen_bn"]
    assert {c.name for c in models.convs(vgg)} >= {"fc6_4", "fc7_4", "fc8-SEC_4"}
