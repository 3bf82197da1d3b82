"""The row layout of the wgmma flash-attention kernels, on the CPU
(``flash_attention.box_plan``, the mirror of ``csrc/flash_wgmma.cuh``'s
``ROW_BOXES`` and ``ROW_COLS``).

A row of D bf16 is loaded as 64-column boxes by TMA, which fills the columns
past D with zeros; at D = 96 (phi3-mini) that is two boxes and 32 zero
columns.  Both kernels' arithmetic on that layout is emulated in
``tests/test_torch_flash_bwd.py``.
"""
import math

import numpy as np
import pytest

from repro_torch.kernels import flash_attention as fa
import torch_one_thread  # noqa: F401  (one intra-op thread: tests/torch_one_thread.py)


@pytest.mark.parametrize("D", fa.WGMMA_HEAD_DIMS)
def test_every_column_below_d_is_loaded_exactly_once(D):
    """Boxes start on 64-column edges, one after another; each holds the
    columns of data from its start, so together they load every column
    below D once and no column at or past D."""
    plan = fa.box_plan(D)
    loads = np.zeros(plan.cols, np.int64)
    for x, (c0, n) in enumerate(plan.boxes):
        assert c0 == 64 * x and 0 < n <= 64
        loads[c0:c0 + n] += 1
    assert (loads[:D] == 1).all() and (loads[D:] == 0).all()
    assert plan.cols == 64 * len(plan.boxes) and 0 <= plan.cols - D < 64


def test_head_dim_96_takes_two_boxes_and_32_zero_columns():
    plan = fa.box_plan(96)
    assert plan.boxes == ((0, 64), (64, 32))
    assert plan.cols == 128 and plan.qk_steps == 6 and plan.store_cols == 96
    assert plan.scale == 1 / math.sqrt(96) != 1 / math.sqrt(plan.cols)
    # the whole-box head dims: nothing padded
    assert fa.box_plan(64)[:4] == (((0, 64),), 64, 4, 64)
    assert fa.box_plan(128)[:4] == (((0, 64), (64, 64)), 128, 8, 128)


@pytest.mark.parametrize("D", [16, 32, 48, 80, 160])
def test_box_plan_refuses_the_head_dims_the_wgmma_kernels_do_not_take(D):
    with pytest.raises(ValueError, match="head dims"):
        fa.box_plan(D)
