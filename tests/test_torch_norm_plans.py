"""The GroupNorm plans (`ops.groupnorm.groupnorm_plan`), pure functions of
the shape and the direction: every ResNet-50 GroupNorm gets the one-pass
launch, forward and backward (whose blocks hold x's and g's tiles),
within the card's block and cluster limits, its spans hold whole groups
and whole 32-byte sectors, and a slab too large for a cluster keeps the
two launches. The LayerNorm backward's grid
(`ops.layernorm.layernorm_bwd_blocks`), a function of the rows and the
card's SM count alone. Runs on the CPU: nothing here launches a
kernel."""

import pytest

from tf_yarn_tpu_torch.ops import groupnorm as t_groupnorm
from tf_yarn_tpu_torch.ops import layernorm as t_layernorm

# (HW, C) of ResNet-50's 53 GroupNorms a step at batch 128, 32 groups,
# with how many of each (models/resnet.py: the stem, then stages of 3, 4,
# 6 and 3 bottlenecks).
RESNET50_SHAPES = {
    (112 * 112, 64): 1,
    (56 * 56, 64): 6, (56 * 56, 256): 4, (56 * 56, 128): 1,
    (28 * 28, 128): 7, (28 * 28, 512): 5, (28 * 28, 256): 1,
    (14 * 14, 256): 11, (14 * 14, 1024): 7, (14 * 14, 512): 1,
    (7 * 7, 512): 5, (7 * 7, 2048): 4,
}


def test_resnet50_shapes_are_the_53_groupnorms_of_a_step():
    assert sum(RESNET50_SHAPES.values()) == 53
    assert len(RESNET50_SHAPES) == 12


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("hw, c", sorted(RESNET50_SHAPES))
def test_resnet50_groupnorms_get_one_pass_plans(hw, c, itemsize):
    groups, cg = 32, c // 32
    plan = t_groupnorm.groupnorm_plan(128, hw, c, groups, itemsize)
    assert plan.one_pass and plan.launches == 1
    assert 1 <= plan.cluster <= t_groupnorm.MAX_CLUSTER
    assert plan.smem <= t_groupnorm.MAX_SMEM == 227 * 1024
    assert plan.smem == t_groupnorm.one_pass_smem(plan.rows, plan.span, cg,
                                                  itemsize, plan.threads)
    # Whole groups, whole 32-byte sectors, spans that tile the channels.
    assert plan.span % cg == 0 and c % plan.span == 0
    assert plan.span * itemsize % 32 == 0
    nv = plan.span * itemsize // 16
    assert plan.threads in t_groupnorm.BLOCKS and plan.threads % nv == 0
    # The cluster's blocks cover every row, none of them empty.
    assert (plan.cluster - 1) * plan.rows < hw <= plan.cluster * plan.rows


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
def test_stem_spreads_over_a_cluster_and_last_stage_fits_a_block(itemsize):
    stem = t_groupnorm.groupnorm_plan(128, 112 * 112, 64, 32, itemsize)
    last = t_groupnorm.groupnorm_plan(128, 7 * 7, 2048, 32, itemsize)
    assert stem.cluster > 1
    assert last.cluster == 1


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
def test_huge_slab_keeps_the_two_launches(itemsize):
    plan = t_groupnorm.groupnorm_plan(1, 256 * 256, 64, 32, itemsize)
    assert not plan.one_pass and plan.launches == 2
    assert plan.span == 64 and plan.cluster == 1 and plan.smem == 0
    assert plan.threads == 256
    assert plan.chunks * plan.rows >= 256 * 256 > (plan.chunks - 1) * plan.rows


@pytest.mark.parametrize("b, hw, c, groups, one_pass", [
    (2, 25, 6, 3, False),    # no span of whole groups is 32 bytes wide
    (3, 50, 96, 3, True),
    (2, 196, 256, 1, True),  # one group: a span of all 256 channels
    (2, 64, 64, 64, True),   # one channel a group
])
def test_plan_takes_odd_shapes_by_shape_alone(b, hw, c, groups, one_pass):
    for itemsize in (2, 4):
        plan = t_groupnorm.groupnorm_plan(b, hw, c, groups, itemsize)
        assert plan.one_pass == one_pass
        assert plan == t_groupnorm.groupnorm_plan(b, hw, c, groups, itemsize)


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("hw, c", sorted(RESNET50_SHAPES))
def test_resnet50_groupnorms_get_one_pass_dx_plans(hw, c, itemsize):
    """The backward's plan: one pass over x and g (its launch and the
    dscale/dbias sums) within the card's limits, both tiles counted."""
    groups, cg = 32, c // 32
    plan = t_groupnorm.groupnorm_plan(128, hw, c, groups, itemsize,
                                      backward=True)
    assert plan.backward and plan.one_pass and plan.launches == 2
    assert 1 <= plan.cluster <= t_groupnorm.MAX_CLUSTER
    assert plan.smem <= t_groupnorm.MAX_SMEM == 227 * 1024
    assert plan.smem == t_groupnorm.one_pass_smem(
        plan.rows, plan.span, cg, itemsize, plan.threads, backward=True)
    # x's and g's tiles, each [rows, span], beside the f32 sums.
    assert plan.smem > 2 * plan.rows * plan.span * itemsize
    assert plan.span % cg == 0 and c % plan.span == 0
    assert plan.span * itemsize % 32 == 0
    nv = plan.span * itemsize // 16
    assert plan.threads in t_groupnorm.BLOCKS and plan.threads % nv == 0
    assert (plan.cluster - 1) * plan.rows < hw <= plan.cluster * plan.rows


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
def test_stem_dx_takes_a_32_byte_span_over_8_blocks(itemsize):
    """At the stem one image's x and g are 3.2 MB in bf16, more than a
    cluster holds: a 32-byte span (8 whole groups in bf16, 4 in f32) over
    8 blocks of ~100 KB, twice the forward's tile bytes a channel."""
    plan = t_groupnorm.groupnorm_plan(128, 112 * 112, 64, 32, itemsize,
                                      backward=True)
    forward = t_groupnorm.groupnorm_plan(128, 112 * 112, 64, 32, itemsize)
    assert plan.span * itemsize == 32 and plan.cluster == 8
    assert plan.span * 2 == forward.span
    last = t_groupnorm.groupnorm_plan(128, 7 * 7, 2048, 32, itemsize,
                                      backward=True)
    assert last.cluster == 1


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("b, hw, c, groups", [
    (1, 256 * 256, 64, 32),  # the huge slab: no cluster holds it
    (2, 25, 6, 3),           # c6: no span of whole groups is 32 bytes wide
])
def test_dx_plan_keeps_the_two_launch_path(b, hw, c, groups, itemsize):
    plan = t_groupnorm.groupnorm_plan(b, hw, c, groups, itemsize,
                                      backward=True)
    assert not plan.one_pass and plan.launches == 3
    assert plan.span == c and plan.cluster == 1 and plan.smem == 0
    assert plan.chunks * plan.rows >= hw > (plan.chunks - 1) * plan.rows


@pytest.mark.parametrize("b, hw, c, groups, one_pass", [
    (3, 50, 96, 3, True),
    (2, 196, 256, 1, True),  # one group: a span of all 256 channels
    (2, 64, 64, 64, True),   # one channel a group
    (512, 49, 512, 32, True),
])
def test_dx_plan_takes_odd_shapes_by_shape_alone(b, hw, c, groups, one_pass):
    for itemsize in (2, 4):
        plan = t_groupnorm.groupnorm_plan(b, hw, c, groups, itemsize,
                                          backward=True)
        assert plan.one_pass == one_pass
        assert plan == t_groupnorm.groupnorm_plan(b, hw, c, groups, itemsize,
                                                  backward=True)
        assert plan.smem <= t_groupnorm.MAX_SMEM


# Rows of one call: one, fewer than a block's warps, BERT-base's (32 x
# 128 tokens) and ViT-B/16's (128 x 197), on the H100's 132 SMs and a
# smaller card.
@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("rows", [1, 7, 333, 32 * 128, 128 * 197])
def test_layernorm_backward_grid_is_the_rows_capped_by_the_card(rows, sms):
    """Every block has rows to walk, each warp BWD_ROWS_PER_WARP rows
    unless the card's cap on blocks gives it more, and the partials' rows
    (one a block) stay at most BWD_BLOCKS_PER_SM for each SM, so their
    second pass is small."""
    blocks = t_layernorm.layernorm_bwd_blocks(rows, sms)
    warps = t_layernorm.BWD_WARPS
    per_block = warps * t_layernorm.BWD_ROWS_PER_WARP
    assert 1 <= blocks <= t_layernorm.BWD_BLOCKS_PER_SM * sms
    assert (blocks - 1) * per_block < rows
    if blocks < t_layernorm.BWD_BLOCKS_PER_SM * sms:
        assert blocks * per_block >= rows
    # The loop kernel's column sums and row statistics fit a block.
    assert (2 * t_layernorm.MAX_PARAMS_WIDTH + 2 * warps) * 4 <= 232448
