"""The operation and byte counts against hand counts."""

import pytest

from port_bench.lib import flops


def test_train_step_flops_hand_count():
    # 1 layer, B 1, L 4, d 2, ffn 1, V 3: proj 4*2*1*4*2*2 = 128, FFN
    # 2*2*1*4*2*1 = 32, attention 3*1*4*4*2 = 96, head 2*1*4*2*3 = 48
    assert flops.train_step_flops(1, 4, 2, 1, 3, 1) == 3 * (128 + 32 + 96
                                                            + 48)


def test_flagship_step_flops():
    # the flagship at B 72, L 2048: bench.py's count, 5.98 TFLOP a step
    f = flops.train_step_flops(72, 2048, 256, 6, 309, 128)
    assert f == pytest.approx(5.98e12, rel=2e-3)


def test_attention_costs_hand_count():
    # B 1, H 1, L 2, dh 1, bf16: forward reads q, k, v and writes out (4 x
    # 2 values x 2 bytes), E rows 2 x 4 bytes, LSE 2 x 4; 3 products x 2
    # flops x 3 causal pairs
    assert flops.attn_fwd_cost(1, 1, 2, 1) == (16 + 8 + 8, 18)
    # backward: 8 tensors x 2 x 2 bytes, LSE 8, E and dE 2 x 2 x 4; 8 x 2
    # x 3 flops
    assert flops.attn_bwd_cost(1, 1, 2, 1) == (32 + 8 + 16, 48)


def test_gru_cost_hand_count():
    # B 1, in 2, H 1, 1 layer, bf16: weights 3*(2+1) = 9 values, biases 2
    # x 3 f32, x 2 values, h and h' 2 values
    nbytes, ops = flops.gru_step_cost(1, 2, 1, 1, 2)
    assert nbytes == 9 * 2 + 6 * 4 + 2 * 2 + 2 * 2
    assert ops == 2 * 1 * 3 * 1 * 3


def test_bound_names_what_bounds_it():
    assert flops.bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert flops.bound_s(1.0, 989e12) == (1.0, "operations")
