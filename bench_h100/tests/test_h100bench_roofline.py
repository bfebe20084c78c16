"""The operations and bytes of the measured kernels and steps, against
the numbers worked out by hand for the training cell's shape."""

from __future__ import annotations

from harness import roofline

# B4 S4096 Hq40 Hkv10 D128, causal: the training cell's attention
SHAPE = (4, 4096, 4096, 40, 10, 128)
MEDIUM5 = {"vocab_size": 32064, "d_model": 5120, "n_layers": 5,
           "n_heads": 40, "n_kv_heads": 10, "d_ff": 17920}
MINI = {"vocab_size": 32064, "d_model": 3072, "n_layers": 32, "n_heads": 32,
        "n_kv_heads": 32, "d_ff": 8192}


def test_visible_pairs():
    assert roofline.visible_pairs(4096, 4096, True) == 8_390_656
    assert roofline.visible_pairs(512, 1024, True) == \
        sum(i + 512 + 1 for i in range(512))
    assert roofline.visible_pairs(3, 5, False) == 15


def test_flash_forward_counts():
    f = roofline.flash_forward(*SHAPE)
    assert f["flops"] == 4 * 4 * 40 * 128 * 8_390_656
    assert round(f["flops"] / 1e9, 1) == 687.4
    assert round(f["bound_s"] * 1e3, 3) == 0.695  # bound by products
    # q, k, v read and out written: 419.4 MB, 0.125 ms at 3.35 TB/s
    assert f["bytes_without_lse"] == 419_430_400
    assert round(f["bytes_without_lse"] / 3.35e12 * 1e3, 3) == 0.125
    assert f["bytes"] == 419_430_400 + 4 * 4 * 40 * 4096


def test_flash_backward_counts_four_products():
    b = roofline.flash_backward(*SHAPE)
    # twice the forward's products (1,374.7 GFLOP; 2 x the rounded 687.4
    # reads 1,374.8)
    assert b["flops"] == 2 * roofline.flash_forward(*SHAPE)["flops"]
    assert round(b["flops"] / 1e9, 1) == 1374.7
    assert round(b["bound_s"] * 1e3, 3) == 1.390
    elem = 2
    q_like = 4 * 4096 * 40 * 128 * elem
    kv_like = 4 * 4096 * 10 * 128 * elem
    assert b["bytes"] == 4 * q_like + 4 * kv_like + 4 * 4 * 40 * 4096


def test_model_flops():
    assert roofline.matmul_params(MEDIUM5) == 5 * 340_787_200 + 164_167_680
    assert round(roofline.matmul_params(MEDIUM5) / 1e9, 3) == 1.868
    assert round(roofline.matmul_params(MINI) / 1e9, 3) == 3.722
    step = roofline.train_step_flops(MEDIUM5, 4, 4096)
    assert 193.9e12 <= step < 194.0e12
    attn = 3 * 5 * roofline.flash_forward(*SHAPE)["flops"]
    assert step == 6 * roofline.matmul_params(MEDIUM5) * 16384 + attn
    # a served token at context c: 2 N + 4 L H D c
    assert roofline.decode_flops(MINI, 2000) == \
        2 * roofline.matmul_params(MINI) + 4 * 32 * 32 * 96 * 2000
    assert roofline.prefill_flops(MINI, 3) == \
        6 * roofline.matmul_params(MINI) + 4 * 32 * 32 * 96 * 6
