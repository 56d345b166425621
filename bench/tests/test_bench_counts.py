"""The counts against closed forms and brute force on small shapes: the
causal half, the window, each op's operations and bytes, and the model
FLOPs of each configuration against its parameters."""
import json
import math

import pytest

from bench import counts, harness, weights


def brute_pairs(s, causal, window):
    return sum(1 for i in range(s) for j in range(s)
               if (not causal or j <= i) and (window <= 0 or i - j < window))


@pytest.mark.parametrize("s,window", [(1, 0), (7, 0), (64, 0), (64, 16),
                                      (64, 64), (64, 100), (33, 5)])
def test_attention_pairs(s, window):
    assert counts.attention_pairs(s, s, True, window) == brute_pairs(
        s, True, window)
    assert counts.attention_pairs(s, s, False, 0) == s * s


def test_causal_half_and_window_closed_forms():
    assert counts.attention_pairs(4096, 4096, True, 0) == 4096 * 4097 // 2
    # a full window of 1,024 keys after the first 1,024 queries
    assert counts.attention_pairs(4096, 4096, True, 1024) == \
        1024 * 1025 // 2 + (4096 - 1024) * 1024


def test_flash_counts():
    f = counts.flash_fwd(2, 8, 4, 2, 16, causal=True, window=0, lse=True)
    assert f["flops"] == 4 * 16 * 36 * 2 * 4
    assert f["bytes"] == 2 * 2 * 8 * 16 * (2 * 4 + 2 * 2) + 4 * 2 * 4 * 8
    b = counts.flash_bwd(2, 8, 4, 2, 16, causal=True, window=3)
    pairs = brute_pairs(8, True, 3)
    assert b["flops"] == 10 * 16 * pairs * 2 * 4
    assert b["bytes"] == 2 * 2 * 8 * 16 * (4 * 4 + 4 * 2) + 4 * 2 * 4 * 8


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert counts.least_seconds(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def _config(name):
    spec = harness.load_spec()
    c = {c["name"]: c for c in spec["configs"]}[name]
    return json.loads((harness.ROOT / c["file"]).read_text())["model"]


@pytest.mark.parametrize("name", ["starcoder2-7b"])
def test_matmul_params_are_the_projection_weights(name):
    """Every weight a token meets in a product: the layout's matrices but
    the embedding table, and the unembedding over the real vocabulary."""
    cfg = _config(name)
    total = 0
    for group in weights.layout(cfg):
        for leaf, shape, _ in group:
            if leaf.endswith(".w"):
                total += math.prod(shape)
    total += cfg["d_model"] * cfg["vocab_size"]
    assert counts.matmul_params(cfg) == total


def test_model_flops_closed_forms():
    cfg = _config("starcoder2-7b")
    n = counts.matmul_params(cfg)
    s = 4096
    attn = cfg["num_layers"] * 4 * 128 * 36 * (s * (s + 1) // 2)
    assert counts.forward_flops(cfg, s) == 2 * n * s + attn
    assert counts.train_flops(cfg, s) == 3 * (2 * n * s + attn)
    unembed = cfg["d_model"] * cfg["vocab_size"]
    assert counts.prefill_flops(cfg, s) == \
        2 * (n - unembed) * s + 2 * unembed + attn
    # about 12.7 GFLOP a token at 4,096 (6 x 1.96 B plus attention)
    assert 12e9 < counts.train_flops(cfg, s) / s < 13.5e9
    # under a window, a query past it attends the window's keys only
    win = dict(cfg, attn_window=1024)
    pairs = 1024 * 1025 // 2 + (s - 1024) * 1024
    assert counts.forward_flops(win, s) == \
        2 * n * s + cfg["num_layers"] * 4 * 128 * 36 * pairs
