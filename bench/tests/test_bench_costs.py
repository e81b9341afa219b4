"""The benchmark's FLOP and byte counts and the share arithmetic of its
readers, against shapes worked by hand."""

import pytest

import tiny  # noqa: F401
from costs import flops as costs
from harness import readers


def test_attention_pairs_by_hand():
    assert costs.attention_pairs(4, 4, False, 0) == 16
    assert costs.attention_pairs(4, 4, True, 0) == 10          # 1+2+3+4
    assert costs.attention_pairs(4, 4, True, 2) == 7           # 1+2+2+2
    # one decode query at position 9 over 10 keys, and inside a window
    assert costs.attention_pairs(1, 10, True, 0, offset=9) == 10
    assert costs.attention_pairs(1, 10, True, 4, offset=9) == 4


def test_layer_and_forward_flops_by_hand():
    # d 4, 2 heads of 2, 1 kv head, ff 8: q 2*4*4, k and v 2*4*2 each,
    # o 2*4*4, MLP 2*4*8*2
    assert costs.layer_token_flops(4, 2, 1, 2, 8) == 32 + 32 + 32 + 128
    shape = {"layers": 1, "d": 4, "heads": 2, "kv_heads": 1, "ff": 8,
             "vocab": 10}
    # 3 tokens, causal: 6 pairs at 4 * 2 heads * hd 2 each; logits at one
    per_seq = 3 * 224 + 4 * 2 * 2 * 6 + 2 * 4 * 10
    assert costs.forward_flops(shape, 2, 3, causal=True,
                               logit_positions=1) == 2 * per_seq


def test_starcoder2_prefill_count():
    shape = {"layers": 40, "d": 6144, "heads": 48, "kv_heads": 4,
             "ff": 24576, "vocab": 49152}
    f = costs.forward_flops(shape, 1, 2048, causal=True, window=4096,
                            logit_positions=1)
    # about 2 x 15.4e9 non-embedding parameters x 2,048 tokens, plus
    # causal attention's 2.1e12
    assert 6.4e13 < f < 6.6e13


def test_flash_attention_cost_and_bound():
    ops, nbytes = costs.flash_attention_cost(2, 8, 8, 4, 2, 16, True, 0, 2)
    assert ops == 4 * 2 * 4 * 16 * 36
    assert nbytes == 2 * (2 * 2 * 8 * 4 * 16 + 2 * 2 * 8 * 2 * 16)
    # bytes bound at this size
    assert costs.bound_seconds(ops, nbytes, "bfloat16") == \
        pytest.approx(nbytes / 3.35e12)
    assert costs.bound_seconds(1e15, 1, "float32") == pytest.approx(1e15 / 495e12)


def run_with(trace=None, **kw):
    return dict(kw, trace=trace, costs=costs)


def test_mfu_by_hand():
    r = run_with(flops=989e12, window_s=2.0, dtype="bfloat16")
    assert readers.mfu(r) == pytest.approx(50.0)
    r = run_with(flops=495e12 / 4, window_s=1.0, dtype="float32")
    assert readers.mfu(r) == pytest.approx(25.0)
    assert readers.mfu(run_with(flops=0, window_s=1.0, dtype="float32")) is None


def test_idle_share_and_roofline_by_hand():
    tr = {"busy_s": 0.75, "window_s": 1.0, "kernel_s": {
        "void flash_attention_kernel<float, 4>(...)": 2e-3,
        "void flash_attention_kernel_bf16<8>(...)": 1e-3, "gemm": 5.0},
        "attention_calls": [(1, 2048, 2048, 48, 4, 128, True, 4096,
                             "bfloat16")]}
    assert readers.idle_share(run_with(tr)) == pytest.approx(25.0)
    ops, nbytes = costs.flash_attention_cost(1, 2048, 2048, 48, 4, 128,
                                             True, 4096, 2)
    want = 100 * max(ops / 989e12, nbytes / 3.35e12) / 1e-3
    got = readers.roofline(run_with(tr), "bfloat16",
                           lambda n: "flash_attention_kernel_bf16" in n)
    assert got == pytest.approx(want)
    # no float32 call in the stretch: nothing to read
    assert readers.roofline(run_with(tr), "float32",
                            lambda n: "kernel<float" in n) is None
    assert readers.idle_share(run_with(dict(tr, busy_s=0.0))) is None


def test_counter_ratios():
    eng = {"served": 300, "flushes": 4, "padded_rows": 20,
           "rows_launched": 320, "cache_hits": 90, "cache_misses": 10,
           "router_time_s": 0.02, "expert_time_s": 0.6}
    r = {"engine": eng}
    assert readers.ratio(readers.engine(r, "served"),
                         readers.engine(r, "flushes")) == 75
    assert readers.ratio(20, 320, 100.0) == pytest.approx(6.25)
    assert readers.ratio(1, 0) is None
    assert readers.engine({}, "served") is None
