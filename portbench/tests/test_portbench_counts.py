"""The yardstick's operation and byte counts against counts by hand at a
small shape."""
from portbench.harness import counts
from portbench.reference.decoder import Shape

QWEN = Shape("qwen2", layers=2, d=8, heads=4, kv_heads=2, head_dim=2,
             ffn=16, vocab=10, eps=1e-6, rope_theta=1e4)
GPT2 = Shape("gpt2", layers=3, d=8, heads=2, kv_heads=2, head_dim=4, ffn=32,
             vocab=12, eps=1e-5, positions=64)


def test_weight_params_by_hand():
    # qwen2: wq 8x8, wk 8x4, wv 8x4, wo 8x8, three 8x16 MLP matrices
    assert counts.weight_params(QWEN) == 2 * (64 + 32 + 32 + 64 + 3 * 128)
    # gpt2 (MHA): four 8x8 attention matrices, two 8x32 MLP matrices
    assert counts.weight_params(GPT2) == 3 * (4 * 64 + 2 * 256)


def test_attention_counts_by_hand():
    # S = 3: rows attend 1 + 2 + 3 = 6 keys, 4 H d = 32 FLOPs a key
    assert counts.attn_prefill_flops(QWEN, 3) == 6 * 4 * 4 * 2
    # q and o: 3 x 8 each; k and v: 3 x 4 each; bf16
    assert counts.attn_prefill_bytes(QWEN, 3) == 2 * (24 + 24 + 12 + 12)
    assert counts.attn_decode_flops(QWEN, [5, 7]) == 12 * 4 * 4 * 2
    # 12 live rows of K and V (4 each), q and o of 3 slots, a 6-page table
    # and the lengths of 3 slots (int32)
    assert counts.attn_decode_bytes(QWEN, [5, 7], slots=3, table_pages=6) \
        == 2 * 2 * 4 * 12 + 2 * 2 * 3 * 8 + 4 * 3 * 7


def test_model_flops_by_hand():
    wp = counts.weight_params(GPT2)
    head = 2 * 8 * 12
    # prefill of 4 tokens: the products of 4 tokens, causal attention of
    # 10 keys a layer at 4 H d = 32, one LM-head row
    assert counts.prefill_flops(GPT2, 4) == 2 * wp * 4 + 3 * 10 * 32 + head
    # a decode token attending 9 keys
    assert counts.decode_flops(GPT2, 9) == 2 * wp + 3 * 9 * 32 + head


def test_ideal_time_takes_the_larger_bound():
    pk = counts.peaks("NVIDIA H100 80GB HBM3")
    assert counts.ideal_s(989e12, 0, pk) == 1.0
    assert counts.ideal_s(0, 3.35e12, pk) == 1.0
    assert counts.ideal_s(989e12, 6.7e12, pk) == 2.0
    assert counts.peaks("some other card") is None
