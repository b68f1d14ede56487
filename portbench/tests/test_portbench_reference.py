"""The plain reference against the program on the CPU, both families at the
program's `reduced(..., layers=2)` sizes: the program's paged serving path
in float32 (prefill, pages, paged decode steps) keeps each served token's
logits, and the reference's causal forward over the prompt and the served
tokens must give the same logits at every served position."""
import numpy as np
import pytest
import torch

from portbench.harness.check import gaps
from portbench.harness.weights import make_weights, program_params
from portbench.reference.decoder import logits_at, shape_of
from portbench.tests.tiny import tiny_arch, tiny_config

# float32 on both sides; the sums run in another order
TOL = 1e-4


def _serve(family, seed, lens):
    from repro_torch.models import DecoderLM
    from repro_torch.serve.paged import PagedContinuousBatcher
    from repro_torch.serve.scheduler import Request
    arch, shape = tiny_arch(family), shape_of(tiny_config(family))
    w = make_weights(shape, seed, "cpu", rows=arch.padded_vocab)
    model = DecoderLM(arch, compute_dtype=torch.float32, device="cpu")
    b = PagedContinuousBatcher(model, program_params(arch, w), num_slots=2,
                               page_size=16, num_pages=20, chunk_steps=4,
                               collect_logits=True)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, tokens=rng.integers(0, shape.vocab, size=s),
                    max_new_tokens=n) for i, (s, n) in enumerate(lens)]
    for r in reqs:
        b.submit(r)
    b.run()
    return shape, w, reqs


@pytest.mark.parametrize("family", ["qwen2", "gpt2"])
def test_reference_equals_program_on_served_positions(family):
    shape, w, reqs = _serve(family, 3, [(37, 7), (16, 5), (50, 9)])
    for r in reqs:
        seq = np.concatenate([r.tokens, r.output[:-1]])
        read = list(range(len(r.tokens) - 1, len(seq)))
        ref = logits_at(shape, w, torch.as_tensor(seq), read).numpy()
        got = np.stack(r.logits)[:, :shape.vocab]
        assert ref.shape == got.shape == (len(r.output), shape.vocab)
        assert np.abs(ref - got).max() < TOL
        assert np.array_equal(ref.argmax(-1), np.asarray(r.output))
        assert gaps(shape, w, r.tokens, r.output).max() == 0.0


@pytest.mark.parametrize("family", ["qwen2", "gpt2"])
def test_reference_blocks_do_not_change_the_logits(family):
    shape = shape_of(tiny_config(family))
    w = make_weights(shape, 8, "cpu", rows=shape.vocab + 32)
    seq = torch.as_tensor(np.random.default_rng(1).integers(0, shape.vocab,
                                                            size=45))
    a = logits_at(shape, w, seq, range(45), block=45)
    b = logits_at(shape, w, seq, range(45), block=7)
    assert torch.allclose(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("family", ["qwen2", "gpt2"])
def test_float8_control_departs_from_float32(family):
    shape = shape_of(tiny_config(family))
    w = make_weights(shape, 4, "cpu", rows=shape.vocab + 32)
    seq = torch.as_tensor(np.random.default_rng(2).integers(0, shape.vocab,
                                                            size=40))
    a = logits_at(shape, w, seq, range(40))
    b = logits_at(shape, w, seq, range(40), fp8=True)
    assert (a - b).abs().max() > 100 * TOL
