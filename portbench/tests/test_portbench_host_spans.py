"""The readers of the program's host spans (`prefill_issue_ms_per_ktok`,
`decode_issue_ms`, `batcher_host_ms`, `host_wait_share`) on a tiny CPU
cell run with `trace` and a fixed number of cycles: each reads a finite
value from the traced window alone, and nothing from an empty log."""
import math
from pathlib import Path

import pytest

from portbench.harness import hostspans
from portbench.harness.serve import run_cell
from portbench.harness.spec import load_reader
from portbench.tests.tiny import tiny_arch, tiny_cell
from repro_torch.obs.host_spans import host_registry

ROOT = Path(__file__).resolve().parents[2]
READERS = ("prefill_issue_ms_per_ktok", "decode_issue_ms",
           "batcher_host_ms", "host_wait_share")


@pytest.fixture(scope="module", params=["qwen2", "gpt2"])
def traced(request):
    """(record, the whole span log) of one traced run of the tiny cell."""
    fam = request.param
    host_registry().spans.clear()
    r = run_cell(tiny_cell(fam), 2 ** 31 + 11, 0.0, True, device="cpu",
                 arch=tiny_arch(fam), cycles=5)
    assert r["correct"], r["checks"]
    spans = list(host_registry().spans)
    host_registry().spans.clear()
    return r["record"], spans


@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_a_finite_value(traced, name, monkeypatch):
    rec, spans = traced
    monkeypatch.setattr(hostspans, "_log", lambda: spans)
    v = load_reader(ROOT, name)(rec)
    assert v is not None and math.isfinite(v) and v >= 0
    if name == "host_wait_share":
        assert 0 <= v <= 100


def test_readers_count_only_the_traced_window(traced, monkeypatch):
    rec, spans = traced
    tr = rec["trace"]
    monkeypatch.setattr(hostspans, "_log", lambda: spans)
    w = hostspans.window(rec)
    steps = hostspans.named(w, "model.decode_step")
    assert len(steps) == len(tr["decode_rows"]) > 0
    assert len(hostspans.named(w, "model.prefill")) == len(tr["prefill_S"])
    # the breakdown's cycle after the window logged spans too: left out
    assert len(hostspans.named(spans, "model.decode_step")) > len(steps)
    # the window's spans lie within its length on the host's clock
    assert max(s.t1 for s in w) - min(s.t0 for s in w) <= tr["window_s"]


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_nothing_from_an_empty_log(traced, name,
                                                      monkeypatch):
    rec, _ = traced
    monkeypatch.setattr(hostspans, "_log", lambda: [])
    assert load_reader(ROOT, name)(rec) is None
