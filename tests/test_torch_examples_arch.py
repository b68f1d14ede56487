"""The port's serving walkthroughs take any arch their reference
counterparts take (`examples/{paged_serving,prefix_serving,quant_serving,
serve_batched,spec_serving}.py`), with the same default, tinyllama-1.1b:
each `main()` runs on the CPU with `--arch granite-34b` (reduced: MQA, GELU
MLP, LayerNorm, learned positions) and with no `--arch`, `sys.argv` set
through pytest's monkeypatch."""
import importlib

import pytest

EXAMPLES = ("paged_serving", "prefix_serving", "quant_serving",
            "serve_batched", "spec_serving")


@pytest.mark.parametrize("arch", [None, "granite-34b"])
@pytest.mark.parametrize("name", EXAMPLES)
def test_walkthrough_takes_any_registry_arch(name, arch, monkeypatch,
                                             capsys):
    main = importlib.import_module(f"repro_torch.examples.{name}").main
    argv = [name, "--device", "cpu"] + ([] if arch is None
                                        else ["--arch", arch])
    monkeypatch.setattr("sys.argv", argv)
    main()
    out = capsys.readouterr().out
    assert f"{arch or 'tinyllama-1.1b'}-reduced" in out
