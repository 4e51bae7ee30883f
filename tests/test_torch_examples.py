"""The PyTorch port's examples (``examples/torch_*.py``) on the CPU, at
the JAX examples' sizes (train_tiny cut to a few steps of a narrow model):
each runs its own assertions and ends with its ``OK`` line, and the
quickstart's tiered-deployment line is the JAX quickstart's."""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(capsys, name: str, *argv) -> list[str]:
    _load(name).main(["--device", "cpu", *argv])
    return capsys.readouterr().out.strip().splitlines()


def _line(lines, prefix: str) -> str:
    hits = [ln for ln in lines if ln.startswith(prefix)]
    assert len(hits) == 1, lines
    return hits[0]


def test_quickstart_deploys_as_the_jax_quickstart(capsys):
    got = _run(capsys, "torch_quickstart")
    assert got[-1] == "quickstart OK"
    drift = float(_line(got, "max |logit drift|").rsplit(" ", 1)[1])
    assert drift < 1e-2
    _load("quickstart").main()
    want = capsys.readouterr().out.strip().splitlines()
    assert want[-1] == "quickstart OK"
    assert _line(got, "tiered deployment:") == \
        _line(want, "tiered deployment:")
    assert _line(got, "tiered deployment:").startswith(
        "tiered deployment: 4 flash-tier tensors")


def test_train_tiny_learns(capsys, tmp_path, monkeypatch):
    from repro_torch.launch import train as ttrain
    from repro_torch.runtime.fault import FaultPolicy
    # the straggler detector trips on a loaded CPU (tests of train())
    monkeypatch.setattr(ttrain, "FaultPolicy",
                        lambda: FaultPolicy(straggler_tolerance=10**9))
    got = _run(capsys, "torch_train_tiny", "--steps", "60", "--d-model",
               "128", "--layers", "2", "--ckpt", str(tmp_path / "ck"))
    assert got[-1] == "train_tiny OK"
    first, last = map(float, re.search(r"loss (\S+) -> (\S+) over",
                                       _line(got, "loss ")).groups())
    assert last < first
    assert (tmp_path / "ck").exists()


def test_deploy_nvllm_lifecycle(capsys):
    got = _run(capsys, "torch_deploy_nvllm")
    assert got[-1] == ("deploy_nvllm OK — corrupted flash reads decode "
                       "identically")
    assert "checkpoint round-trip OK" in got
    decoded = _line(got, "deployed engine (RBER=1e-4, ECC on) decoded:")
    assert len(decoded.split(":", 1)[1].strip(" []").split(",")) == 8


def test_edge_serve_offloads_chunks_streams_and_speculates(capsys):
    got = _run(capsys, "torch_edge_serve")
    assert got[-1] == "edge_serve OK"
    chunked = _line(got, "late 64-token prompt prefilled over")
    assert int(chunked.split()[5]) > 1
    moved = _line(got, "Alg. 2 moved")
    assert int(moved.split()[3].rstrip("%")) > 0
    spec = _line(got, "speculative streaming:")
    steps, vanilla = map(int, re.search(r"in (\d+) steps instead of (\d+)",
                                        spec).groups())
    assert steps < vanilla == 32


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_train_tiny",
                                  "torch_deploy_nvllm", "torch_edge_serve"])
def test_example_has_a_device_option_defaulting_to_the_card(name):
    src = (EXAMPLES / f"{name}.py").read_text()
    assert 'ap.add_argument("--device", choices=("cuda", "cpu"), ' \
        'default="cuda")' in src
