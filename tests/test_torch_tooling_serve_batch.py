"""The ``serve_batch`` twin (``repro_torch.examples.serve_batch``) against
the JAX package's example (``examples/serve_batch.py``): the same flags and
defaults, and on the CPU, from the JAX initialiser's weights, the same
greedy streams as the example's ``run(...)``."""
import importlib.util
import pathlib
import sys

import pytest

from repro_torch.examples import serve_batch
from repro_torch.launch import serve
from repro_torch.testing import train_checks as tc

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_serve_batch",
                                                  ROOT / "examples" / "serve_batch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_streams_equal_the_jax_examples(monkeypatch, capsys):
    ex = _jax_example()
    runs = []
    real = ex.run
    monkeypatch.setattr(ex, "run", lambda *a, **kw: runs.append((a, kw, real(*a, **kw)))
                        or runs[-1][2])
    monkeypatch.setattr(sys, "argv", ["serve_batch.py"])
    ex.main()
    (args, kwargs, want), = runs
    assert args == ("mixtral-8x7b",) and kwargs == {
        "smoke": True, "n_requests": 8, "max_new": 24, "max_batch": 4, "max_seq": 128}
    weights = tc.smoke_params("mixtral-8x7b")
    monkeypatch.setattr(serve, "init_params", lambda defs, gen, device: weights)
    got = serve_batch.main(["--device", "cpu"])
    assert {r.rid: list(r.out) for r in got} == {r.rid: list(r.out) for r in want}
    assert len(got) == 8 and all(len(r.out) == 24 for r in got)
    printed = [l for l in capsys.readouterr().out.splitlines() if l.startswith("req ")]
    assert printed[:4] == printed[4:8]          # the example's lines, then the twin's


def test_flags_and_defaults_are_the_examples(monkeypatch):
    seen = {}
    monkeypatch.setattr(serve_batch, "run", lambda *a, **kw: seen.update(a=a, kw=kw) or [])
    serve_batch.main([])
    assert seen == {"a": ("mixtral-8x7b",), "kw": {
        "smoke": True, "n_requests": 8, "max_new": 24, "max_batch": 4, "max_seq": 128,
        "device": "cuda"}}
    serve_batch.main(["--arch", "llama3-8b", "--requests", "3", "--max-new", "5",
                      "--device", "cpu"])
    assert seen["a"] == ("llama3-8b",) and seen["kw"]["n_requests"] == 3 \
        and seen["kw"]["max_new"] == 5 and seen["kw"]["device"] == "cpu"


def test_a_smoke_models_weights_are_drawn_on_the_cpu(monkeypatch):
    """The card serves the CPU's smoke model: its weights are drawn by the
    CPU's generator whatever the device (the card's draws other numbers)."""
    seen = []
    real = serve.init_params
    monkeypatch.setattr(serve, "init_params",
                        lambda defs, gen, device: seen.append((gen.device.type, str(device)))
                        or real(defs, gen, device))
    serve.run("llama3-8b", n_requests=1, max_new=2, device="cpu")
    assert seen == [("cpu", "cpu")]
