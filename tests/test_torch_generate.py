"""``repro_torch.launch.generate`` against ``repro.launch.generate``: with
``--arch llama3.2-1b --reduced`` or ``--arch jamba-1.5-large-398b
--reduced`` (float32; Jamba's Mamba, attention and MoE layers) and the
same seed, the port on the CPU prints the JAX entry point's greedy tokens.  Both draw their weights and
prompts from one threefry key; the tokens are compared exactly (argmax of
logits that agree to float32 summation order)."""
import _torch_threads  # noqa: F401  (first: sets PyTorch's threads)
import json

import pytest

from repro.launch import generate as jgen
from repro_torch.launch import generate as tgen


def sample_lines(out: str) -> list[str]:
    return [line for line in out.splitlines() if " sample " in line]


@pytest.mark.parametrize("seed", ["0", "1"])
def test_port_prints_the_jax_tokens(capsys, seed):
    argv = ["--arch", "llama3.2-1b", "--reduced", "--seed", seed]
    jgen.main(argv)
    want = sample_lines(capsys.readouterr().out)
    result = tgen.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(want) == 2 and sample_lines(out) == want
    assert result["tokens"].shape == (4, 16)
    for span in ("serve.init", "serve.prefill", "serve.decode_step"):
        assert f"span {span}:" in out


@pytest.mark.parametrize("seed", ["0", "3"])
def test_port_prints_the_jax_tokens_for_jamba(capsys, seed):
    argv = ["--arch", "jamba-1.5-large-398b", "--reduced", "--seed", seed]
    jgen.main(argv)
    want = sample_lines(capsys.readouterr().out)
    result = tgen.main(argv + ["--device", "cpu"])
    assert len(want) == 2 and sample_lines(capsys.readouterr().out) == want
    assert result["tokens"].shape == (4, 16)


def test_generate_takes_a_built_config(capsys):
    """``generate`` is ``main``'s body for a config already built."""
    cfg = tgen.configs.get("jamba-1.5-large-398b").reduced()
    result = tgen.generate(cfg, batch=2, prompt_len=5, new_tokens=3,
                           device="cpu")
    assert result["tokens"].shape == (2, 3)
    assert "jamba-1.5-large-398b-smoke: batch=2" in capsys.readouterr().out


def test_serve_manifest_and_counters(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_OBS_DIR", str(tmp_path))
    tel = tgen.get_telemetry()
    before = dict(tel.counters)
    tgen.main(["--arch", "llama3.2-1b", "--reduced", "--batch", "2",
               "--prompt-len", "5", "--new-tokens", "3", "--device", "cpu"])
    lines = (tmp_path / "runs.jsonl").read_text().splitlines()
    m = json.loads(lines[-1])
    assert m["kind"] == "serve" and m["schema_version"] == 1
    assert m["extra"]["new_tokens"] == 3 and m["extra"]["device"] == "cpu"
    assert {"torch", "cuda", "backend", "git_sha"} <= set(m["fingerprint"])
    assert tel.counters["serve.requests"] - before.get("serve.requests",
                                                       0) == 2
    assert tel.counters["serve.tokens_generated"] - before.get(
        "serve.tokens_generated", 0) == 6
