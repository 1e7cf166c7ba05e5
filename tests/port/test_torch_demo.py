"""The port's drivers on the CPU: the TorchScript files of gen_benchmark
read by both packages' pt_loader, the demo end to end (grouped and
round-interleaved, with --verify), its output file, the committed-aux flag
and variable, the config read from ZKDL_* as the JAX package reads it and
what each variable changes, and the profiling helpers."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from zkdl_tpu import config as jconfig
from zkdl_tpu.io import pt_loader as jpt_loader
from zkdl_tpu.models import gen_benchmark as jgen_benchmark
from zkdl_tpu_torch import config, demo
from zkdl_tpu_torch.commit.pedersen import to_mont_rows
from zkdl_tpu_torch.field import fr, mp
from zkdl_tpu_torch.io import pt_loader
from zkdl_tpu_torch.models import gen_benchmark, mlp, quantize
from zkdl_tpu_torch.utils import prng, profiling

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = tmp_path_factory.mktemp("small")
    gen_benchmark.generate(str(d), small=True)
    return d


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The small model with a batch of one: its committed-aux verify runs the
    plain G1 versions on fewer, smaller tensors."""
    d = tmp_path_factory.mktemp("single")
    gen_benchmark.generate(str(d), small=True, batch=1)
    return d


def test_pt_loaders_read_equal_arrays(small, tmp_path):
    weights = pt_loader.load_mlp_weights(str(small / "traced_model.pt"), "cpu")
    jweights = jpt_loader.load_mlp_weights(str(small / "traced_model.pt"))
    assert len(weights) == len(jweights) == 2
    for w, jw in zip(weights, jweights):
        assert w.dtype == torch.float32 and w.shape == (64, 64)
        np.testing.assert_array_equal(w.numpy(), jw)
    for name in ("sample_input.pt", "sample_output.pt"):
        t = pt_loader.load_tensor(str(small / name), "cpu")
        np.testing.assert_array_equal(t.numpy(), jpt_loader.load_tensor(str(small / name)))
    # the JAX package's generator writes the same model and input
    jgen_benchmark.generate(str(tmp_path), small=True)
    for w, jw in zip(weights, jpt_loader.load_mlp_weights(str(tmp_path / "traced_model.pt"))):
        np.testing.assert_array_equal(w.numpy(), jw)
    np.testing.assert_array_equal(pt_loader.load_tensor(str(small / "sample_input.pt")).numpy(),
                                  jpt_loader.load_tensor(str(tmp_path / "sample_input.pt")))


def expected_output_lines(small) -> list[str]:
    """Y_hat of the demo's model, each raw value as 64 hex digits."""
    weights = pt_loader.load_mlp_weights(str(small / "traced_model.pt"), "cpu")
    model = mlp.MLP.from_float_weights(weights, prng.PRNGKey(0), device="cpu")
    X = to_mont_rows(quantize.load_input(pt_loader.load_tensor(str(small / "sample_input.pt")), "cpu"))
    Y = model.infer(X)[0]
    return [f"{v:064x}" for v in fr.to_ints(mp.host(Y), mont_form=True)]


@pytest.mark.parametrize("interleave", [False, True], ids=["grouped", "interleaved"])
def test_demo_verifies_on_the_cpu(small, tmp_path, capsys, interleave):
    out = tmp_path / "demo.out"
    argv = [str(small / "traced_model.pt"), str(small / "sample_input.pt"), "--verify", "--device", "cpu",
            "--out", str(out)] + (["--interleave"] if interleave else [])
    assert demo.main(argv) == 0
    printed = capsys.readouterr().out
    assert "Total number of parameters: 8192" in printed
    assert "Verification: OK" in printed, printed
    lines = out.read_text().splitlines()
    assert lines == expected_output_lines(small)
    assert len(lines) == 4 * 64


def test_demo_commit_aux_verifies(single, tmp_path, capsys):
    """--commit-aux proves the committed-aux tier and --verify checks its
    openings: the same output, verified."""
    out = tmp_path / "demo.out"
    argv = [str(single / "traced_model.pt"), str(single / "sample_input.pt"), "--commit-aux", "--verify",
            "--device", "cpu", "--out", str(out)]
    assert demo.main(argv) == 0
    assert "Verification: OK" in capsys.readouterr().out
    assert out.read_text().splitlines() == expected_output_lines(single)


KEPT = ("scale_bits", "relu_mag_bits", "relu_rem_bits", "commit_aux", "fiat_shamir_label")


@pytest.mark.parametrize("env", [
    {},
    {"ZKDL_SCALE_BITS": "12", "ZKDL_RELU_MAG_BITS": "24", "ZKDL_RELU_REM_BITS": "8"},
    {"ZKDL_COMMIT_AUX": "1", "ZKDL_FIAT_SHAMIR_LABEL": "another-label"},
    {"ZKDL_COMMIT_AUX": "false", "ZKDL_PLANAR_TAIL_N": "64"},
])
def test_config_reads_env_as_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = config.Config.from_env(), jconfig.Config.from_env()
    assert {f: getattr(got, f) for f in KEPT} == {f: getattr(want, f) for f in KEPT}
    assert sorted(f.name for f in __import__("dataclasses").fields(got)) == sorted(KEPT)


def test_commit_aux_env_commits(single, monkeypatch):
    """ZKDL_COMMIT_AUX=1 asks for the committed-aux tier without the flag:
    the demo's prove commits the aux witnesses of its one ReLU layer."""
    from zkdl_tpu_torch.models import zkrelu

    monkeypatch.setenv("ZKDL_COMMIT_AUX", "1")
    monkeypatch.setattr(config, "_CONFIG", None)
    calls = []
    commit_aux = zkrelu.commit_aux
    monkeypatch.setattr(zkrelu, "commit_aux", lambda aux: calls.append(aux) or commit_aux(aux))
    assert demo.main([str(single / "traced_model.pt"), str(single / "sample_input.pt"),
                      "--device", "cpu", "--out", str(single / "aux.out")]) == 0
    assert len(calls) == 1


ENV_EFFECTS = """
import hashlib
import numpy as np
from zkdl_tpu_torch.bench import make_weights
from zkdl_tpu_torch.commit.pedersen import to_mont_rows
from zkdl_tpu_torch.field import fr, mp
from zkdl_tpu_torch.models import mlp, quantize, zkrelu
from zkdl_tpu_torch.sumcheck.transcript import FiatShamir
from zkdl_tpu_torch.utils import prng

assert (zkrelu.Q, zkrelu.R, zkrelu.LOG_Q, zkrelu.LOG_R, zkrelu.SCALE_OUT_BITS) == (16, 8, 4, 3, 8)
assert fr.to_ints(quantize.load_input(np.ones((1, 1), np.float32), "cpu").numpy())[0] == 1 << 8
# x = 3 * 2^20 is positive below the threshold 2^23 of Q=16/R=8, with rem 0:
# the output is 3 * 2^20 >> 8 (the JAX package's tests/test_config.py case)
import torch
z, _ = zkrelu.forward_compact(to_mont_rows(torch.from_numpy(mp.limbs_from_int(3 << 20, 8)[None])))
assert fr.to_ints(mp.host(z), mont_form=True) == [3 << 12]
assert FiatShamir().state == hashlib.blake2s(b"another-label").digest()
# prover and verifier agree at these widths, under this label
dims = [8, 8, 8]
model = mlp.MLP.from_float_weights(make_weights(dims, np.random.default_rng(1)), prng.PRNGKey(3), "cpu")
x = np.random.default_rng(2).standard_normal((2, 8)).astype(np.float32) / 8
X = to_mont_rows(quantize.load_input(x, "cpu"))
Y, Z, A, aux = model.infer(X)
for interleave in (False, True):
    proof = model.prove(X, Y, Z, A, aux, FiatShamir(), interleave=interleave)
    assert proof.relu_proofs[0].mag_bits_at_u.shape[0] == 16
    assert model.verify(proof, X=X, Y_hat=Y, transcript=FiatShamir(), interleaved=interleave) == (True, "")
    assert not model.verify(proof, X=X, Y_hat=Y, transcript=FiatShamir(b"zkdl-tpu-v1"),
                            interleaved=interleave)[0]
print("env effects ok")
"""


def test_env_reaches_the_modules():
    """ZKDL_SCALE_BITS, ZKDL_RELU_* and ZKDL_FIAT_SHAMIR_LABEL, set before the
    process starts, change the quantizer, the ReLU widths and the default
    transcript label; a model proves and verifies at those widths."""
    env = dict(os.environ, ZKDL_SCALE_BITS="8", ZKDL_RELU_MAG_BITS="16", ZKDL_RELU_REM_BITS="8",
               ZKDL_FIAT_SHAMIR_LABEL="another-label", OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", ENV_EFFECTS], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0 and "env effects ok" in run.stdout, run.stderr[-4000:]


def test_phase_timer_and_trace(tmp_path):
    timer = profiling.PhaseTimer("cpu")
    for _ in range(2):
        with timer.phase("add"):
            torch.ones(4) + 1
    with timer.phase("mul"):
        torch.ones(4) * 2
    assert timer.counts == {"add": 2, "mul": 1} and timer.totals["add"] > 0
    assert sorted(timer.report().split()[::4]) == ["add", "mul"]
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert any(e.name.startswith("aten::") for e in prof.events())
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
