"""The port's examples (`examples/torch_{quickstart,serve_lm,train_lm}.py`)
at their tiny presets on the CPU (`--device cpu`), each in a process of
its own, all started at once: the quickstart prints the reference
example's lines (`examples/quickstart.py`, run beside it under JAX on the
CPU) — every simulator, schedule, feedback and serving line the same
text, the two kernel lines the same values with the device in place of
the reference's interpret mode; the serving example generates its ids
and prints the engine's chunk log; the training example crashes where
asked and the same command resumes from its checkpoint to the end."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
KERNEL_LINES = ("spmv kernel ", "bfs kernel ")


def _start(args, jax=False):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, *args], cwd=str(ROOT), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _done(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("examples") / "ckpt")
    train = ["examples/torch_train_lm.py", "--device", "cpu", "--steps",
             "4", "--batch", "2", "--seq", "32", "--ckpt-dir", ckpt]
    procs = {
        "port": _start(["examples/torch_quickstart.py", "--device", "cpu"]),
        "reference": _start(["examples/quickstart.py"], jax=True),
        "serve": _start(["examples/torch_serve_lm.py", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "32",
                         "--new-tokens", "4"]),
        "crash": _start(train + ["--failure-at", "2"])}
    out = {k: _done(p) for k, p in procs.items()}
    out["resume"] = _done(_start(train))   # after the crash: it resumes
    return out


def test_torch_quickstart_prints_the_reference_examples_lines(runs):
    port = runs["port"].splitlines()
    ref = runs["reference"].splitlines()
    assert len(port) == len(ref)
    kernel = 0
    for a, b in zip(port, ref):
        if a.startswith(KERNEL_LINES):
            kernel += 1
            assert a.replace("(cpu)", "(interpret)") == b
        else:
            assert a == b
    assert kernel == 2 and port[-1] == "OK"


def test_torch_serve_lm_generates_and_logs_its_chunks(runs):
    lines = runs["serve"].splitlines()
    assert lines[0] == "generated ids:"
    assert "prefill chunk log (iCh adaptation):" in lines
    assert any(ln.strip().startswith("chunk=") for ln in lines)
    assert lines[-1].startswith("final divisor d:")


def test_torch_train_lm_crashes_then_resumes_to_the_end(runs):
    assert "crashed as requested" in runs["crash"]
    done = [ln for ln in runs["resume"].splitlines()
            if ln.startswith("done: loss ")]
    assert len(done) == 1
    first, last = (float(x) for x in done[0][len("done: loss "):]
                   .split(" -> "))
    assert first > 0 and last > 0
