"""Every script under examples_torch/ runs on the CPU
(``EXAMPLE_PLATFORM=cpu``) as a user would run it — a subprocess from the
repo root, with a temporary directory of its own — exits 0 and prints
the checks it makes.

Cases over ~20 s on this CPU are marked ``slow``: the ones that train in
a launched worker import TensorFlow through `torch.utils.tensorboard`
(about 10 s a process here), and the two-rank BERT and LoRA runs compute
bf16 on the CPU over gloo (~100 s and ~340 s alone, 240 s and 500 s
beside other tests).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples_torch"
slow = pytest.mark.slow

# (script and arguments, lines its output must hold)
CASES = [
    pytest.param(("distributed_fn_example",),
                 ["distributed_fn_example OK: 4 ranks ran"],
                 id="distributed_fn"),
    pytest.param(("mnist_keras_example",),
                 ["run metrics: Metrics(", "'ckpt-25', 'ckpt-50'"],
                 id="mnist_keras", marks=slow),
    pytest.param(("linear_classifier_example",), ["run metrics: Metrics("],
                 id="linear_classifier", marks=slow),
    pytest.param(("dlrm_example",), ["run metrics: Metrics("], id="dlrm"),
    pytest.param(("mlflow_example",),
                 ["mlflow not installed: running with the no-op shim",
                  "run metrics: Metrics("],
                 id="mlflow", marks=slow),
    pytest.param(("collective_allreduce_example",),
                 ["run metrics: Metrics(", "'chief:0'", "'worker:0'"],
                 id="collective_allreduce", marks=slow),
    pytest.param(("llama_lora_example",),
                 ["merged adapter model serves plain: (1, 8, 1024)"],
                 id="llama_lora", marks=slow),
    pytest.param(("pytorch_example",),
                 ["run metrics: Metrics(", "model_2.pt"],
                 id="pytorch", marks=slow),
    pytest.param(("evaluator_sidecar_example",),
                 ["evaluated: [", "'eval-done-60.json'"],
                 id="evaluator_sidecar", marks=slow),
    pytest.param(("ship_requirements_example",),
                 ["ship_requirements_example OK"], id="ship_requirements"),
    pytest.param(("generate_example",),
                 ["trained to loss",
                  "greedy continuation of [1,2,3,4]: "
                  "[1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 4]"],
                 id="generate", marks=slow),
    pytest.param(("serving_example",),
                 ["request 3: P=7 max_new=8", "tick trace"], id="serving"),
    pytest.param(("serving_example", "--spec"),
                 ["spec_k=3", "speculative: accept_rate="],
                 id="serving_spec"),
    pytest.param(("serving_example", "--tp"),
                 ["tp=2:", "request 3: P=7 max_new=8"], id="serving_tp"),
    pytest.param(("serving_example", "fleet"),
                 ["2 replicas healthy", "after-stop 2:",
                  "'serving:1': 'healthy'"], id="serving_fleet"),
    pytest.param(("ranking_example",),
                 ["request 5: rows=3", "14 rows in"], id="ranking"),
    pytest.param(("ranking_example", "--tp"),
                 ["tp=2:", "request 5: rows=3", "14 rows in"],
                 id="ranking_tp"),
]


def test_every_example_has_a_case():
    scripts = {case.values[0][0] for case in CASES}
    assert scripts == {path.stem for path in EXAMPLES.glob("*.py")}
    assert len(scripts) == 13
    runner = (EXAMPLES / "run_examples.sh").read_text()
    for case in CASES:
        assert " ".join(case.values[0]) in runner


@pytest.mark.parametrize("command,expected", CASES)
def test_example_runs_on_the_cpu(command, expected, tmp_path):
    script, *args = command
    env = {k: v for k, v in os.environ.items()
           if k not in ("TPU_YARN_PLATFORM", "PYTHONPATH")}
    env.update(EXAMPLE_PLATFORM="cpu", TMPDIR=str(tmp_path),
               PYTHONPATH=str(REPO))
    run = subprocess.run(
        [sys.executable, str(EXAMPLES / f"{script}.py"), *args], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=900)
    output = run.stdout + run.stderr
    assert run.returncode == 0, output[-4000:]
    for line in expected:
        assert line in run.stdout, (line, run.stdout[-4000:])
