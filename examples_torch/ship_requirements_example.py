"""Shipping third-party dependencies with the run — the port's
counterpart of examples/ship_requirements_example.py.

A worker image that lacks a library the experiment imports would fail
to unpickle it; `requirements=` resolves wheels on the driver and the
workers ``pip install --no-index`` them before unpickling. This example
runs fully offline by hand-building the wheel and passing it through
`wheels_dir=` (the air-gapped path); with network on the driver you
would pass just ``requirements=["mylib==1.2"]``.

    python examples_torch/ship_requirements_example.py

Nothing here touches a device, so the run is the same with or without
``EXAMPLE_PLATFORM=cpu``.
"""

import os
import sys
import tempfile
import zipfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ["PYTHONPATH"] = REPO + os.pathsep + os.environ.get("PYTHONPATH", "")
# On the card unless EXAMPLE_PLATFORM=cpu; the launched tasks inherit it.
os.environ["TPU_YARN_PLATFORM"] = os.environ.get("EXAMPLE_PLATFORM", "cuda")


def _make_demo_wheel(out_dir: str) -> None:
    """A minimal local wheel standing in for a real `pip download`."""
    name, version = "shippeddemo", "1.0"
    info = f"{name}-{version}.dist-info"
    wheel = os.path.join(out_dir, f"{name}-{version}-py3-none-any.whl")
    with zipfile.ZipFile(wheel, "w") as zf:
        zf.writestr(f"{name}.py", "GREETING = 'imported from a shipped wheel'\n")
        zf.writestr(f"{info}/METADATA",
                    f"Metadata-Version: 2.1\nName: {name}\nVersion: {version}\n")
        zf.writestr(f"{info}/WHEEL",
                    "Wheel-Version: 1.0\nGenerator: example\n"
                    "Root-Is-Purelib: true\nTag: py3-none-any\n")
        zf.writestr(f"{info}/RECORD", f"{name}.py,,\n{info}/METADATA,,\n"
                    f"{info}/WHEEL,,\n{info}/RECORD,,\n")


def experiment_fn(out_dir):
    def run(params):
        import shippeddemo  # importable only because the wheel shipped

        print(f"rank {params.rank}: {shippeddemo.GREETING}")
        with open(os.path.join(out_dir, f"rank-{params.rank}"), "w") as fh:
            fh.write(shippeddemo.__file__)

    return run


if __name__ == "__main__":
    from tf_yarn_tpu_torch import TaskSpec, run_on_gpu

    with tempfile.TemporaryDirectory() as wheels, \
            tempfile.TemporaryDirectory() as out_dir:
        _make_demo_wheel(wheels)
        run_on_gpu(
            lambda: experiment_fn(out_dir),
            {"worker": TaskSpec(instances=2)},
            custom_task_module="tf_yarn_tpu_torch.tasks.distributed",
            # ship_code=True: the LocalBackend used here does not ship by
            # default; remote backends do.
            ship_code=True,
            requirements=["shippeddemo"],
            wheels_dir=wheels,
            name="ship_requirements",
        )
        imported = [open(os.path.join(out_dir, name)).read()
                    for name in sorted(os.listdir(out_dir))]
    print("shippeddemo imported from", imported)
    assert len(imported) == 2 and all("_pydeps" in p for p in imported), \
        imported
    print("ship_requirements_example OK")
