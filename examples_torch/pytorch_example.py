"""PytorchExperiment run — the port's counterpart of
examples/pytorch_example.py.

DDP training of a small CNN through the pytorch worker
(`pytorch.run_on_gpu`): two worker tasks, a `DistributedSampler` loader
in each, the user's `main_fn`, TensorBoard from rank 0 and a torch
checkpoint through `utils.model_ckpt`.

    python examples_torch/pytorch_example.py

Ranks: two workers, each on the card (or the CPU). They share the one
card, so the group talks gloo (``backend="gloo"``): NCCL refuses two ranks
on one device. With a card a rank, leave ``backend`` unset and the
worker picks NCCL.
"""

import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ["PYTHONPATH"] = REPO + os.pathsep + os.environ.get("PYTHONPATH", "")
# On the card unless EXAMPLE_PLATFORM=cpu; the launched tasks inherit it.
os.environ["TPU_YARN_PLATFORM"] = os.environ.get("EXAMPLE_PLATFORM", "cuda")

MODEL_DIR = os.path.join(tempfile.gettempdir(), "gpu_yarn_pytorch")


def experiment_fn():
    import torch

    from tf_yarn_tpu_torch.pytorch import DataLoaderArgs, PytorchExperiment

    x = torch.randn(256, 1, 16, 16)
    y = (x.mean(dim=(1, 2, 3)) > 0).long()
    dataset = torch.utils.data.TensorDataset(x, y)

    model = torch.nn.Sequential(
        torch.nn.Conv2d(1, 8, 3, padding=1),
        torch.nn.ReLU(),
        torch.nn.AdaptiveAvgPool2d(1),
        torch.nn.Flatten(),
        torch.nn.Linear(8, 2),
    )

    def main_fn(model, loader, device, rank, tb_writer):
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        loss_fn = torch.nn.CrossEntropyLoss()
        for epoch in range(2):
            for step, (xb, yb) in enumerate(loader):
                opt.zero_grad()
                loss = loss_fn(model(xb.to(device)), yb.to(device))
                loss.backward()
                opt.step()
            if rank == 0:
                print(f"epoch {epoch}: loss={loss.item():.4f} on {device}")
                if tb_writer is not None:
                    tb_writer.add_scalar("loss", loss.item(), epoch)
        if rank == 0:
            from tf_yarn_tpu_torch.utils import model_ckpt

            model_ckpt.save_ckpt(MODEL_DIR, model, opt, epoch=2)

    return PytorchExperiment(
        model=model,
        main_fn=main_fn,
        train_dataset=dataset,
        dataloader_args=DataLoaderArgs(batch_size=32),
        tensorboard_log_dir=os.path.join(MODEL_DIR, "tb"),
        backend="gloo",
    )


if __name__ == "__main__":
    from tf_yarn_tpu_torch import TaskSpec
    from tf_yarn_tpu_torch.pytorch import run_on_gpu
    from tf_yarn_tpu_torch.utils import model_ckpt

    shutil.rmtree(MODEL_DIR, ignore_errors=True)  # a fresh run
    metrics = run_on_gpu(
        experiment_fn, {"worker": TaskSpec(instances=2)}, name="pytorch_ddp"
    )
    print("run metrics:", metrics)
    saved = model_ckpt.load_latest_ckpt(MODEL_DIR)
    assert saved is not None and saved["epoch"] == 2, "no model_2.pt"
    print("checkpoint", model_ckpt.find_latest_ckpt(MODEL_DIR))
