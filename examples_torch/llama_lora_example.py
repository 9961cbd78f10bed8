"""LoRA fine-tune of the llama-style decoder — the port's counterpart of
examples/llama_lora_example.py (BASELINE.json config 5's workload).

The base weights stay frozen and only the LoRA adapters train, with the
decoder cut over ``MeshSpec(tp=2)``: two ranks (a chief and a worker of
`allreduce_topology`) each hold half of every attention and MLP kernel,
and the activations' all-reduces cross them inside every layer. The
driver then folds the trained adapters into the base kernels
(`merge_lora`) and serves the merged weights at ``lora_rank=0``.

    python examples_torch/llama_lora_example.py

The config is a small decoder so the example runs anywhere; substitute
``TransformerConfig.llama3_8b(lora_rank=16, attention_impl="flash")`` on
a host with a card a rank.

Mesh: ``tp=2`` over two ranks. The JAX example runs
``MeshSpec(dp=2, fsdp=2, tp=2)`` over 8 virtual CPU devices; a host
with one card a rank would run the same tp=2 beside dp over NCCL. Here
both ranks share the one card (or the CPU) and talk gloo, since NCCL
refuses two ranks on one device, and FSDP2 over gloo on a shared card is
not a path the port takes (ROADMAP "The card").
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

MODEL_DIR = os.path.join(tempfile.gettempdir(), "gpu_yarn_llama_lora")


def lora_config():
    from tf_yarn_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=1024,
        d_model=256,
        n_layers=4,
        n_heads=8,
        n_kv_heads=4,
        d_ff=512,
        max_seq_len=512,
        lora_rank=8,
    )


def experiment_fn():
    from tf_yarn_tpu_torch import MeshSpec
    from tf_yarn_tpu_torch.models.transformer import make_experiment

    return make_experiment(
        lora_config(),
        model_dir=MODEL_DIR,
        train_steps=30,
        batch_size=8,
        seq_len=128,
        learning_rate=1e-4,
        mesh_spec=MeshSpec(tp=2),
        log_every_steps=5,
    )


if __name__ == "__main__":
    from tf_yarn_tpu_torch import allreduce_topology, run_on_gpu

    shutil.rmtree(MODEL_DIR, ignore_errors=True)  # a fresh run
    metrics = run_on_gpu(
        experiment_fn, allreduce_topology(nb_workers=1), name="llama_lora"
    )
    print("run metrics:", metrics)

    # Deployment: fold the trained adapters into the base weights; the
    # merged state dict serves under lora_rank=0 with no adapter math.
    import dataclasses

    import torch

    from tf_yarn_tpu_torch import checkpoint as ckpt_lib
    from tf_yarn_tpu_torch.models.transformer import Transformer, merge_lora

    step = ckpt_lib.latest_checkpoint_step(MODEL_DIR)
    assert step == 30, f"checkpoint step {step}"
    # The one-device format whatever the tp degree: rank 0 gathered the
    # shards before it wrote.
    state = ckpt_lib.restore_checkpoint_host(MODEL_DIR, step)
    config = lora_config()
    merged = merge_lora(state["params"], config)
    plain_cfg = dataclasses.replace(config, lora_rank=0)
    device = "cpu" if os.environ["TPU_YARN_PLATFORM"] == "cpu" else "cuda"
    model = Transformer(plain_cfg, device=device)
    model.load_state_dict(merged)
    with torch.no_grad():
        logits = model(torch.zeros((1, 8), dtype=torch.long, device=device))
    print("merged adapter model serves plain:", tuple(logits.shape))
    assert tuple(logits.shape) == (1, 8, config.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
