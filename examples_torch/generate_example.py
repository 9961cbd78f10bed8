"""Train, then generate: the whole lifecycle of the decoder family — the
port's counterpart of examples/generate_example.py.

Trains a tiny LM on a repeating pattern in this process, checkpoints
it, restores the checkpoint on the host, and continues a prompt greedily
with the KV-cache decode path (`models.generate.generate`) — the
inference counterpart of llama_lora_example.py.

    python examples_torch/generate_example.py

Mesh: one device, this process. The JAX example trains at
``MeshSpec(dp=8)`` on 8 virtual CPU devices; the model fits one card
many times over, and data parallelism is collective_allreduce_example's
subject. The batches come from a seeded generator, so the card's run and
the CPU's (``EXAMPLE_PLATFORM=cpu``) see the same tokens.
"""

import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
# On the card unless EXAMPLE_PLATFORM=cpu.
DEVICE = os.environ.get("EXAMPLE_PLATFORM", "cuda")

MODEL_DIR = os.path.join(tempfile.gettempdir(), "gpu_yarn_generate_demo")


def main() -> None:
    import numpy as np

    from tf_yarn_tpu_torch import checkpoint as ckpt
    from tf_yarn_tpu_torch.experiment import as_core_experiment
    from tf_yarn_tpu_torch.models.generate import generate
    from tf_yarn_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
        make_experiment,
    )
    from tf_yarn_tpu_torch.training import train_and_evaluate

    pattern = np.tile(np.arange(1, 9, dtype=np.int32), 16)

    def input_fn():
        rng = np.random.RandomState(0)
        while True:
            starts = rng.randint(0, 8, 8)
            yield {
                "tokens": np.stack(
                    [pattern[s:s + 32] for s in starts]
                ).astype(np.int32)
            }

    config = TransformerConfig.tiny(vocab_size=16, max_seq_len=64)
    experiment = make_experiment(
        config,
        model_dir=MODEL_DIR,
        train_steps=150,
        batch_size=8,
        seq_len=32,
        learning_rate=3e-3,
        input_fn=input_fn,
        log_every_steps=50,
    )
    shutil.rmtree(MODEL_DIR, ignore_errors=True)  # a fresh run
    metrics = train_and_evaluate(as_core_experiment(experiment),
                                 device=DEVICE)
    print(f"trained to loss {metrics['loss']:.4f}")

    state = ckpt.restore_checkpoint_host(MODEL_DIR, 150)
    model = Transformer(config, device=DEVICE)
    model.load_state_dict(state["params"])
    prompt = np.asarray([[1, 2, 3, 4]], np.int32)
    out = generate(model, prompt, max_new_tokens=8, temperature=0.0)
    continuation = out.cpu().numpy()[0].tolist()
    print("greedy continuation of [1,2,3,4]:", continuation)
    assert continuation[:4] == [1, 2, 3, 4], continuation


if __name__ == "__main__":
    main()
