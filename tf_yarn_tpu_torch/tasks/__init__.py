"""Task programs, each run as ``python -m tf_yarn_tpu_torch.tasks.<name>``
by a backend: `worker` (chief and worker tasks: a `TorchExperiment` or
an `InferenceExperiment`) and `distributed` (a function of
`TaskParameters` per local rank)."""
