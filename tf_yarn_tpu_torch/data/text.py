"""Text -> token-batch pipeline for causal-LM training — the port's copy
of tf_yarn_tpu/data/text.py.

Tokenizes text files line by line, packs the tokens into fixed-length
windows (no padding) and shards lines across ranks. It yields numpy
``{"tokens": [batch, seq_len] int32}``, what
`models.transformer.make_experiment(input_fn=...)` consumes; the train
loop makes the ids int64 where it places the batch.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np


def load_tokenizer(name_or_path: str):
    """A HuggingFace tokenizer (a local path, or a hub name, which needs
    the network); `transformers` is imported only here."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(name_or_path)


def pack_tokens(
    token_stream: Iterator[List[int]], seq_len: int
) -> Iterator[np.ndarray]:
    """Concatenate documents and emit fixed [seq_len] int32 windows."""
    buffer: List[int] = []
    for tokens in token_stream:
        buffer.extend(tokens)
        while len(buffer) >= seq_len:
            yield np.asarray(buffer[:seq_len], np.int32)
            buffer = buffer[seq_len:]


class TextDataset:
    """{.txt files} -> {"tokens": [batch, seq_len] int32} batches.

    `tokenize_fn` maps a line to token ids: ``load_tokenizer(...).encode``
    or any callable, so the pipeline itself needs no network. Non-empty
    lines are numbered across the files; rank r keeps the lines whose
    number is r modulo `world_size`. With `repeat` the files are read
    again and again; a rank whose lines make no full window then raises.
    """

    def __init__(
        self,
        paths: "str | Sequence[str]",
        tokenize_fn,
        batch_size: int,
        seq_len: int,
        rank: int = 0,
        world_size: int = 1,
        repeat: bool = False,
    ) -> None:
        self.paths = [paths] if isinstance(paths, str) else list(paths)
        self.tokenize_fn = tokenize_fn
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.rank = rank
        self.world_size = world_size
        self.repeat = repeat

    def _token_stream(self) -> Iterator[List[int]]:
        line_idx = 0
        for path in self.paths:
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    if line_idx % self.world_size == self.rank:
                        yield list(self.tokenize_fn(line))
                    line_idx += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            sequences: List[np.ndarray] = []
            windows = 0
            for window in pack_tokens(self._token_stream(), self.seq_len):
                windows += 1
                sequences.append(window)
                if len(sequences) == self.batch_size:
                    yield {"tokens": np.stack(sequences)}
                    sequences = []
            if not self.repeat:
                return
            if windows == 0:
                raise ValueError(
                    f"rank {self.rank}/{self.world_size} produced no full "
                    f"{self.seq_len}-token window from {self.paths}; cannot "
                    "repeat forever without data"
                )
