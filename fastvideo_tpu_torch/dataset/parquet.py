"""Batch samplers of the latents dataset (port of the pyarrow-free part of
fastvideo_tpu/dataset/parquet.py). The Parquet reader itself is not
ported: the card's machine has no pyarrow (ROADMAP Queue 1)."""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np


class DPSPBatchSampler:
    """Seeded, resumable batch sampler; one batch per dp group per step.
    The order is a numpy permutation seeded by ``seed + epoch``, the same
    as the JAX package's."""

    def __init__(self, dataset_len: int, batch_size: int, num_dp_groups: int,
                 dp_group_rank: int = 0, seed: int = 42,
                 drop_last: bool = True):
        self.dataset_len = dataset_len
        self.batch_size = batch_size
        self.num_dp_groups = num_dp_groups
        self.dp_group_rank = dp_group_rank
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __iter__(self) -> Iterator[list[int]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        perm = rng.permutation(self.dataset_len)
        global_bs = self.batch_size * self.num_dp_groups
        n_batches = (self.dataset_len // global_bs if self.drop_last else
                     -(-self.dataset_len // global_bs))
        for b in range(n_batches):
            start = b * global_bs + self.dp_group_rank * self.batch_size
            yield [int(i) for i in perm[start:start + self.batch_size]]
        self.epoch += 1

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = state["epoch"]
        self.seed = state["seed"]


class _AccumSampler:
    """Groups ``accum`` micro-batch index lists into one train-step item,
    leaving epoch and state to the underlying DPSPBatchSampler."""

    def __init__(self, base: DPSPBatchSampler, accum: int):
        self.base = base
        self.accum = max(1, int(accum))

    def __iter__(self):
        group: list[list[int]] = []
        for indices in self.base:
            group.append(indices)
            if len(group) == self.accum:
                yield group
                group = []

    @property
    def epoch(self) -> int:
        return self.base.epoch

    @epoch.setter
    def epoch(self, value: int) -> None:
        self.base.epoch = int(value)

    def state_dict(self) -> dict:
        return self.base.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.base.load_state_dict(state)
