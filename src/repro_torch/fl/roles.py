"""The three tiers of the paper's framework as explicit roles (port of
``repro.fl.roles``).

``Device`` owns a private shard and the bottom layers; ``Gateway`` trains the
offloaded top layers, combines halves and aggregates its shop floor;
``BaseStation`` aggregates globally and runs the scheduler. The numerics
are ``repro_torch.fl.split``'s; these classes own state + data flow.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.fl import split as split_lib
from repro_torch.fl.cohort import stack_params, weighted_mean
from repro_torch.fl.data import FLDataset, sample_batch
from repro_torch.models.split_model import Params, SplitModel


@dataclasses.dataclass
class Device:
    idx: int
    gateway: int
    d_size: int           # |D_n|
    d_tilde: int          # training batch size

    def local_round(self, model: SplitModel, global_params: Params,
                    ds: FLDataset, l_split: int, k_iters: int, lr: float,
                    rng: np.random.Generator):
        """One device's local training at partition point l (with its
        gateway co-executing the top blocks)."""
        x, y = sample_batch(rng, ds, self.idx, self.d_tilde)
        device = split_lib.leaves(global_params)[0].device
        return split_lib.local_train(
            model, global_params, torch.as_tensor(x, device=device),
            torch.as_tensor(y, device=device), l_split, k_iters, lr)


@dataclasses.dataclass
class Gateway:
    idx: int
    devices: List[Device]

    def shop_floor_round(self, model: SplitModel, global_params: Params,
                         ds: FLDataset, l_splits: np.ndarray, k_iters: int,
                         lr: float, rng: np.random.Generator):
        """Run all associated devices, combine halves, FedAvg the shop
        floor."""
        results, weights, losses = [], [], []
        for i, dev in enumerate(self.devices):
            w_n, loss = dev.local_round(model, global_params, ds,
                                        int(l_splits[i]), k_iters, lr, rng)
            results.append(w_n)
            weights.append(dev.d_tilde)
            losses.append(loss)
        combined = fedavg(results, np.asarray(weights, float))
        return combined, float(np.mean(losses)), float(np.sum(weights))


class BaseStation:
    def __init__(self, model: SplitModel, params: Params):
        self.plan = model       # the SplitModel handle (legacy attr name)
        self.params = params

    def aggregate(self, models: List[Params], weights: np.ndarray):
        if models:
            self.params = fedavg(models, np.asarray(weights, float))
        return self.params


def fedavg(models: List[Params], weights: np.ndarray) -> Params:
    """FedAvg over a list of layer-list params: stack each leaf over the
    models and contract the stack with the normalized weights."""
    device = split_lib.leaves(models[0])[0].device
    w = torch.as_tensor(weights / weights.sum(), dtype=torch.float32,
                        device=device)
    return weighted_mean(stack_params(models), w)
