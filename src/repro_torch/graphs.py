"""CUDA graphs for the port's scanned loops: the counterpart of the
reference's ``lax.scan`` programs.

A step of the decide plane (``core/ddsra_batched.py``,
``core/baseline_batched.py``) or of the fused training loop
(``fl/cohort.py``'s ``train_scan``; under the sharded engine each half of
a round around its ``all_reduce``) reads nothing on the host, so on CUDA
it is captured once per set of input shapes as one
``torch.cuda.CUDAGraph`` and replayed every round. On the CPU the same
step functions run eagerly.
"""
from __future__ import annotations

import gc
from typing import Dict

import torch

# CUDA graphs captured, by step: "round" a DDSRA round (a plan captures one
# per lane count), "baseline" a fixed-resource round (one per rule and lane
# count), "train_scan" a trained round of the fused loop (one per model,
# tier shapes, K, dtype and data plane), "eval" its test-set hit count;
# under the sharded engine a trained round is two graphs around its
# all_reduce, "train_local" (the rank's slots up to their FedAvg sums) and
# "train_finish" (the averages and the guards). The CPU captures none.
# chip_smoke.py reads it.
CAPTURE_COUNTS = {"round": 0, "baseline": 0, "train_scan": 0, "eval": 0,
                  "train_local": 0, "train_finish": 0}


class GraphedStep:
    """``fn`` over a flat tuple of tensors, returning a tuple of tensors.

    On the CPU it runs eagerly. On CUDA the first call for each set of
    input shapes captures it as one ``torch.cuda.CUDAGraph`` (after one
    warm-up run on a side stream) into static input and output buffers;
    every call copies its inputs in and replays. The outputs are the
    graph's own buffers: the next call overwrites them, so a caller keeps
    them by copying. A capture that fails raises: no call runs eagerly
    on CUDA.

    Nothing outside the step may touch the device while it is captured.
    Python's cyclic collector could run mid-capture and free a dead
    object that holds an earlier graph (a finished simulation's), whose
    teardown ends the capture; so the collector runs before the capture
    and is held off during it. The capture mode is ``thread_local``, as
    torch's own captures use: a call another thread makes meanwhile (the
    profiler's CUPTI thread, a checkpoint writer) does not end it, while
    an unsafe call on the capturing thread (a host read in the step)
    still does."""

    def __init__(self, fn, key: str):
        self.fn, self.key = fn, key      # key: the CAPTURE_COUNTS entry
        self.graphs: Dict[tuple, tuple] = {}

    def __call__(self, *args):
        if args[0].device.type != "cuda":
            return self.fn(*args)
        shapes = tuple(tuple(a.shape) for a in args)
        hit = self.graphs.get(shapes)
        if hit is None:
            hit = self.graphs[shapes] = self._capture(args)
        graph, static_in, static_out = hit
        for dst, src in zip(static_in, args):
            dst.copy_(src)
        graph.replay()
        return static_out

    def _capture(self, args):
        static_in = tuple(a.clone() for a in args)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(*static_in)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                static_out = self.fn(*static_in)
        finally:
            if collecting:
                gc.enable()
        CAPTURE_COUNTS[self.key] += 1
        return graph, static_in, static_out


def scan_rounds(step, rounds: int, inputs_at, queues0):
    """``rounds`` calls of ``step(*inputs_at(t, queues))``, threading the
    queues (the step's last output) from each round into the next; returns
    each output stacked over a leading round axis. Nothing is read on the
    host."""
    outs = None
    queues = queues0
    for t in range(rounds):
        got = step(*inputs_at(t, queues))
        if outs is None:
            outs = [torch.empty((rounds, *x.shape), dtype=x.dtype,
                                device=x.device) for x in got]
        for buf, x in zip(outs, got):
            buf[t].copy_(x)
        queues = outs[-1][t]
    return outs
