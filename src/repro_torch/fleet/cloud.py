"""Cloud-side detector queue/batcher shared by the whole fleet.

Anchor and test requests from many vehicles land on a pool of cloud GPUs.
The server batches requests that arrive in the same scheduling round: a
batch of ``b`` frames costs ``infer_s * (1 + marginal * (b - 1))`` —
per-item time shrinks with batch size (amortized pre/post-processing and
kernel launch), while *queueing delay* grows whenever a server is still
busy with earlier batches. This is the fleet-level coupling the
single-stream engine cannot express: one vehicle's anchor storm inflates
every other vehicle's anchor latency.

Multi-GPU serving (``CloudBatcherConfig.n_gpus``): batches are dispatched
round-robin over G per-GPU queues, so a congested fleet's anchor latency
falls as the pool grows (monotonicity and busy-time conservation are
tier-1 invariants, tests/test_cloud_multigpu.py). An optional *batch
window* (``window_s``) closes a batch early when the next request arrives
more than the window after the batch's first request — without it all of a
round's requests batch together (the original behavior, and still the G=1
default).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class CloudBatcherConfig:
    # Single-frame detector latency on one cloud GPU. None = filled by the
    # engine from the detector + cloud profile (lets presets configure the
    # pool shape without naming a detector).
    infer_s: Optional[float] = None
    marginal: float = 0.35  # marginal cost of each extra frame in a batch
    max_batch: int = 32     # detector batch-size ceiling
    n_gpus: int = 1         # GPU pool size (round-robin dispatch)
    # Batch window: a batch also closes when the next request arrived more
    # than window_s after the batch's first request. None = round batching
    # only (all requests submitted together form one batch, as before).
    window_s: Optional[float] = None


def replace_config(cfg: CloudBatcherConfig, **kw) -> CloudBatcherConfig:
    """dataclasses.replace, re-exported so engine code doesn't need the
    dataclasses import just to fill ``infer_s``."""
    return dataclasses.replace(cfg, **kw)


class CloudBatcher:
    """Deterministic multi-server batching queue (host-side model)."""

    def __init__(self, cfg: CloudBatcherConfig):
        if cfg.infer_s is None:
            raise ValueError("CloudBatcherConfig.infer_s is unset; the "
                             "engine fills it from the detector profile")
        if cfg.n_gpus < 1:
            raise ValueError(f"n_gpus must be >= 1, got {cfg.n_gpus}")
        self.cfg = cfg
        # Optional observability sink (repro_torch.obs.Observer): receives
        # one on_cloud_batch(gpu, start, finish, batch, last_arrive) call per
        # dispatched batch. None (the default) is a single pointer test
        # per batch — the timing model itself never consults it.
        self.sink = None
        self.reset()

    def reset(self) -> None:
        self.busy_until_g = [0.0] * self.cfg.n_gpus
        self.busy_s_g = [0.0] * self.cfg.n_gpus   # accumulated service time
        self._rr = 0                              # next GPU (round-robin)

    @property
    def busy_until(self) -> float:
        """The pool frees up when its last GPU does (G=1: that GPU)."""
        return max(self.busy_until_g)

    @property
    def busy_s(self) -> float:
        """Total GPU-seconds of service dispatched so far (conservation:
        equals the summed batch_infer_time of every served batch)."""
        return sum(self.busy_s_g)

    def batch_infer_time(self, batch_size: int) -> float:
        b = max(min(batch_size, self.cfg.max_batch), 1)
        return self.cfg.infer_s * (1.0 + self.cfg.marginal * (b - 1))

    def _batches(self, order: Sequence[int],
                 arrive_times: Sequence[float]) -> List[List[int]]:
        """Split one round (arrival-sorted indices) into batches: closed at
        ``max_batch``, and — when a window is configured — when the next
        request arrived more than ``window_s`` after the batch opener."""
        batches: List[List[int]] = []
        for i in order:
            if batches and len(batches[-1]) < self.cfg.max_batch and (
                    self.cfg.window_s is None
                    or arrive_times[i] - arrive_times[batches[-1][0]]
                    <= self.cfg.window_s):
                batches[-1].append(i)
            else:
                batches.append([i])
        return batches

    def submit_batch(self, arrive_times: Sequence[float]) -> List[float]:
        """Serve one round of requests; returns per-request completion time.

        Requests of a round are batched together (chunked at ``max_batch``
        / the batch window, earliest arrivals first) and the batches are
        dispatched round-robin over the GPU pool; each batch starts when
        both its GPU is free and every request in the batch has arrived.
        """
        if not len(arrive_times):
            return []
        order = sorted(range(len(arrive_times)), key=lambda i: arrive_times[i])
        done = [0.0] * len(arrive_times)
        for chunk in self._batches(order, arrive_times):
            g = self._rr % self.cfg.n_gpus
            self._rr = (g + 1) % self.cfg.n_gpus
            last_arrive = max(arrive_times[i] for i in chunk)
            start = max(self.busy_until_g[g], last_arrive)
            service = self.batch_infer_time(len(chunk))
            finish = start + service
            self.busy_until_g[g] = finish
            self.busy_s_g[g] += service
            if self.sink is not None:
                self.sink.on_cloud_batch(g, start, finish, len(chunk),
                                         last_arrive)
            for i in chunk:
                done[i] = finish
        return done
