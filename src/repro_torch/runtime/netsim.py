"""4G/LTE bandwidth-trace network simulator (Table 2 reproduction).

The paper replays FCC and Belgium cellular traces through Linux TC. We
synthesize trace time series matching each trace's published statistics
(mean, std, range, quartiles — Table 2) with an AR(1) process calibrated to
cellular coherence, then simulate byte-accurate transfers over the varying
link. Transfer simulation integrates the rate curve; an optional RTT-based
handshake models TCP setup.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceStats:
    mean: float      # Mbps
    std: float
    lo: float
    hi: float
    p25: float
    median: float
    p75: float


# Table 2 of the paper.
TRACE_STATS: Dict[str, TraceStats] = {
    "fcc1": TraceStats(11.89, 2.83, 7.76, 17.76, 9.09, 12.08, 13.42),
    "fcc2": TraceStats(16.69, 4.69, 8.824, 28.157, 13.91, 16.07, 19.43),
    "belgium1": TraceStats(23.89, 4.93, 16.02, 33.33, 19.84, 23.46, 27.73),
    "belgium2": TraceStats(29.60, 4.92, 20.17, 37.345, 25.18, 30.761, 32.76),
}


def synthesize_trace(name: str, seconds: float = 600.0, dt: float = 0.1,
                     seed: int = 0) -> np.ndarray:
    """AR(1) series (Mbps per dt tick) matching the trace statistics."""
    st = TRACE_STATS[name]
    # Stable per-trace stream: crc32, not hash() — Python string hashing is
    # randomized per process, which made trace realizations (and every
    # engine run) differ run to run for the same seed.
    rng = np.random.default_rng(zlib.crc32(name.encode()) % (2 ** 31) + seed)
    n = int(seconds / dt)
    rho = 0.98  # cellular bandwidth coherence at 100 ms
    x = np.empty(n)
    x[0] = 0.0
    innov = rng.normal(0, 1, n)
    for i in range(1, n):
        x[i] = rho * x[i - 1] + np.sqrt(1 - rho ** 2) * innov[i]
    bw = st.mean + st.std * x
    return np.clip(bw, st.lo, st.hi)


class NetworkSim:
    """Byte-accurate transfer times over a synthesized bandwidth trace."""

    def __init__(self, trace_name: str, seed: int = 0, rtt_s: float = 0.030):
        self.name = trace_name
        self.dt = 0.1
        self.trace = synthesize_trace(trace_name, seed=seed)
        self.rtt_s = rtt_s
        self.t = 0.0  # wall clock (s)

    def reset(self):
        self.t = 0.0

    def advance(self, seconds: float):
        self.t += seconds

    def current_bw_mbps(self, n_sharers: int = 1) -> float:
        """The fair-share uplink bandwidth (Mbps) the trace delivers at the
        current wall time — the observed-bandwidth telemetry engines feed
        the adaptive scheduler."""
        i = int(self.t / self.dt) % len(self.trace)
        return float(self.trace[i]) / max(int(n_sharers), 1)

    def transfer_time(self, n_bytes: int, start_t: float = None, *,
                      n_sharers: int = 1) -> float:
        """Seconds to push n_bytes starting at start_t (default: now).

        ``n_sharers`` concurrent senders split the trace bandwidth into
        equal fair shares (see :class:`SharedUplink`); the default of 1
        is the single-vehicle case.
        """
        t = self.t if start_t is None else start_t
        share = 1.0 / max(int(n_sharers), 1)
        remaining = n_bytes * 8 / 1e6  # megabits
        elapsed = self.rtt_s           # connection/request overhead
        i = int((t + elapsed) / self.dt)
        while remaining > 0:
            bw = self.trace[i % len(self.trace)] * share  # fair-share Mbps
            sent = bw * self.dt
            if sent >= remaining:
                elapsed += remaining / bw
                remaining = 0.0
            else:
                remaining -= sent
                elapsed += self.dt
                i += 1
        return elapsed

    def send(self, n_bytes: int) -> float:
        """Advance the clock by the transfer and return its duration."""
        d = self.transfer_time(n_bytes)
        self.t += d
        return d

    def transfer_breakdown(self, n_bytes: int, total_s: float, *,
                           n_sharers: int = 1) -> Dict[str, float]:
        """Decompose an already-computed :meth:`transfer_time` result into
        the handshake/payload parts plus the effective fair-share rate —
        span annotations for the repro_torch.obs virtual timeline (pure
        bookkeeping: never re-integrates the trace, so observability adds
        no timing work)."""
        payload = max(total_s - self.rtt_s, 1e-12)
        return {"rtt_s": self.rtt_s, "payload_s": payload,
                "eff_mbps": n_bytes * 8 / 1e6 / payload,
                "n_sharers": int(n_sharers)}


class SharedUplink(NetworkSim):
    """A cell's uplink shared by N concurrent vehicle streams.

    The trace bandwidth is the cell's total uplink capacity; pass
    ``n_sharers`` to :meth:`NetworkSim.transfer_time` and each concurrent
    sender gets an equal fair share (TCP-fair, the standard cellular
    approximation), so per-transfer times degrade monotonically with
    fleet-level contention. ``n_sharers=1`` reduces exactly to
    :class:`NetworkSim` — single-vehicle behaviour is the fixed point.
    """


def validate_trace(name: str, tol: float = 0.15) -> dict:
    """Stats of the synthesized trace vs Table 2 (used by tests)."""
    st = TRACE_STATS[name]
    tr = synthesize_trace(name)
    got = {
        "mean": float(tr.mean()), "std": float(tr.std()),
        "p25": float(np.percentile(tr, 25)),
        "median": float(np.percentile(tr, 50)),
        "p75": float(np.percentile(tr, 75)),
    }
    want = {"mean": st.mean, "std": st.std, "p25": st.p25,
            "median": st.median, "p75": st.p75}
    return {"got": got, "want": want}
