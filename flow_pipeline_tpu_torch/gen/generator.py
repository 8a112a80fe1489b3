"""Vectorized synthetic flow generators."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..schema.batch import FlowBatch
from ..schema.message import FlowType


@dataclass
class MockerProfile:
    """Reference-parity random flows (ref: mocker/mocker.go:57-91)."""

    max_bytes: int = 1500
    max_packets: int = 100
    as_base: int = 65000
    as_count: int = 3
    etype: int = 0x86DD
    sampling_rate: int = 1
    # 2001:db8:0:1::/112 with a random final byte, both sides
    prefix: bytes = bytes(
        [0x20, 0x01, 0x0D, 0xB8, 0x00, 0x00, 0x00, 0x01, 0, 0, 0, 0, 0, 0, 0]
    )


@dataclass
class ZipfProfile:
    """Heavy-tailed traffic over a fixed key universe.

    ``n_keys`` distinct flow keys (addr pair, port pair, proto, AS pair) are
    drawn once from the seed; flows sample keys with P(rank r) ~ 1/r^alpha.
    Byte/packet sizes stay uniform like the mocker so ranking differences come
    from key frequency, which is what the sketches estimate.
    """

    n_keys: int = 10_000
    alpha: float = 1.2
    # flowspread legs: a slice of every batch is emitted by dedicated
    # spreader sources whose FAN-OUT (distinct dst addrs / dst ports per
    # source) is itself harmonically skewed — rank r touches ~fanout/(r+1)
    # distinct targets. Even ranks are superspreaders (many dst addrs, one
    # port), odd ranks are port scanners (one victim, many dst ports).
    # The default 0.0 draws nothing and keeps pre-r21 streams
    # byte-identical for any seed.
    spread_fraction: float = 0.0
    spread_sources: int = 32
    spread_fanout: int = 4096
    max_bytes: int = 1500
    max_packets: int = 100
    as_base: int = 65000
    as_count: int = 16
    etype: int = 0x86DD
    sampling_rate: int = 1
    prefix: bytes = bytes(
        [0x20, 0x01, 0x0D, 0xB8, 0x00, 0x00, 0x00, 0x01, 0, 0, 0, 0, 0, 0, 0]
    )


class FlowGenerator:
    """Seeded flow source producing columnar batches.

    Time model: flows arrive at ``rate`` flows/sec starting at ``t0``;
    time_received advances deterministically so window-boundary behavior is
    reproducible. (The reference emits ~4 msg/s wall-clock,
    ref: mocker/mocker.go:17-18,56 — here rate is a parameter because the
    framework's job is millions of flows/sec.)
    """

    def __init__(
        self,
        profile: MockerProfile | ZipfProfile | None = None,
        seed: int = 0,
        t0: int = 1_700_000_000,
        rate: float = 100_000.0,
    ):
        self.profile = profile if profile is not None else MockerProfile()
        self.rng = np.random.default_rng(seed)
        self.t0 = t0
        self.rate = rate
        self._emitted = 0  # flows so far; drives SequenceNum + timestamps
        if isinstance(self.profile, ZipfProfile):
            self._key_table = self._build_key_table(self.profile)
            self._key_probs = self._zipf_probs(self.profile)

    # ---- zipf key universe -------------------------------------------------

    def _build_key_table(self, p: ZipfProfile) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(self.rng.integers(2**63))
        n = p.n_keys
        prefix_words = (
            np.frombuffer(p.prefix + b"\x00", dtype=">u4").astype(np.uint32).copy()
        )

        def addrs():
            a = np.tile(prefix_words, (n, 1))
            # random last two bytes -> up to 65536 distinct hosts per side
            a[:, 3] = (a[:, 3] & np.uint32(0xFFFF0000)) | rng.integers(
                0, 2**16, n, dtype=np.uint32
            )
            return a

        return {
            "src_addr": addrs(),
            "dst_addr": addrs(),
            "src_port": rng.integers(1024, 2**16, n, dtype=np.uint64),
            "dst_port": rng.choice(
                np.array([53, 80, 123, 443, 8080], dtype=np.uint64), n
            ),
            "proto": rng.choice(np.array([6, 17], dtype=np.uint64), n),
            "src_as": p.as_base + rng.integers(0, p.as_count, n, dtype=np.uint64),
            "dst_as": p.as_base + rng.integers(0, p.as_count, n, dtype=np.uint64),
        }

    @staticmethod
    def _zipf_probs(p: ZipfProfile) -> np.ndarray:
        ranks = np.arange(1, p.n_keys + 1, dtype=np.float64)
        w = ranks**-p.alpha
        return w / w.sum()

    # ---- batch generation --------------------------------------------------

    def batch(self, n: int) -> FlowBatch:
        """Generate the next n flows as a FlowBatch."""
        p = self.profile
        rng = self.rng
        out = FlowBatch.empty(n)
        cols = out.columns

        idx0 = self._emitted
        ts = (self.t0 + (idx0 + np.arange(n)) / self.rate).astype(np.uint64)
        cols["type"][:] = FlowType.SFLOW_5
        cols["time_received"][:] = ts
        cols["time_flow_start"][:] = ts
        cols["time_flow_end"][:] = ts
        cols["sampling_rate"][:] = p.sampling_rate
        cols["sequence_num"][:] = (idx0 + np.arange(n)) & 0xFFFFFFFF
        cols["etype"][:] = p.etype
        cols["bytes"][:] = rng.integers(0, p.max_bytes, n, dtype=np.uint64)
        cols["packets"][:] = rng.integers(0, p.max_packets, n, dtype=np.uint64)

        if isinstance(p, ZipfProfile):
            ranks = rng.choice(p.n_keys, size=n, p=self._key_probs)
            t = self._key_table
            cols["src_addr"][:] = t["src_addr"][ranks]
            cols["dst_addr"][:] = t["dst_addr"][ranks]
            for name in ("src_port", "dst_port", "proto", "src_as", "dst_as"):
                cols[name][:] = t[name][ranks].astype(cols[name].dtype)
            k = int(round(n * p.spread_fraction))
            if k:
                self._spread_legs(cols, n - k, k)
        else:
            prefix_words = (
                np.frombuffer(p.prefix + b"\x00", dtype=">u4").astype(np.uint32).copy()
            )
            for side in ("src_addr", "dst_addr"):
                a = np.tile(prefix_words, (n, 1))
                a[:, 3] = (a[:, 3] & np.uint32(0xFFFFFF00)) | rng.integers(
                    0, 256, n, dtype=np.uint32
                )
                cols[side][:] = a
            cols["src_as"][:] = p.as_base + rng.integers(0, p.as_count, n, dtype=np.uint64)
            cols["dst_as"][:] = p.as_base + rng.integers(0, p.as_count, n, dtype=np.uint64)
            cols["src_port"][:] = rng.integers(0, 2**16, n, dtype=np.uint64)
            cols["dst_port"][:] = rng.integers(0, 2**16, n, dtype=np.uint64)
            cols["proto"][:] = 0

        self._emitted += n
        return out

    def _spread_legs(self, cols: dict, off: int, k: int) -> None:
        """Overwrite the last ``k`` rows with spreader-leg flows (zipf
        profile only; see ZipfProfile.spread_fraction). Sources sit at
        fixed suffixes (0xF000 | rank); the random zipf table can collide
        into that range, which only adds background noise the detectors
        must tolerate anyway."""
        p = self.profile
        rng = self.rng
        nsrc = p.spread_sources
        ranks = rng.choice(nsrc, size=k, p=self._spread_probs(nsrc))
        # harmonic fan-out: rank r touches ~fanout/(r+1) distinct targets
        fanout = np.maximum(p.spread_fanout // (ranks + 1), 8)
        elem = rng.integers(0, fanout, k).astype(np.uint32)
        prefix_words = (
            np.frombuffer(p.prefix + b"\x00", dtype=">u4").astype(np.uint32).copy()
        )
        sl = slice(off, off + k)
        src = np.tile(prefix_words, (k, 1))
        src[:, 3] = (src[:, 3] & np.uint32(0xFFFF0000)) | np.uint32(0xF000) | ranks
        cols["src_addr"][sl] = src
        scanner = (ranks & 1) == 1
        dst = np.tile(prefix_words, (k, 1))
        # superspreaders fan across dst addrs on one port; scanners hold
        # one victim addr and fan across dst ports
        dst[:, 3] = (dst[:, 3] & np.uint32(0xFFFF0000)) | np.where(
            scanner, np.uint32(0xE000) | ranks, elem)
        cols["dst_addr"][sl] = dst
        cols["dst_port"][sl] = np.where(scanner, elem % 65536, 443)
        cols["src_port"][sl] = rng.integers(1024, 2**16, k, dtype=np.uint64)
        cols["proto"][sl] = 6
        cols["src_as"][sl] = p.as_base
        cols["dst_as"][sl] = p.as_base

    @staticmethod
    def _spread_probs(nsrc: int) -> np.ndarray:
        w = 1.0 / np.arange(1, nsrc + 1, dtype=np.float64)
        return w / w.sum()
