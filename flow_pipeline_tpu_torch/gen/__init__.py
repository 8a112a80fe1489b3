"""Synthetic flow generation (the reference's "mocker" role, ref: mocker/mocker.go).

Two modes:

- ``MockerProfile``: behavior parity with the reference generator — uniform
  Bytes<1500 / Packets<100, SrcAS/DstAS in 65000..65002, 2001:db8:0:1::/112
  addresses with a random last byte, random ports, EType 0x86dd (IPv6),
  SamplingRate 1, TimeFlowStart == TimeReceived, monotonically increasing
  SequenceNum (ref: mocker/mocker.go:57-91).
- ``ZipfProfile``: seeded heavy-tailed key distribution over a configurable
  key universe, so top-K heavy-hitter error is measurable (SURVEY.md §4:
  "a seeded skewed distribution (Zipf over the 9-key tuple) so top-K error
  is measurable").

Generation is vectorized straight into columnar FlowBatch form — no
per-message Python loop on the hot path.
"""

from .generator import FlowGenerator, MockerProfile, ZipfProfile

__all__ = ["FlowGenerator", "MockerProfile", "ZipfProfile"]
