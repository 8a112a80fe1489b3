"""Invertible-sketch ops in torch: the twin of the invertible heavy-hitter
family (``-hh.sketch invertible``).

Counterpart of flow_pipeline_tpu/ops/invsketch.py. One pure per-bucket
fold over the murmur3 buckets of ops/cms.py replaces the candidate
table:

    cms[p, d, b]    += addend_u64(vals[p])           (every plane)
    keysum[d, b, l] += key[l] * cnt                  (wrap mod 2^64)
    keycheck[d, b]  += inv_key_hash(key) * cnt       (wrap mod 2^64)

so the state is linear in the stream: a merge is an element-wise wrap
sum, and heavy keys are recovered from the sketch at window close by
peeling pure buckets (``inv_decode``).

dtype: the planes are uint64 in the reference, but torch's uint64 has
no shift, floor division, ordering, subtraction or ``index_add_``. They
are kept as int64 tensors holding the uint64 bit patterns instead: add,
subtract, multiply and xor wrap mod 2^64 alike in both, so the bits are
the reference's. What differs is done by hand: logical right shifts
(an arithmetic shift and a mask), unsigned comparison (``_ult``, the
sign bit flipped) and unsigned division (``_udiv``). ``to_u64`` and
``from_u64`` convert to and from numpy uint64.

The home of this family is the host dataplane (hostsketch/engine.py
np_inv_* and native hs_inv_*); no entry point calls this twin, as none
of the reference's calls its own. It runs on tensors of any device: on
the card ``index_add_`` over int64 is an atomic add, whose wrap sum does
not depend on the order, so the card's state is bit-equal to the CPU's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..schema.keys import as_u32, hash_words
from .cms import cms_buckets

# Checksum-hash protocol constants (hostsketch/engine.py np_inv_key_hash
# and native inv_key_hash), as the int64 values of their bit patterns
_U64 = 1 << 64
INV_HASH_SEED = 0x9E3779B97F4A7C15 - _U64
INV_HASH_M1 = 0xFF51AFD7ED558CCD - _U64
INV_HASH_M2 = 0xC4CEB9FE1A85EC53 - _U64
_I64_MIN = -(1 << 63)
_U32_MAX = 0xFFFFFFFF

_TWO63 = float(1 << 63)
_TWO64 = float(1 << 64)
# the largest float32 below 2^64 (hostsketch/state.py _U64_CAP's twin)
_U64_CAP = float(np.float32(1.8446742e19))


def _require_i64(arr: torch.Tensor) -> None:
    if arr.dtype != torch.int64:
        raise TypeError(
            "invertible-sketch planes must be int64 (uint64 bit "
            f"patterns); got {arr.dtype}")


def to_u64(t: torch.Tensor) -> np.ndarray:
    """An int64 plane as a host numpy uint64 array (the same bits)."""
    return t.detach().cpu().numpy().view(np.uint64)


def from_u64(a, device="cpu") -> torch.Tensor:
    """A uint64 numpy array as an int64 tensor on ``device``."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of the uint64 bit pattern by 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _ult(a: torch.Tensor, b) -> torch.Tensor:
    """a < b as uint64 bit patterns."""
    return (a ^ _I64_MIN) < (b ^ _I64_MIN)


def _udiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a // b as uint64 bit patterns, b != 0. A divisor at or past 2^63
    (negative here) goes at most once; otherwise the halved dividend is
    divided as a signed int64 and one correction step fixes the low
    bit."""
    neg = b < 0
    bs = torch.where(neg, torch.ones_like(b), b)
    q = ((_lsr(a, 1) // bs) << 1)
    r = a - q * bs
    q = q + (~_ult(r, bs)).to(torch.int64)
    big = (~_ult(a, b)).to(torch.int64)
    return torch.where(neg, big, q)


def inv_init(planes: int, depth: int, width: int, key_width: int,
             device="cuda"):
    """Fresh state: (cms [P, D, W], keysum [D, W, kw], keycheck [D, W]),
    int64 zeros."""
    return (torch.zeros((planes, depth, width), dtype=torch.int64,
                        device=device),
            torch.zeros((depth, width, key_width), dtype=torch.int64,
                        device=device),
            torch.zeros((depth, width), dtype=torch.int64, device=device))


def inv_key_hash(keys: torch.Tensor) -> torch.Tensor:
    """[N] checksum hash (uint64 bits in int64) over [N, W] uint32 key
    lanes, wrap arithmetic mod 2^64."""
    lanes = as_u32(keys)
    h = torch.full((lanes.shape[0],), INV_HASH_SEED, dtype=torch.int64,
                   device=lanes.device)
    for lane in range(lanes.shape[1]):
        h = h ^ lanes[:, lane]
        h = h * INV_HASH_M1
        h = h ^ _lsr(h, 33)
    h = h * INV_HASH_M2
    return h ^ _lsr(h, 29)


def _addend_u64(vals: torch.Tensor) -> torch.Tensor:
    """float32 addends -> uint64 bits with the host sketch's clamp:
    negatives and NaN add nothing, at or past 2^64 (inf included) is
    UINT64_MAX, the rest cast exactly (at or past 2^63 through the
    offset, which float32 holds exactly there)."""
    v = vals.to(torch.float32)
    v = torch.where(torch.isnan(v) | (v <= 0), torch.zeros_like(v), v)
    big = v >= _TWO64
    v = torch.clamp(v, max=_U64_CAP)
    hi = v >= _TWO63
    low = torch.where(hi, v - _TWO63, v).to(torch.int64)
    out = torch.where(hi, low + _I64_MIN, low)
    return torch.where(big, torch.full_like(out, -1), out)


def inv_update(cms, keysum, keycheck, keys, values, valid=None):
    """One pre-aggregated update, in place (the torch ops' convention):
    keys [N, kw] uint32 lanes of unique keys, values [N, P] addends with
    the count plane LAST, valid [N] bool (invalid rows add nothing).
    Returns (cms, keysum, keycheck)."""
    for arr in (cms, keysum, keycheck):
        _require_i64(arr)
    p, d, w = cms.shape
    lanes = as_u32(keys)
    add = _addend_u64(values)
    if valid is not None:
        add = torch.where(valid[:, None], add, torch.zeros_like(add))
    cnt = add[:, -1]
    check = inv_key_hash(lanes) * cnt
    lanes_u64 = lanes * cnt[:, None]
    # every depth row at once: bucket b of row di is flat cell di*w + b
    flat = (cms_buckets(lanes, d, w)
            + torch.arange(d, device=lanes.device)[:, None] * w).reshape(-1)
    cms.view(p, d * w).index_add_(1, flat, add.T.repeat(1, d))
    keysum.view(d * w, -1).index_add_(0, flat, lanes_u64.repeat(d, 1))
    keycheck.view(d * w).index_add_(0, flat, check.repeat(d))
    return cms, keysum, keycheck


def inv_merge(*states):
    """Per-shard states combined: the element-wise wrap sum of every
    plane."""
    cms, keysum, keycheck = states[0]
    for c, ks, kc in states[1:]:
        cms = cms + c
        keysum = keysum + ks
        keycheck = keycheck + kc
    return cms, keysum, keycheck


def inv_decode(cms, keysum, keycheck):
    """Heavy-key recovery by peeling pure buckets (the inputs stay as
    they are). Each round's purity scan runs on the state's device; the
    data-dependent round loop, and the choice of the keys it decodes,
    on the host. Returns numpy (keys [K, kw] uint32, vals [K, P] uint64)
    in lexicographic key order, equal to np_inv_decode's and native
    hs_inv_decode's (the recoverable set does not depend on the peel
    order)."""
    for arr in (cms, keysum, keycheck):
        _require_i64(arr)
    cms, keysum, keycheck = cms.clone(), keysum.clone(), keycheck.clone()
    p, depth, width = cms.shape
    kw = keysum.shape[2]
    dev = cms.device
    out_keys: list[np.ndarray] = []
    out_vals: list[np.ndarray] = []
    seen: set[bytes] = set()
    cols = torch.arange(width, device=dev)
    cand = (cms[-1] != 0).cpu().numpy()
    while cand.any():
        cnt = cms[-1]  # [D, W]
        safe = torch.where(cnt != 0, cnt, torch.ones_like(cnt))
        q = _udiv(keysum, safe[:, :, None])  # [D, W, kw]
        # q <= 0xFFFFFFFF as uint64 is 0 <= q <= 0xFFFFFFFF as int64
        ok = (cnt != 0) & (q * safe[:, :, None] == keysum).all(dim=2) \
            & ((q >= 0) & (q <= _U32_MAX)).all(dim=2)
        qk = q & _U32_MAX
        for di in range(depth):
            h = inv_key_hash(qk[di]) * safe[di]
            ok[di] &= (h == keycheck[di]) \
                & (hash_words(qk[di], seed=di) % width == cols)
        ok_np = ok.cpu().numpy() & cand
        d_idx, b_idx = np.nonzero(ok_np)
        if not len(d_idx):
            break
        dec = qk[torch.from_numpy(d_idx).to(dev),
                 torch.from_numpy(b_idx).to(dev)].cpu().numpy() \
            .astype(np.uint32)  # [m, kw]
        kview = np.ascontiguousarray(dec).view(
            [("", np.uint32)] * kw).reshape(-1)
        _, first = np.unique(kview, return_index=True)
        picked = [i for i in sorted(first)
                  if kview[i].tobytes() not in seen]
        if not picked:
            break
        for i in picked:
            seen.add(kview[i].tobytes())
        picked = np.asarray(picked)
        dec_keys = np.ascontiguousarray(dec[picked])
        pd = torch.from_numpy(d_idx[picked]).to(dev)
        pb = torch.from_numpy(b_idx[picked]).to(dev)
        vals = cms[:, pd, pb].T.contiguous()  # [k, P]
        out_keys.append(dec_keys)
        out_vals.append(to_u64(vals))
        # peel: take each decoded key's exact contribution out of its
        # bucket in every depth row (wrap), then rescan what it touched
        tkeys = torch.from_numpy(dec_keys.astype(np.int64)).to(dev)
        dcnt = vals[:, -1]
        check = inv_key_hash(tkeys) * dcnt
        lanes_u64 = tkeys * dcnt[:, None]
        touched = np.zeros((depth, width), bool)
        for di in range(depth):
            bb = hash_words(tkeys, seed=di) % width
            cms[:, di].index_add_(1, bb, -vals.T)
            keysum[di].index_add_(0, bb, -lanes_u64)
            keycheck[di].index_add_(0, bb, -check)
            touched[di, bb.cpu().numpy()] = True
        cand = touched & (cms[-1] != 0).cpu().numpy()
    if not out_keys:
        return (np.zeros((0, kw), np.uint32), np.zeros((0, p), np.uint64))
    keys = np.concatenate(out_keys)
    vals = np.concatenate(out_vals)
    order = np.lexsort(keys.T[::-1])
    return (np.ascontiguousarray(keys[order]),
            np.ascontiguousarray(vals[order]))
