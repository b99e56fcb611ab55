"""Negative edge samplers.

The port of ``gnn_tail_generalization_tpu/linkpred/sampling.py`` (the
reference's ``Link_prediction_model/negative_sample.py``):
- global:      uniform non-edge pairs (existing edges and self loops
  excluded), [B, num_neg, 2];
- global_perm: one batch of uniform non-edges, permuted copies;
- local:       fixed source from the positive edge, random destination.

The host part (``edge_keys``, ``rejection_sample_non_edges``,
``build_membership``) gives the original's outputs, with a sort in place of
``np.unique`` and a binary search in place of ``np.isin``: at the
ogbl-citation2 shape numpy 2.3 took 33 s and 45 s for those two on the H100
host. The device part draws
from the caller's ``torch.Generator``: uniform pairs, a membership test
against the hashed edge set, and a fixed number of redraw rounds for the
pairs that hit an edge (a survivor of every round is kept, an O(E/N^2)
approximation, as in the JAX package). The random streams differ from
JAX's by design.

The hash is int32 arithmetic with wraparound. The device test computes it in
int64 and keeps the low 32 bits as two's complement, so it equals numpy's
bit for bit for any node id: a key that differed would let a real edge pass
as a negative.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from ..graph.core import sorted_unique

#: multiplicative-hash constants; int32 wraparound is deliberate. A hash
#: collision only causes a valid negative to be resampled (over-rejection);
#: a real edge is always detected — exactly the safe direction here.
_H1, _H2 = np.int32(-1640531527), np.int32(97)  # 2654435761 wrapped, prime


def _hash32(src, dst):
    return src * _H1 + dst * _H2


def edge_keys(edge_index: np.ndarray, n_node: int) -> np.ndarray:
    """Sorted int32 hash keys of (src, dst) pairs + self loops, for
    membership tests (the reference adds self loops before sampling,
    negative_sample.py:7,23)."""
    e = np.asarray(edge_index, np.int64)
    with np.errstate(over="ignore"):
        keys = _hash32(e[0].astype(np.int32), e[1].astype(np.int32))
        loops = np.arange(n_node, dtype=np.int32)
        lkeys = _hash32(loops, loops)
    return sorted_unique(np.concatenate([keys, lkeys]))


def _in_sorted(values: np.ndarray, keys_sorted: np.ndarray) -> np.ndarray:
    """``np.isin(values, keys_sorted)`` by a binary search of the sorted
    keys (graph/core.py:sorted_unique says why not numpy's own)."""
    pos = np.searchsorted(keys_sorted, values)
    np.minimum(pos, len(keys_sorted) - 1, out=pos)
    return keys_sorted[pos] == values


def rejection_sample_non_edges(rng, keys_sorted: np.ndarray, n_node: int,
                               count: int) -> np.ndarray:
    """Host-side uniform non-edge sampler shared by simple_split_edges and
    the surgery edge splitter: redraw until ``count`` candidate pairs pass
    the hashed-edge-set membership and self-loop filters. Returns
    [count, 2] int64."""
    out = np.empty((count, 2), np.int64)
    filled = 0
    while filled < count:
        cand = rng.integers(0, n_node, (2, max(count * 2, 16)))
        with np.errstate(over="ignore"):
            ck = _hash32(cand[0].astype(np.int32), cand[1].astype(np.int32))
        ok = ~_in_sorted(ck, keys_sorted) & (cand[0] != cand[1])
        take = min(count - filled, int(ok.sum()))
        out[filled:filled + take] = cand[:, ok][:, :take].T
        filled += take
    return out


#: empty-slot sentinel for the hash-bucket membership table. A real key
#: equal to the sentinel is simply routed to the spill array at build
#: time, so the device test stays exact.
_EMPTY = np.int32(-(2**31))


@dataclasses.dataclass(frozen=True)
class Membership:
    """O(1) edge-membership structure: hashed keys bucketized into
    [n_buckets, 8] int32 rows plus a SORTED spill array for overflowing
    buckets and sentinel-valued keys. One row gather and 8 compares replace
    a binary search over the whole sorted key array."""

    buckets: torch.Tensor  # [n_buckets, slots] int32, _EMPTY = free
    spill: torch.Tensor  # [n_spill] int32 sorted

    def to(self, device) -> "Membership":
        return Membership(self.buckets.to(device), self.spill.to(device))


def build_membership(keys_sorted: np.ndarray,
                     slots: int = 8) -> Membership:
    """Host-side bucketize of edge_keys output (unique int32 hashes)."""
    keys = np.asarray(keys_sorted, np.int32)
    n_buckets = max(1, int(2 ** np.ceil(np.log2(max(len(keys), 2) / 2))))
    ok = keys != _EMPTY
    spill_list = [keys[~ok]]
    keys = keys[ok]
    b = keys.astype(np.uint32) & np.uint32(n_buckets - 1)
    order = np.argsort(b, kind="stable")
    bs, ks = b[order], keys[order]
    # rank within bucket
    starts = np.searchsorted(bs, np.arange(n_buckets, dtype=np.uint32))
    rank = np.arange(len(ks)) - starts[bs]
    fits = rank < slots
    table = np.full((n_buckets, slots), _EMPTY, np.int32)
    table[bs[fits], rank[fits]] = ks[fits]
    spill_list.append(ks[~fits])
    spill = np.sort(np.concatenate(spill_list)).astype(np.int32)
    if len(spill) == 0:
        spill = np.asarray([_EMPTY], np.int32)  # never empty: one lookup path
    return Membership(buckets=torch.from_numpy(table),
                      spill=torch.from_numpy(spill))


Keys = Union[Membership, torch.Tensor]


def hash32(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``_hash32`` on integer tensors: the int32 value (with wraparound) of
    ``src * _H1 + dst * _H2``, computed in int64, as int64."""
    v = (src.long() * int(_H1) + dst.long() * int(_H2)) & 0xFFFFFFFF
    return torch.where(v >= 2**31, v - 2**32, v)


def _is_member(keys: Keys, src: torch.Tensor, dst: torch.Tensor
               ) -> torch.Tensor:
    """Membership test against ``keys``: a Membership table (one row
    gather + spill check) or a sorted int32 key tensor (binary search)."""
    cand64 = hash32(src, dst)
    cand = cand64.to(torch.int32)
    if isinstance(keys, Membership):
        # the two's-complement low bits of the signed key are the uint32 ones
        rows = keys.buckets[cand64 & (keys.buckets.shape[0] - 1)]
        hit = (rows == cand[:, None]).any(dim=-1)
        pos = torch.searchsorted(keys.spill, cand).clamp_(
            0, keys.spill.shape[0] - 1)
        return hit | (keys.spill[pos] == cand)
    pos = torch.searchsorted(keys, cand).clamp_(0, keys.shape[0] - 1)
    return keys[pos] == cand


def global_neg_sample(generator: torch.Generator, keys: Keys, n_node: int,
                      num_samples: int, num_neg: int, rounds: int = 3
                      ) -> torch.Tensor:
    """[num_samples, num_neg, 2] int64 uniform non-edges, on the
    generator's device."""
    total = num_samples * num_neg
    dev = generator.device

    def draw():
        return torch.randint(0, n_node, (2, total), generator=generator,
                             device=dev)

    src, dst = draw()
    for _ in range(rounds):
        bad = _is_member(keys, src, dst)
        s2, d2 = draw()
        src = torch.where(bad, s2, src)
        dst = torch.where(bad, d2, dst)
    return torch.stack([src, dst], dim=-1).reshape(num_samples, num_neg, 2)


def global_perm_neg_sample(generator: torch.Generator, keys: Keys,
                           n_node: int, num_samples: int, num_neg: int,
                           perm_within: int = 0) -> torch.Tensor:
    """One uniform non-edge batch + (num_neg-1) permuted copies
    (negative_sample.py:21-26,42-57). ``perm_within`` > 0 permutes within
    consecutive groups of that size (epoch-batched draws: each step's
    slice keeps the reference's permute-within-the-minibatch semantics)."""
    base = global_neg_sample(generator, keys, n_node, num_samples, 1)[:, 0]
    grp = perm_within if perm_within else num_samples
    if num_samples % grp:
        raise ValueError(f"{num_samples} samples do not split into groups "
                         f"of {grp}")
    n_grp = num_samples // grp
    grouped = base.reshape(n_grp, grp, 2)
    outs = [base]
    for _ in range(num_neg - 1):
        # an independent permutation per group (per step when epoch-batched)
        perms = torch.rand(n_grp, grp, generator=generator,
                           device=generator.device).argsort(dim=1)
        outs.append(torch.take_along_dim(grouped, perms[:, :, None], dim=1)
                    .reshape(-1, 2))
    return torch.stack(outs, dim=1)  # [num_samples, num_neg, 2]


def local_neg_sample(generator: torch.Generator, pos_edges: torch.Tensor,
                     n_node: int, num_neg: int) -> torch.Tensor:
    """Fixed src, uniform dst (negative_sample.py:28-40). [B, num_neg, 2]
    int64."""
    b = pos_edges.shape[0]
    dev = generator.device
    src = pos_edges[:, 0].long().repeat_interleave(num_neg)
    dst = torch.randint(0, n_node, (num_neg * b,), generator=generator,
                        device=dev)
    return torch.stack([src, dst], dim=-1).reshape(b, num_neg, 2)
