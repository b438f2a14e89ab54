"""Candidate generation, plain PyTorch: sorted per-read match lists ->
top-k classification candidates with contiguous-window-range hit counts.

Counterpart of metacache_tpu/ops/candidates.py::generate_candidates
(src/candidates.h:118-285), result-identical to every branch of it:

  * for each match j, the window range is the maximal run i..j of the
    same target with win_j - win_i < numWindows; its hit count is
    j - i + 1 (i is a lower bound, found with searchsorted on packed
    (target << 32 | window) keys);
  * per target, the FIRST range achieving the maximal hit count wins;
  * targets map to candidate taxa (target_cand_tax); per taxon the
    candidate with max hits wins, ties to the first achiever: the
    smallest hp = (L - hits) * P2 + pos;
  * the top-k taxa by ascending hp.

torch.sort has no multi-key sort, so each key tuple is packed into one
int64.

merge_candidates is the cross-shard merge of per-shard candidate lists
(JAX _dedup_topk).
"""
from __future__ import annotations

import torch

from metacache_tpu.config import TARGET_SENTINEL

_BIG32 = int(TARGET_SENTINEL)            # 2^31 - 1: "no key"
_BIG64 = torch.iinfo(torch.int64).max
_M32 = (1 << 32) - 1


def generate_candidates(tgt: torch.Tensor, win: torch.Tensor,
                        num_windows: torch.Tensor,
                        target_cand_tax: torch.Tensor,
                        max_candidates: int):
    """Top-k candidates per read.

    Args:
      tgt, win: [B, L] int64 match lists sorted by (tgt, win); padding
                rows carry tgt == TARGET_SENTINEL.
      num_windows: [B] per-read maxWindowsInRange
                (src/classification.cpp:217-219)
      target_cand_tax: [T+1] int64 target -> candidate taxon node; the
                last entry is scratch for the sentinel target.
      max_candidates: top-k size.

    Returns dict of [B, min(L, k)] int64 tensors: tax, hits, beg, end, tgt
    (tax == 0 marks an empty slot, whose tgt is TARGET_SENTINEL).
    """
    B, L = tgt.shape
    dev = tgt.device
    P2 = 1 << max(1, L - 1).bit_length()
    if L * P2 + P2 > _M32:
        raise ValueError(f"match-list width {L} too large for the packed "
                         "(hits, pos) key")
    T1 = target_cand_tax.shape[0]
    valid = tgt != int(TARGET_SENTINEL)
    pos = torch.arange(L, device=dev).expand(B, L)

    # ---- per-match contiguous-range hit count -----------------------------
    # stored windows are >= 0, so clamping the query window at 0 is exact
    pk = (tgt << 32) | win
    qwin = (win - (num_windows.long()[:, None] - 1)).clamp(min=0)
    left = torch.searchsorted(pk, (tgt << 32) | qwin)
    hits = torch.where(valid, pos - left + 1, 0)

    # ---- per target: first achiever of the max hit count -------------------
    new_seg = torch.ones_like(valid)
    new_seg[:, 1:] = tgt[:, 1:] != tgt[:, :-1]
    seg = new_seg.long().cumsum(dim=1) - 1 \
        + torch.arange(B, device=dev)[:, None] * L
    flat = seg.flatten()
    seg_best = torch.zeros(B * L, dtype=torch.int64, device=dev) \
        .scatter_reduce_(0, flat, hits.flatten(), "amax")[seg]
    achiever = valid & (hits == seg_best)
    first = torch.full((B * L,), L, dtype=torch.int64, device=dev) \
        .scatter_reduce_(0, flat, torch.where(achiever, pos, L).flatten(),
                         "amin")[seg]
    rep = achiever & (pos == first)

    # ---- dedup by candidate taxon: max hits, first achiever on ties --------
    mapped = target_cand_tax[torch.where(valid, tgt, T1 - 1)]
    key = torch.where(rep, mapped, _BIG32)
    hp = (L - hits) * P2 + pos
    s_dk = ((key << 32) | hp).sort(dim=1).values
    s_key = s_dk >> 32
    winner = torch.ones_like(valid)
    winner[:, 1:] = s_key[:, 1:] != s_key[:, :-1]
    winner &= s_key != _BIG32

    # ---- top-k by ascending hp ---------------------------------------------
    f_hp, f_idx = torch.where(winner, s_dk & _M32, _BIG64).sort(dim=1)
    C = min(max_candidates, L)
    f_hp, f_idx = f_hp[:, :C], f_idx[:, :C]
    ok = f_hp != _BIG64
    f_pos = (f_hp % P2).clamp(max=L - 1)
    beg = win.gather(1, left.gather(1, f_pos).clamp(0, L - 1))
    return {
        "tax": torch.where(ok, s_key.gather(1, f_idx), 0),
        "hits": torch.where(ok, L - f_hp // P2, 0),
        "beg": torch.where(ok, beg, 0),
        "end": torch.where(ok, win.gather(1, f_pos), 0),
        "tgt": torch.where(ok, tgt.gather(1, f_pos), int(TARGET_SENTINEL)),
    }


def merge_candidates(cand, max_candidates: int):
    """Merge candidate lists of several shards (JAX _dedup_topk; the
    cross-rank re-insertion of src/querying.h:958-971).

    Args:
      cand: dict of [B, P*C] int64 tensors tax, hits, beg, end, tgt: the
            shards' lists side by side (tax == 0 marks an empty slot).
      max_candidates: the merged list's width.

    Per taxon the candidate with max hits wins, the smallest target id on
    ties; winners are ordered by (hits desc, target id asc) and cut to
    max_candidates. A target's matches live on one shard and target ids
    are global, so this order is the single engine's first-achiever order
    and the merge is shard-count invariant. Empty slots: tax 0, tgt
    TARGET_SENTINEL.
    """
    tax, hits, tgt = cand["tax"], cand["hits"], cand["tgt"]
    key = torch.where(tax > 0, tax, _BIG32)
    # (taxon asc, hits desc, target asc): two stable sorts, the secondary
    # key first
    order = tgt.sort(dim=1, stable=True).indices
    k1 = ((key << 32) | (_M32 - hits)).gather(1, order)
    order = order.gather(1, k1.sort(dim=1, stable=True).indices)
    s_key = key.gather(1, order)
    winner = torch.ones_like(s_key, dtype=torch.bool)
    winner[:, 1:] = s_key[:, 1:] != s_key[:, :-1]
    winner &= s_key != _BIG32
    # (hits desc, target asc) in one word: hits < 2^32, targets < 2^31
    s_hits, s_tgt = hits.gather(1, order), tgt.gather(1, order)
    word = torch.where(winner, ((_M32 - s_hits) << 31) | s_tgt, _BIG64)
    f_word, f_idx = word.sort(dim=1)
    C = min(max_candidates, tax.shape[1])
    ok = f_word[:, :C] != _BIG64
    pick = order.gather(1, f_idx[:, :C])
    out = {name: torch.where(ok, cand[name].gather(1, pick), 0)
           for name in ("tax", "hits", "beg", "end")}
    out["tgt"] = torch.where(ok, tgt.gather(1, pick), int(TARGET_SENTINEL))
    return out
