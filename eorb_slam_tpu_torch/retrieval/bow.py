"""Bag-of-words place recognition as dense tensor math.

PyTorch port of ``eorb_slam_tpu/retrieval/bow.py`` (reference DBoW2 +
KeyFrameDatabase). The vocabulary is a codebook of binary words stored as
+-1 int8 rows: quantizing a frame is one (N,256)x(256,V) product (Hamming
distance is affine in the +-1 dot product; the products are integers of
magnitude <= 256, exact in f32), and a database query is a masked reduction
against the stored tf(-idf) rows. At real-vocabulary scale a 2-level
``HierVocab`` picks a coarse cell, then the word inside it, and keyframes
keep sparse (word id, weight) rows.

Scoring is DBoW2's L1 score: s(v, w) = sum_i min(v_i, w_i) for
L1-normalized nonneg vectors. ``detect_candidates`` follows
DetectNBestCandidates: a common-word gate at 0.8 x the best count, the L1
score, and the top k with equal scores in slot order (as ``lax.top_k``).

Randomness: the k-means seeds come from :func:`_draw_init_words` (parity
tests replace it with ``jax.random.choice``'s draws); the hierarchical
trainer's empty-cell fill uses numpy's ``default_rng(seed + 1)``, the same
generator as the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from eorb_slam_tpu_torch.ops.fast import _top_k_stable


def _draw_init_words(seed: int, n: int, n_words: int, device) -> torch.Tensor:
    """(n_words,) indices of the initial centroids among n descriptors:
    without replacement when there are enough, with replacement otherwise."""
    g = torch.Generator().manual_seed(seed)
    if n >= n_words:
        idx = torch.randperm(n, generator=g)[:n_words]
    else:
        idx = torch.randint(0, n, (n_words,), generator=g)
    return idx.to(device)


def train_vocab(desc_pm1: torch.Tensor, n_words: int, iters: int = 8,
                seed: int = 0) -> torch.Tensor:
    """Binary k-means on +-1 descriptors -> (V,256) int8 codebook. Lloyd
    iterations with sign() binarization of the mean keep the centroids
    binary. The sums are integers, exact in f32 in any order."""
    desc = desc_pm1.to(torch.float32)
    n = desc.shape[0]
    words = desc[_draw_init_words(seed, n, n_words, desc.device)]
    for _ in range(iters):
        assign = torch.argmax(desc @ words.T, dim=1)               # (n,)
        sums = torch.zeros_like(words).index_add(0, assign, desc)  # (V,256)
        counts = torch.zeros(n_words, dtype=torch.float32, device=desc.device)
        counts = counts.index_add(0, assign, torch.ones_like(desc[:, 0]))
        words = torch.where(counts[:, None] > 0, torch.sign(sums + 0.5), words)
    return words.to(torch.int8)


def _read_leaves(path: str, max_words: int | None):
    """Leaf words (V,256) +-1 int8 and their weights (V,) of a DBoW2 text
    vocabulary (ORBvoc.txt: header `k L s w`, then one node per line:
    parent_id is_leaf d0..d31 weight)."""
    leaves, wts = [], []
    with open(path) as f:
        f.readline()  # header
        for line in f:
            parts = line.split()
            if len(parts) < 34 or parts[1] != "1":
                continue
            by = np.array([int(b) for b in parts[2:34]], np.uint8)
            leaves.append(np.unpackbits(by).astype(np.int8) * 2 - 1)
            wts.append(float(parts[34]) if len(parts) > 34 else 1.0)
            if max_words and len(leaves) >= max_words:
                break
    return np.stack(leaves), np.asarray(wts, np.float32)


def load_vocab_text(path: str, max_words: int | None = None) -> np.ndarray:
    """Import a DBoW2 text vocabulary: its leaf descriptors as a (V,256) +-1
    int8 codebook (TemplatedVocabulary::loadFromTextFile)."""
    return _read_leaves(path, max_words)[0]


def quantize(desc_pm1: torch.Tensor, feat_valid: torch.Tensor,
             words_pm1: torch.Tensor):
    """Assign each descriptor to its nearest word; return (word_ids (N,)
    int32, bow (V,) L1-normalized tf vector)."""
    sim = desc_pm1.to(torch.float32) @ words_pm1.to(torch.float32).T
    wid = torch.argmax(sim, dim=1)
    V = words_pm1.shape[0]
    tf = torch.zeros(V, dtype=torch.float32, device=sim.device).index_add(
        0, wid, feat_valid.to(torch.float32))
    return wid.to(torch.int32), tf / torch.clamp(tf.sum(), min=1e-9)


def l1_score(bow_q: torch.Tensor, bow_db: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score, batched: (V,) query vs (Kmax,V) database -> (Kmax,)."""
    return torch.minimum(bow_q[None, :], bow_db).sum(dim=1)


class KeyFrameDatabase(NamedTuple):
    """Dense inverted index: per-KF tf vectors + word presence masks."""
    bow: torch.Tensor        # (Kmax, V) float32 L1-normalized tf
    has_word: torch.Tensor   # (Kmax, V) bool
    valid: torch.Tensor      # (Kmax,) bool


def empty_database(Kmax: int, V: int, device=None) -> KeyFrameDatabase:
    return KeyFrameDatabase(
        bow=torch.zeros((Kmax, V), dtype=torch.float32, device=device),
        has_word=torch.zeros((Kmax, V), dtype=torch.bool, device=device),
        valid=torch.zeros(Kmax, dtype=torch.bool, device=device),
    )


def _put(t: torch.Tensor, slot, value) -> torch.Tensor:
    out = t.clone()
    out[slot] = value
    return out


def add_keyframe(db: KeyFrameDatabase, slot, bow: torch.Tensor) -> KeyFrameDatabase:
    return KeyFrameDatabase(bow=_put(db.bow, slot, bow),
                            has_word=_put(db.has_word, slot, bow > 0),
                            valid=_put(db.valid, slot, True))


def erase_keyframe(db: KeyFrameDatabase, slot) -> KeyFrameDatabase:
    return KeyFrameDatabase(bow=_put(db.bow, slot, 0.0),
                            has_word=_put(db.has_word, slot, False),
                            valid=_put(db.valid, slot, False))


# --------------------------------------------------------------- hierarchical


class HierVocab(NamedTuple):
    """Two-level vocabulary: V = K1 * K2 words."""

    words1: torch.Tensor    # (K1,256) int8 coarse centroids
    words2: torch.Tensor    # (K1,K2,256) int8 fine words per cell
    weights: torch.Tensor   # (K1*K2,) float32 per-word idf (ORBvoc weights)

    @property
    def K1(self):
        return self.words1.shape[0]

    @property
    def K2(self):
        return self.words2.shape[1]

    @property
    def V(self):
        return self.K1 * self.words2.shape[1]


def train_hier_vocab(desc_pm1: torch.Tensor, K1: int = 64, K2: int = 64,
                     iters: int = 6, seed: int = 0) -> HierVocab:
    """Train a 2-level vocabulary by nested binary k-means (the offline
    DBoW2 build), on the descriptors' device."""
    dev = desc_pm1.device
    words1 = train_vocab(desc_pm1, K1, iters=iters, seed=seed)
    sim = desc_pm1.to(torch.float32) @ words1.to(torch.float32).T
    cell = torch.argmax(sim, dim=1).cpu().numpy()
    rng = np.random.default_rng(seed + 1)
    d_np = desc_pm1.cpu().numpy()
    w2 = []
    for c in range(K1):
        members = d_np[cell == c]
        if len(members) == 0:
            members = d_np[rng.integers(0, len(d_np), 8)]
        w2.append(train_vocab(torch.from_numpy(members).to(dev), K2,
                              iters=max(iters // 2, 2), seed=seed + 2 + c))
    return HierVocab(words1=words1, words2=torch.stack(w2),
                     weights=torch.ones(K1 * K2, dtype=torch.float32, device=dev))


def balanced_cells(sim: np.ndarray, K2: int) -> np.ndarray:
    """Capacity-constrained cell assignment: every row of `sim` (n, K1) gets
    a cell, no cell exceeds K2 members. Greedy rounds: each unplaced row
    goes to its best non-full cell; overfull cells keep their K2 closest
    rows and release the rest to the next round. Returns (n,) cell ids."""
    n, K1 = sim.shape
    if K1 * K2 < n:
        raise ValueError(f"capacity {K1}*{K2} < {n} leaves")
    cell = np.full(n, -1, np.int64)
    full = np.zeros(K1, bool)
    pending = np.arange(n)
    sim = sim.copy()
    while len(pending):
        pick = np.argmax(np.where(full[None, :], -np.inf, sim[pending]), axis=1)
        cell[pending] = pick
        nxt = []
        for c in np.unique(pick):
            mem = np.flatnonzero(cell == c)
            if len(mem) <= K2:
                continue
            # keep the K2 best-matching members, release the rest
            order = np.argsort(-sim[mem, c])
            drop = mem[order[K2:]]
            cell[drop] = -1
            full[c] = True
            nxt.append(drop)
        # cells exactly at capacity also stop accepting
        counts = np.bincount(cell[cell >= 0], minlength=K1)
        full |= counts >= K2
        pending = np.concatenate(nxt) if nxt else np.empty(0, np.int64)
    return cell


def load_vocab_text_hier(path: str, K1: int = 256,
                         max_words: int | None = None,
                         overflow: float = 1.25, device=None) -> HierVocab:
    """Import DBoW2 leaf words + their idf weights from ORBvoc.txt and
    re-shape them into the 2-level form: coarse k-means over the leaves,
    then balanced cell assignment with a fixed fine size
    K2 = ceil(overflow * V / K1). Word weights follow the file."""
    leaves_np, wts = _read_leaves(path, max_words)
    desc = torch.from_numpy(leaves_np).to(device)
    K1 = min(K1, len(leaves_np))
    words1 = train_vocab(desc, K1, iters=6)
    sim = (desc.to(torch.float32) @ words1.to(torch.float32).T).cpu().numpy()
    K2 = int(np.ceil(overflow * len(leaves_np) / K1))
    cell = balanced_cells(sim, K2)
    w2 = np.zeros((K1, K2, 256), np.int8)
    wt2 = np.zeros((K1, K2), np.float32)
    for c in range(K1):
        mem = np.flatnonzero(cell == c)
        w2[c, : len(mem)] = leaves_np[mem]
        wt2[c, : len(mem)] = wts[mem]
    return HierVocab(words1=words1, words2=torch.from_numpy(w2).to(device),
                     weights=torch.from_numpy(wt2.reshape(-1)).to(device))


def quantize_hier(desc_pm1: torch.Tensor, feat_valid: torch.Tensor,
                  voc: HierVocab):
    """(N,256) descriptors -> (word_ids (N,) int32 [-1 invalid],
    weights (N,) float32): two products, the coarse cell then the word."""
    df = desc_pm1.to(torch.float32)
    cell = torch.argmax(df @ voc.words1.to(torch.float32).T, dim=1)
    sub = voc.words2[cell].to(torch.float32)                     # (N,K2,256)
    fine = torch.argmax(torch.einsum("nc,nkc->nk", df, sub), dim=1)
    wid = (cell * voc.words2.shape[1] + fine).to(torch.int32)
    wid = torch.where(feat_valid, wid, -1)
    return wid, voc.weights[torch.clamp(wid, min=0).long()] * feat_valid


class SparseKeyFrameDatabase(NamedTuple):
    """Per-KF sparse tf-idf word lists (Kmax, Nw): the inverted index at
    real-vocabulary scale, one row of unique word ids (-1 = pad) per KF."""

    ids: torch.Tensor      # (Kmax, Nw) int32 word ids, -1 = pad
    w: torch.Tensor        # (Kmax, Nw) float32 L1-normalized tf-idf
    valid: torch.Tensor    # (Kmax,) bool


def empty_sparse_database(Kmax: int, Nw: int, device=None) -> SparseKeyFrameDatabase:
    return SparseKeyFrameDatabase(
        ids=torch.full((Kmax, Nw), -1, dtype=torch.int32, device=device),
        w=torch.zeros((Kmax, Nw), dtype=torch.float32, device=device),
        valid=torch.zeros(Kmax, dtype=torch.bool, device=device),
    )


def sparse_bow_row(word_ids: torch.Tensor, weights: torch.Tensor):
    """Aggregate per-feature words into a unique (ids, tf-idf) row: sort by
    id (stable), segment-sum equal ids into the first slot of each run,
    L1-normalize. Fixed shape (N,) with -1/0 padding."""
    ids, order = torch.sort(word_ids, stable=True)
    ws = weights[order]
    first = torch.ones_like(ids, dtype=torch.bool)
    first[1:] = ids[1:] != ids[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1           # run per entry
    agg = torch.zeros_like(ws).index_add(0, seg, ws)           # weight per run
    run_id = torch.full_like(ids, -(1 << 30)).scatter_reduce(
        0, seg, ids, reduce="amax", include_self=True)
    slot = torch.arange(ids.shape[0], device=ids.device)
    run_valid = (slot <= seg[-1]) & (run_id >= 0) & (agg > 0)
    out_ids = torch.where(run_valid, run_id, -1)
    out_w = torch.where(run_valid, agg, 0.0)
    return out_ids, out_w / torch.clamp(out_w.sum(), min=1e-9)


def sparse_add_keyframe(db: SparseKeyFrameDatabase, slot,
                        word_ids: torch.Tensor, weights: torch.Tensor):
    ids, w = sparse_bow_row(word_ids, weights)
    return SparseKeyFrameDatabase(ids=_put(db.ids, slot, ids),
                                  w=_put(db.w, slot, w),
                                  valid=_put(db.valid, slot, True))


def sparse_erase_keyframe(db: SparseKeyFrameDatabase, slot):
    return SparseKeyFrameDatabase(ids=_put(db.ids, slot, -1),
                                  w=_put(db.w, slot, 0.0),
                                  valid=_put(db.valid, slot, False))


def _sparse_overlap(db: SparseKeyFrameDatabase, q_ids, q_w):
    """Per-KF (common words (Kmax,), L1 score (Kmax,)) as one
    (Kmax, Nq, Nw) equality reduction."""
    eq = (q_ids[None, :, None] == db.ids[:, None, :]) & (q_ids >= 0)[None, :, None]
    mins = torch.minimum(q_w[None, :, None], db.w[:, None, :])
    return eq.any(dim=2).sum(dim=1), torch.where(eq, mins, 0.0).sum(dim=(1, 2))


def _gated_top_k(db_valid, exclude_mask, common, scores_l1, top_k,
                 min_common_frac):
    ok = db_valid & ~exclude_mask
    max_common = torch.max(torch.where(ok, common, 0))
    gate = ok & (common >= min_common_frac * max_common) & (common > 0)
    return _top_k_stable(torch.where(gate, scores_l1, -torch.inf), top_k)


def sparse_detect_candidates(
    db: SparseKeyFrameDatabase,
    q_ids: torch.Tensor,     # (Nw,) unique ids (-1 pad)
    q_w: torch.Tensor,       # (Nw,)
    exclude_mask: torch.Tensor,
    top_k: int = 3,
    min_common_frac: float = 0.8,
):
    """DetectNBestCandidates over the sparse index: common-word gate + L1
    score (sum of min weights on shared words). Returns (scores, slots)."""
    common, s = _sparse_overlap(db, q_ids, q_w)
    return _gated_top_k(db.valid, exclude_mask, common, s, top_k, min_common_frac)


def detect_candidates(
    db: KeyFrameDatabase,
    bow_q: torch.Tensor,
    exclude_mask: torch.Tensor,
    top_k: int = 3,
    min_common_frac: float = 0.8,
):
    """DetectNBestCandidates: count common words with each stored KF, gate
    at min_common_frac x the largest count, L1-score the survivors, return
    the top_k (scores, slots). ``exclude_mask`` (Kmax,) bool: KFs to skip
    (the query's covisibility group)."""
    common = (db.has_word & (bow_q > 0)[None, :]).sum(dim=1)
    return _gated_top_k(db.valid, exclude_mask, common, l1_score(bow_q, db.bow),
                        top_k, min_common_frac)


def all_scores(db: KeyFrameDatabase, bow_q: torch.Tensor) -> torch.Tensor:
    """(Kmax,) L1 similarity of the query against every stored KF (invalid
    slots -> -inf), for the minScore gate over the covisibility group."""
    return torch.where(db.valid, l1_score(bow_q, db.bow), -torch.inf)


def sparse_all_scores(db: SparseKeyFrameDatabase, q_ids: torch.Tensor,
                      q_w: torch.Tensor) -> torch.Tensor:
    """Sparse-index variant of ``all_scores``."""
    return torch.where(db.valid, _sparse_overlap(db, q_ids, q_w)[1], -torch.inf)
