"""Bag-of-binary-words place recognition: vocabulary and TF-IDF database —
counterpart of ``zenslam_tpu/backend/bow.py``.

The vocabulary is a two-level k-means tree over unpacked descriptor bits
(branch B, B² leaf words) or a flat codebook; quantisation is two chained
Hamming products and argmins. The database is a dense (frames, words)
histogram matrix, so a query scores every stored frame with one product.

Randomness is injected: k-means takes its seed and re-seed row indices as
``KmeansDraws``, produced by a ``draw(level, weight, n_words, iters)``
callable (``level`` is "flat", "l1" or "l2"). ``GeneratorDraw`` makes one
from a seeded ``torch.Generator``, which a captured program seeds afresh
on every call; a test hands in the reference's draws.
All Hamming distances here are small integers, exact in f32, so quantisation
and centres do not depend on the order of the sums.

The public functions are captured programs (``utils/graphs.py``), as the
reference jits them (``build_vocabulary``, ``build_vocabulary_tree``,
``_bow_tree``/``_bow_flat``, ``bow_db_add``, ``bow_db_query``), with the
reference's static arguments and the ``draw`` static; the frame indices
and ``min_frame_gap`` are traced (Python ints go up as device scalars).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Union

import numpy as np
import torch

from zenslam_tpu_torch.backend.keyframes import _set_row
from zenslam_tpu_torch.ops.match import unpack_bits
from zenslam_tpu_torch.utils.device import resolve_device
from zenslam_tpu_torch.utils.graphs import Program


class Vocabulary(NamedTuple):
    """Two-level codebook (branch B -> B² leaf words) of unpacked float bits.
    Rows of ``l2`` under an empty level-1 cluster are all zero."""

    l1: torch.Tensor   # (B, 256) float {0,1}
    l2: torch.Tensor   # (B, B, 256) float {0,1}

    @property
    def n_words(self) -> int:
        return self.l1.shape[0] * self.l2.shape[1]


class KmeansDraws(NamedTuple):
    """Row indices drawn uniformly among the rows of positive weight (among
    all rows when none has weight), batched over leading dims."""

    seeds: torch.Tensor    # (..., n_words) initial centres
    reseeds: torch.Tensor  # (..., iters, n_words) re-seeds of empty clusters, per step


class GeneratorDraw:
    """A ``draw`` callable backed by a ``torch.Generator`` seeded by ``seed``
    on ``device``. Equal (and hashing alike) when seed and device are, so a
    captured program keys on the value; through a program
    (``utils/graphs.py``) every call draws from the generator seeded
    afresh (``seeded_generators``), as a new ``GeneratorDraw`` would. The
    builders' default (``draw=None``) is ``GeneratorDraw(0, device)``."""

    def __init__(self, seed: int, device):
        self.seed, self.device = int(seed), torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

    def _key(self) -> tuple:
        return self.seed, str(self.device)

    def __eq__(self, other) -> bool:
        return isinstance(other, GeneratorDraw) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def seeded_generators(self) -> list:
        return [(self.generator, self.seed)]

    def __call__(self, level: str, weight, n_words: int, iters: int) -> KmeansDraws:
        lead = weight.shape[:-1]
        w2 = weight.reshape(-1, weight.shape[-1])
        ok = w2 > 0
        probs = torch.where(ok.any(-1, keepdim=True), ok.to(torch.float32), 1.0)
        idx = torch.multinomial(probs, (iters + 1) * n_words, replacement=True,
                                generator=self.generator)
        idx = idx.reshape(lead + (iters + 1, n_words))
        return KmeansDraws(seeds=idx[..., 0, :], reseeds=idx[..., 1:, :])


def _hamming_to_centers(bits, centers):
    """(…, N, n) Hamming distances of bit rows (N, 256) to float centres
    (…, n, 256): sum |b - c| = b·(1 - 2c) + |c|."""
    return bits @ (1.0 - 2.0 * centers).transpose(-1, -2) + centers.sum(-1)[..., None, :]


def _kmeans_bits(bits, weight, n_words: int, iters: int, draws: KmeansDraws):
    """Weighted binary k-means over unpacked bit rows ``bits`` (N, 256),
    batched over the leading dims of ``weight`` (…, N) (0 excludes a row).
    Centres are bit-majority votes; empty clusters are re-seeded from the
    drawn rows; an all-zero weight gives all-zero centres."""
    has_any = (weight.sum(-1) > 0).to(bits.dtype)[..., None, None]
    centers = bits[draws.seeds] * has_any
    member = weight > 0
    words = torch.arange(n_words, device=bits.device)
    for it in range(iters):
        d = _hamming_to_centers(bits, centers)
        d = torch.where(member[..., None], d, float("inf"))
        a = torch.argmin(d, dim=-1)
        onehot = (a[..., None] == words).to(bits.dtype) * weight[..., None]
        counts = onehot.sum(-2)
        sums = onehot.transpose(-1, -2) @ bits
        mean = sums / torch.clamp(counts[..., None], min=1.0)
        new = (mean > 0.5).to(bits.dtype)
        centers = torch.where((counts > 0)[..., None], new,
                              bits[draws.reseeds[..., it, :]] * has_any)
    return centers


def _default_draw(device) -> GeneratorDraw:
    return GeneratorDraw(0, device)


@functools.partial(Program, static_argnames=("n_words", "iters", "draw"),
                   static_defaults={"draw": _default_draw}, copy_outputs=True)
def build_vocabulary(descriptors, valid, n_words: int = 256, iters: int = 8,
                     draw: Callable | None = None):
    """Flat binary k-means over packed (N, 8) descriptors; returns the
    (n_words, 256) float codebook."""
    bits = unpack_bits(descriptors)
    w = valid.to(torch.float32)
    draw = draw or _default_draw(bits.device)
    return _kmeans_bits(bits, w, n_words, iters, draw("flat", w, n_words, iters))


@functools.partial(Program, static_argnames=("branch", "iters", "draw"),
                   static_defaults={"draw": _default_draw}, copy_outputs=True)
def build_vocabulary_tree(descriptors, valid, branch: int = 64, iters: int = 6,
                          draw: Callable | None = None) -> Vocabulary:
    """Two-level hierarchical binary k-means (branch² leaf words): level 1
    clusters the corpus into ``branch`` cells, level 2 runs one masked
    k-means per cell, all cells at once."""
    bits = unpack_bits(descriptors)
    w = valid.to(torch.float32)
    draw = draw or _default_draw(bits.device)
    l1 = _kmeans_bits(bits, w, branch, iters, draw("l1", w, branch, iters))
    d = torch.where(valid[:, None], _hamming_to_centers(bits, l1), float("inf"))
    a1 = torch.argmin(d, dim=1)
    member = (a1[None, :] == torch.arange(branch, device=bits.device)[:, None]).to(w.dtype) \
        * w[None, :]                                               # (B, N)
    l2 = _kmeans_bits(bits, member, branch, iters, draw("l2", member, branch, iters))
    return Vocabulary(l1=l1, l2=l2)


def _quantize_tree(vocab: Vocabulary, bits):
    """(…, N, 256) bit rows -> word ids under the two-level tree: level-1
    argmin, then the argmin among that cell's children."""
    l1, l2 = vocab.l1, vocab.l2
    B = l1.shape[0]
    c1 = torch.argmin(_hamming_to_centers(bits, l1), dim=-1)              # (…, N)
    dots = bits @ l2.reshape(B * B, -1).T                                 # (…, N, B²)
    cols = c1[..., None] * B + torch.arange(B, device=bits.device)
    d2 = (l2.sum(-1)[c1] + bits.sum(-1)[..., None]
          - 2.0 * torch.gather(dots, -1, cols))                           # (…, N, B)
    c2 = torch.argmin(d2, dim=-1)
    return c1 * B + c2


def _histogram(word, valid, n_words: int):
    """L2-normalised word histogram (…, n_words) of valid rows."""
    lead = word.shape[:-1]
    flat = word.reshape(-1, word.shape[-1])
    offs = torch.arange(flat.shape[0], device=word.device)[:, None] * n_words
    hist = torch.zeros(flat.shape[0] * n_words, dtype=torch.float32, device=word.device)
    hist.index_add_(0, (flat + offs).reshape(-1), valid.reshape(-1).to(torch.float32))
    hist = hist.reshape(lead + (n_words,))
    norm = torch.sqrt((hist * hist).sum(-1, keepdim=True))
    return hist / torch.where(norm < 1e-9, 1.0, norm)


@functools.partial(Program, copy_outputs=True)
def descriptors_to_bow(codebook: Union[Vocabulary, torch.Tensor], descriptors, valid):
    """Packed descriptors (…, N, 8) -> L2-normalised word histograms
    (…, n_words), under a tree ``Vocabulary`` or a flat (n_words, 256)
    codebook."""
    bits = unpack_bits(descriptors)
    if isinstance(codebook, Vocabulary):
        return _histogram(_quantize_tree(codebook, bits), valid, codebook.n_words)
    word = torch.argmin(_hamming_to_centers(bits, codebook), dim=-1)
    return _histogram(word, valid, codebook.shape[0])


def save_vocabulary(path: str, vocab: Union[Vocabulary, torch.Tensor]) -> None:
    """Write a vocabulary as .npz, in the reference's layout (kind, l1, l2 or
    kind, codebook), so either package loads the other's file."""
    if isinstance(vocab, Vocabulary):
        np.savez(path, kind="tree", l1=vocab.l1.detach().cpu().numpy(),
                 l2=vocab.l2.detach().cpu().numpy())
    else:
        np.savez(path, kind="flat", codebook=vocab.detach().cpu().numpy())


def load_vocabulary(path: str, device=None) -> Union[Vocabulary, torch.Tensor]:
    """Read a vocabulary written by either package's ``save_vocabulary``
    onto ``device`` (default CUDA, raising when absent)."""
    from zenslam_tpu_torch.pipeline.state import resolve_device

    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as d:
        if str(d["kind"]) == "tree":
            return Vocabulary(l1=torch.as_tensor(d["l1"], dtype=torch.float32, device=dev),
                              l2=torch.as_tensor(d["l2"], dtype=torch.float32, device=dev))
        return torch.as_tensor(d["codebook"], dtype=torch.float32, device=dev)


class BowDatabase(NamedTuple):
    hist: torch.Tensor       # (F, n_words) L2-normalised histograms
    frame_idx: torch.Tensor  # (F,) int32 source frame (-1 empty)
    valid: torch.Tensor      # (F,) bool
    next_slot: torch.Tensor  # () int32 ring pointer
    doc_freq: torch.Tensor   # (n_words,) documents containing each word


def bow_db_init(max_frames: int, n_words: int, device=None) -> BowDatabase:
    """Empty BoW database on ``device`` (default CUDA, raising when absent)."""
    device = resolve_device(device)
    return BowDatabase(
        hist=torch.zeros((max_frames, n_words), dtype=torch.float32, device=device),
        frame_idx=torch.full((max_frames,), -1, dtype=torch.int32, device=device),
        valid=torch.zeros(max_frames, dtype=torch.bool, device=device),
        next_slot=torch.zeros((), dtype=torch.int32, device=device),
        doc_freq=torch.zeros(n_words, dtype=torch.float32, device=device))


@functools.partial(Program, scalar_argnames=("frame_idx",), copy_outputs=True)
def bow_db_add(db: BowDatabase, hist, frame_idx) -> BowDatabase:
    """Insert a histogram at the ring pointer, keeping document frequencies."""
    s = db.next_slot
    row = s.reshape(1).long()
    old = db.hist.index_select(0, row)[0]
    df = (db.doc_freq - (old > 0).to(torch.float32) * db.valid.index_select(0, row)[0]
          + (hist > 0).to(torch.float32))
    return db._replace(
        hist=_set_row(db.hist, s, hist), frame_idx=_set_row(db.frame_idx, s, frame_idx),
        valid=_set_row(db.valid, s, True),
        next_slot=((s + 1) % db.hist.shape[0]).to(torch.int32), doc_freq=df)


@functools.partial(Program, static_argnames=("top_k",),
                   scalar_argnames=("query_frame_idx", "min_frame_gap"), copy_outputs=True)
def bow_db_query(db: BowDatabase, hist, query_frame_idx, min_frame_gap: int = 30,
                 top_k: int = 5):
    """TF-IDF cosine query with temporal exclusion (frames within
    ``min_frame_gap`` of the query and empty slots score -1), sorted top-k;
    equal scores go to the lower slot, as the reference's top_k orders them.
    Returns (scores (k,), frame indices (k,), slots (k,))."""
    top_k = min(top_k, db.hist.shape[0])
    n_docs = torch.clamp(db.valid.sum(), min=1).to(torch.float32)
    idf = torch.log(torch.clamp(n_docs / torch.clamp(db.doc_freq, min=1.0), min=1.0))
    hq = hist * idf
    hq = hq / torch.clamp(torch.sqrt((hq * hq).sum()), min=1e-9)
    hd = db.hist * idf[None, :]
    hd = hd / torch.clamp(torch.sqrt((hd * hd).sum(1, keepdim=True)), min=1e-9)
    scores = hd @ hq
    excl = (~db.valid) | ((db.frame_idx - query_frame_idx).abs() < min_frame_gap)
    scores = torch.where(excl, -1.0, scores)
    top, slots = torch.sort(scores, descending=True, stable=True)
    slots = slots[:top_k]
    return top[:top_k], db.frame_idx[slots], slots
