"""Embedding-based semantic query scoring: the tools that *produce*
``Similarity_Scores.csv`` (the data pipelines only read it).

Counterpart of ``fiude_tpu/data/embedding.py:37-131`` (reference legacy
scorer ``lib/Old/Data_Constructor.py:125-192``) with numpy and
:mod:`fiude_tpu_torch.data.tables` where the JAX package uses pandas:

* a query phrase is embedded as the mean of its word vectors, unknown words
  counting as zero vectors (``query_to_embedding``, ``:125-142``);
* its similarity score is the ratio of summed shifted-cosine similarities to
  positive anchor phrases ("flu", "fever", ...) over negative anchors
  ("bieber", "ebola", "wikipedia") plus a smoothing ``gamma``
  (``similarity_score``, ``:144-154``);
* :func:`build_similarity_scores` writes the scores as pandas' ``to_csv``
  writes the JAX package's table, byte for byte: the file that
  :func:`~fiude_tpu_torch.data.legacy.load_legacy_queries` and the regional
  :func:`~fiude_tpu_torch.data.builder.choose_qs` read;
* query selection combines the similarity score with the correlation to the
  ILI signal, by the ``'distance'`` rule (L2 distance of each column's share
  of its max from 1, ascending, numpy's default sort) or the
  ``'Bill'`` rule (both above their thresholds) (``query_selection``,
  ``:156-192``).

The embedding source is pluggable: :class:`WordEmbeddings` reads the
reference's on-disk schema (a headerless vector CSV and a newline-delimited
vocabulary, ``:127-132``), but any ``embed_fn: str -> np.ndarray`` works,
e.g. a learned encoder or a hash embedding for tests.  No vectors are
downloaded.
"""

from __future__ import annotations

import csv
import os
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np

from fiude_tpu_torch.data.tables import Frame, floats_of, nanmax, write_columns

#: anchor phrases from the reference (lib/Old/Data_Constructor.py:144-145)
POSITIVE_ANCHORS = ("flu", "fever", "flu", "flu medicine", "gp", "hospital")
NEGATIVE_ANCHORS = ("bieber", "ebola", "wikipedia")


class WordEmbeddings:
    """Word-vector table with the reference's on-disk schema: a headerless
    CSV of vectors row-aligned with a newline-delimited ``vocabulary.txt``
    (reference ``lib/Old/Data_Constructor.py:127-132``).  A query that uses a
    word the vocabulary lists twice raises ``ValueError``, as the JAX class
    does (pandas then gives it two rows)."""

    def __init__(self, vocab: Sequence[str], vectors: np.ndarray):
        vectors = np.asarray(vectors, dtype=float)
        if len(vocab) != vectors.shape[0]:
            raise ValueError(f"{len(vocab)} words for {vectors.shape[0]} vectors")
        self.vocab = list(vocab)
        self.vectors = vectors
        self.dim = vectors.shape[1]
        self._row = {}
        for i, word in enumerate(self.vocab):
            self._row[word] = None if word in self._row else i

    @classmethod
    def load(cls, root: str,
             vectors_file: str = "vectors_unzipped/Twitter_word_embeddings_CBOW.csv",
             vocab_file: str = "vectors_unzipped/vocabulary.txt",
             ) -> "WordEmbeddings":
        path = os.path.join(root, vectors_file)
        with open(path, newline="") as fh:
            rows = list(csv.reader(fh))
        columns = list(zip(*rows)) if rows else []
        vectors = np.stack([floats_of(c, f"{path}, column {j}") for j, c in enumerate(columns)],
                           axis=1) if columns else np.empty((0, 0))
        with open(os.path.join(root, vocab_file)) as fh:
            vocab = fh.read().split("\n")[:-1]
        return cls(vocab, vectors)

    def __call__(self, query: str) -> np.ndarray:
        """Mean of word vectors; out-of-vocabulary words are zero vectors
        (so they dilute, not skip: reference ``:134-141``)."""
        rows = []
        for w in query.split(" "):
            if w not in self._row:
                rows.append(np.zeros(self.dim))
            elif self._row[w] is None:
                raise ValueError(f"{w!r} is listed twice in the vocabulary")
            else:
                rows.append(self.vectors[self._row[w]])
        return np.mean(np.asarray(rows), axis=0)


def _cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise cosine similarity of ``a (D,)`` against ``b (N, D)``."""
    denom = np.linalg.norm(a) * np.linalg.norm(b, axis=1)
    return (b @ a) / np.maximum(denom, 1e-12)


def similarity_score(embedding: np.ndarray,
                     pos_embeddings: np.ndarray,
                     neg_embeddings: np.ndarray,
                     gamma: float = 0.001) -> float:
    """Shifted-cosine anchor ratio (reference ``:144-154``): each cosine is
    mapped to [0, 1] via ``(c+1)/2`` and summed per anchor set; the score is
    ``pos_sum / (neg_sum + gamma)``."""
    pos = ((_cosine(embedding, pos_embeddings) + 1.0) / 2.0).sum()
    neg = ((_cosine(embedding, neg_embeddings) + 1.0) / 2.0).sum() + gamma
    return float(pos / neg)


def build_similarity_scores(
    queries: Iterable[str],
    embed_fn: Callable[[str], np.ndarray],
    *,
    pos: Sequence[str] = POSITIVE_ANCHORS,
    neg: Sequence[str] = NEGATIVE_ANCHORS,
    gamma: float = 0.001,
    out_csv: Optional[str] = None,
) -> Frame:
    """Score every query phrase: a table indexed by the queries with one
    column ``similarity``; with ``out_csv``, also written in the schema the
    pipelines read (an unnamed index column of queries, then
    ``similarity``: reference ``:159,166-168``)."""
    queries = list(queries)
    pos_emb = np.asarray([embed_fn(p) for p in pos])
    neg_emb = np.asarray([embed_fn(n) for n in neg])
    scores = np.array([similarity_score(np.asarray(embed_fn(q)), pos_emb, neg_emb, gamma=gamma)
                       for q in queries], dtype=float)
    if out_csv:
        write_columns(out_csv, ["", "similarity"], [queries, scores])
    return Frame(np.array(queries, dtype=object), ("similarity",), scores[:, None])


def select_queries(scores: Frame, *, method: str = "distance",
                   n_queries: int = 100,
                   similarity_threshold: float = 2.5,
                   correlation_threshold: float = 0.9) -> List[str]:
    """Legacy selection rules over a (similarity, correlation) score table
    (reference ``:184-192``): the selected query names, in order.

    ``'distance'``: each column divided by its max (NaN skipped), the rows
    ranked by the L2 norm of ``1 - share`` (NaN counting 0) ascending, the
    top ``n_queries`` kept.  ``'Bill'``: the queries above both thresholds,
    in the table's order.
    """
    names = [str(q) for q in scores.index]
    if method == "distance":
        v = scores.values
        sq = np.square(1.0 - v / np.tile(nanmax(v, axis=0), (v.shape[0], 1)))
        sq = np.where(np.isnan(sq), 0.0, sq)   # pandas' row sum: NaN as 0, left to right
        total = sq[:, 0]
        for j in range(1, sq.shape[1]):
            total = total + sq[:, j]
        order = np.argsort(np.sqrt(total))
        return [names[i] for i in order][:n_queries]
    if method == "Bill":
        keep = ((scores.column("similarity") > similarity_threshold)
                & (scores.column("correlation") > correlation_threshold))
        return [q for q, k in zip(names, keep) if k]
    raise ValueError(f"unknown selection method {method!r}; "
                     "options: 'distance', 'Bill'")
