"""The port's embedding tools (``fiude_tpu_torch.data.embedding``) against
the JAX package's (``fiude_tpu/data/embedding.py``), on the CPU, with a
pluggable hash ``embed_fn`` and a small vector table (no vectors are
downloaded):

* ``WordEmbeddings.load`` reads the reference's schema (a headerless vector
  CSV written by pandas, ``vocabulary.txt``) to the same query embeddings,
  unknown words counting as zero vectors, a word listed twice raising when
  a query uses it;
* ``similarity_score`` and ``build_similarity_scores`` give the same scores,
  and the ``Similarity_Scores.csv`` written is the JAX file byte for byte;
* ``select_queries`` gives the JAX names in order under both rules, and an
  unknown rule raises.
"""
import filecmp
import zlib

import numpy as np
import pandas as pd
import pytest

from fiude_tpu.data import embedding as jax_embedding

from fiude_tpu_torch.data import embedding
from fiude_tpu_torch.data.tables import Frame

VOCAB = ["flu", "fever", "medicine", "gp", "hospital", "bieber", "ebola", "wikipedia",
         "cough", "cold", "symptoms", "vaccine"]
QUERIES = ["flu symptoms", "fever medicine", "bieber tickets", "cough and cold",
           "ebola outbreak news", "vaccine", "gp hospital flu, fever"]


def hash_embed(word_or_phrase: str) -> np.ndarray:
    """A deterministic 16-d embedding: each word's vector from its CRC, the
    phrase's the mean."""
    vecs = [np.random.default_rng(zlib.crc32(w.encode())).standard_normal(16)
            for w in word_or_phrase.split(" ")]
    return np.mean(vecs, axis=0)


@pytest.fixture(scope="module")
def vec_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vectors")
    d = root / "vectors_unzipped"
    d.mkdir()
    vectors = np.random.default_rng(0).standard_normal((len(VOCAB), 16))
    pd.DataFrame(vectors).to_csv(d / "Twitter_word_embeddings_CBOW.csv", header=False,
                                 index=False)
    (d / "vocabulary.txt").write_text("\n".join(VOCAB) + "\n")
    return str(root)


def test_a_word_listed_twice_raises_where_jax_does(tmp_path):
    d = tmp_path / "vectors_unzipped"
    d.mkdir()
    pd.DataFrame(np.eye(3)).to_csv(d / "Twitter_word_embeddings_CBOW.csv", header=False,
                                   index=False)
    (d / "vocabulary.txt").write_text("flu\ncold\nflu\n")
    got = embedding.WordEmbeddings.load(str(tmp_path))
    want = jax_embedding.WordEmbeddings.load(str(tmp_path))
    assert np.array_equal(got("cold fever"), want("cold fever"))
    with pytest.raises(ValueError):
        want("flu cold")
    with pytest.raises(ValueError, match="listed twice"):
        got("flu cold")


def test_word_embeddings_equal_jax(vec_root):
    got = embedding.WordEmbeddings.load(vec_root)
    want = jax_embedding.WordEmbeddings.load(vec_root)
    assert got.dim == want.dim == 16
    for q in QUERIES[:-1] + ["unknown words only", "cold"]:
        assert np.array_equal(got(q), want(q)), q


def test_similarity_score_equals_jax():
    pos = np.asarray([hash_embed(p) for p in embedding.POSITIVE_ANCHORS])
    neg = np.asarray([hash_embed(n) for n in embedding.NEGATIVE_ANCHORS])
    assert embedding.POSITIVE_ANCHORS == jax_embedding.POSITIVE_ANCHORS
    assert embedding.NEGATIVE_ANCHORS == jax_embedding.NEGATIVE_ANCHORS
    for q in QUERIES:
        for gamma in (0.001, 0.5):
            assert (embedding.similarity_score(hash_embed(q), pos, neg, gamma)
                    == jax_embedding.similarity_score(hash_embed(q), pos, neg, gamma))


@pytest.mark.parametrize("source", ["hash", "vectors"])
def test_similarity_scores_csv_is_the_jax_file(tmp_path, vec_root, source):
    embed = hash_embed if source == "hash" else embedding.WordEmbeddings.load(vec_root)
    jax_embed = hash_embed if source == "hash" else jax_embedding.WordEmbeddings.load(vec_root)
    ours, theirs = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    got = embedding.build_similarity_scores(iter(QUERIES), embed, out_csv=ours)
    want = jax_embedding.build_similarity_scores(QUERIES, jax_embed, out_csv=theirs)
    assert list(got.index) == list(want.index) and got.columns == ("similarity",)
    assert np.array_equal(got.values[:, 0], want["similarity"].to_numpy(float))
    assert filecmp.cmp(ours, theirs, shallow=False)


def score_table():
    rng = np.random.default_rng(4)
    names = [f"q{i}" for i in range(12)]
    sim, corr = rng.uniform(0.5, 4.0, 12), rng.uniform(0.2, 1.0, 12)
    sim[3], corr[3] = sim[7], corr[7]                         # a tie
    corr[5] = np.nan
    frame = pd.DataFrame({"similarity": sim, "correlation": corr}, index=names)
    return Frame(np.array(names, dtype=object), ("similarity", "correlation"),
                 np.column_stack([sim, corr])), frame


@pytest.mark.parametrize("n_queries", [5, 100])
def test_select_queries_distance_equals_jax(n_queries):
    ours, theirs = score_table()
    want = list(jax_embedding.select_queries(theirs, method="distance", n_queries=n_queries))
    assert embedding.select_queries(ours, method="distance", n_queries=n_queries) == want


@pytest.mark.parametrize("thresholds", [(2.5, 0.9), (1.0, 0.5)])
def test_select_queries_bill_equals_jax(thresholds):
    ours, theirs = score_table()
    kw = dict(similarity_threshold=thresholds[0], correlation_threshold=thresholds[1])
    want = list(jax_embedding.select_queries(theirs, method="Bill", **kw))
    assert embedding.select_queries(ours, method="Bill", **kw) == want


def test_unknown_selection_rule_raises():
    ours, _ = score_table()
    with pytest.raises(ValueError, match="selection method"):
        embedding.select_queries(ours, method="nope")
