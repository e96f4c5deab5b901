"""The workload ladder beyond WordCount, single-device: tf-idf, the
inverted index and PageRank (port of ``locust_tpu/apps``; the mesh
variants and the sample sort wait for the port's mesh tier)."""

from locust_tpu_torch.apps.inverted_index import build_inverted_index  # noqa: F401
from locust_tpu_torch.apps.pagerank import pagerank  # noqa: F401
from locust_tpu_torch.apps.tfidf import (  # noqa: F401
    build_tfidf,
    term_doc_counts,
    term_doc_counts_stream,
)
