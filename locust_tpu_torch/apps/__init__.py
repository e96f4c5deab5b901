"""The workload ladder beyond WordCount: tf-idf, the inverted index,
PageRank and the sample sort, single-device and on the mesh (port of
``locust_tpu/apps``)."""

from locust_tpu_torch.apps.inverted_index import (  # noqa: F401
    DistributedInvertedIndex,
    build_inverted_index,
    build_inverted_index_mesh,
)
from locust_tpu_torch.apps.pagerank import (  # noqa: F401
    DistributedPageRank,
    ShardedPageRank,
    pagerank,
)
from locust_tpu_torch.apps.sample_sort import DistributedSort, sort_strings  # noqa: F401
from locust_tpu_torch.apps.tfidf import (  # noqa: F401
    build_tfidf,
    term_doc_counts,
    term_doc_counts_stream,
)
