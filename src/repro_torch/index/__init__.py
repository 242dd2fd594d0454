"""Corpus synthesis, the inverted/direct index, weighting models, retrieval."""
from repro_torch.index.corpus import (Corpus, Topics, expand_topics,  # noqa: F401
                                      synthesize_corpus, synthesize_topics)
from repro_torch.index.inverted import (InvertedIndex, build_index,  # noqa: F401
                                        gather_postings, index_from_arrays)
