"""Featurization (the port of ``mmlspark_tpu/featurize``): ``Featurize``
and its column stages and the text stages on the host (own copies), and
``Word2Vec``, trained on the card."""
from .featurize import (Featurize, CleanMissingData, CleanMissingDataModel,
                        ValueIndexer, ValueIndexerModel, IndexToValue,
                        CountSelector, CountSelectorModel, DataConversion,
                        assemble_vector_column)
from .text import TextFeaturizer, TextFeaturizerModel, MultiNGram, PageSplitter
from .word2vec import Word2Vec, Word2VecModel

__all__ = ["Featurize", "CleanMissingData", "CleanMissingDataModel",
           "ValueIndexer", "ValueIndexerModel", "IndexToValue",
           "CountSelector", "CountSelectorModel", "DataConversion",
           "assemble_vector_column", "TextFeaturizer", "TextFeaturizerModel",
           "Word2Vec", "Word2VecModel",
           "MultiNGram", "PageSplitter"]
