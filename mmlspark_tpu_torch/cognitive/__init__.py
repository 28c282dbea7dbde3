"""Cognitive services (the port of ``mmlspark_tpu.cognitive``): the REST
service transformers and the Azure Search writer on the port's HTTP client
(host code), and streaming speech recognition with its acoustic model on
the device."""
from .base import CognitiveServicesBase
from .services import (TextSentiment, LanguageDetector, EntityDetector, NER,
                       PII, KeyPhraseExtractor, OCR, AnalyzeImage,
                       DescribeImage, TagImage, RecognizeText,
                       RecognizeDomainSpecificContent,
                       GenerateThumbnails, DetectFace, VerifyFaces,
                       GroupFaces, IdentifyFaces, FindSimilarFace,
                       DetectLastAnomaly, DetectAnomalies, Translate,
                       Transliterate, BreakSentence, Detect, AnalyzeLayout,
                       AnalyzeReceipts, AnalyzeBusinessCards, AnalyzeInvoices,
                       AnalyzeIDDocuments, SpeechToText, BingImageSearch)
from .search import AzureSearchWriter
from .speech import (SpeechToTextSDK, ConversationTranscription,
                     StreamingRecognizer, SpeechServingModel)

__all__ = ["CognitiveServicesBase", "TextSentiment", "LanguageDetector",
           "EntityDetector", "NER", "PII", "KeyPhraseExtractor", "OCR",
           "AnalyzeImage", "DescribeImage", "TagImage", "RecognizeText",
           "RecognizeDomainSpecificContent",
           "GenerateThumbnails", "DetectFace", "VerifyFaces", "GroupFaces",
           "IdentifyFaces", "FindSimilarFace", "DetectLastAnomaly",
           "DetectAnomalies", "Translate", "Transliterate", "BreakSentence",
           "Detect", "AnalyzeLayout", "AnalyzeReceipts",
           "AnalyzeBusinessCards", "AnalyzeInvoices", "AnalyzeIDDocuments",
           "SpeechToText", "BingImageSearch", "AzureSearchWriter",
           "SpeechToTextSDK", "ConversationTranscription",
           "StreamingRecognizer", "SpeechServingModel"]
