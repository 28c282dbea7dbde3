"""Model artifacts of the port: the GBDT booster, the ResNet family, the
BiLSTM tagger, the transformer encoder and the model runner (its batch
front and its batched decode; the continuous/serving names raise, ROADMAP.md
§1 item 9)."""
from .gbdt import GBDTBooster
from .resnet import ResNet, resnet18, resnet34, resnet50, resnet101
from .bilstm import BiLSTMTagger, LSTMLayer
from .transformer import TransformerEncoder, EncoderBlock, MultiHeadAttention
from .runner import (ModelRunner, DecodeResult, PagePool,
                     ContinuousDecoder, StreamHandle, PagePoolExhausted,
                     SlotsExhausted, ShedReply, bucket_rows)

__all__ = ["GBDTBooster", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "BiLSTMTagger", "LSTMLayer", "TransformerEncoder",
           "EncoderBlock", "MultiHeadAttention", "ModelRunner",
           "DecodeResult", "PagePool", "ContinuousDecoder", "StreamHandle",
           "PagePoolExhausted", "SlotsExhausted", "ShedReply", "bucket_rows"]
