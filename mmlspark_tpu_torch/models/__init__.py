"""Model artifacts of the port: the GBDT booster, the ResNet family and the
model runner's batch front.  ``models/bilstm.py`` and
``models/transformer.py`` are not ported yet (ROADMAP.md §1 item 8); the
runner's decode/serving names raise (item 9)."""
from .gbdt import GBDTBooster
from .resnet import ResNet, resnet18, resnet34, resnet50, resnet101
from .runner import (ModelRunner, DecodeResult, PagePool,
                     ContinuousDecoder, StreamHandle, PagePoolExhausted,
                     SlotsExhausted, ShedReply, bucket_rows)

__all__ = ["GBDTBooster", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "ModelRunner", "DecodeResult", "PagePool",
           "ContinuousDecoder", "StreamHandle", "PagePoolExhausted",
           "SlotsExhausted", "ShedReply", "bucket_rows"]
