"""CyberML (the port of ``mmlspark_tpu.cyber``): AccessAnomaly's sparse ALS
on the device, complement sampling, and the per-tenant indexers and
scalers on the host."""
from .anomaly import AccessAnomaly, AccessAnomalyModel, ComplementAccessTransformer
from .feature import IdIndexer, IdIndexerModel, StandardScalarScaler, \
    StandardScalarScalerModel, LinearScalarScaler, LinearScalarScalerModel

__all__ = ["AccessAnomaly", "AccessAnomalyModel", "ComplementAccessTransformer",
           "IdIndexer", "IdIndexerModel", "StandardScalarScaler",
           "StandardScalarScalerModel", "LinearScalarScaler",
           "LinearScalarScalerModel"]
