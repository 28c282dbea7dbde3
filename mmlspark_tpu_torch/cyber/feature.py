"""CyberML feature utilities — partitioned indexers and scalers.

An own copy of the JAX package's ``cyber/feature.py``, verbatim apart from
module paths.

Reference: ``core/src/main/python/mmlspark/cyber/feature/indexers.py`` and
``scalers.py``: per-tenant id indexing and per-tenant score scaling.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core import DataFrame, Estimator, HasInputCol, HasOutputCol, Model, Param


class _PerTenantBase:
    tenant_col = Param("tenant_col", "partition/tenant column", "string", default="tenant")


class IdIndexer(Estimator, HasInputCol, HasOutputCol):
    """Per-tenant contiguous id assignment (1-based, reference indexers)."""
    tenant_col = Param("tenant_col", "tenant column", "string", default="tenant")
    reset_per_partition = Param("reset_per_partition", "restart ids per tenant",
                                "bool", default=True)

    def _fit(self, df):
        data = df.collect()
        tc, ic = self.get("tenant_col"), self.get_or_fail("input_col")
        mapping: Dict[str, Dict[str, int]] = {}
        per_tenant = self.get("reset_per_partition")
        for i in range(len(data[ic])):
            tenant = str(data[tc][i]) if tc in data and per_tenant else "_"
            sub = mapping.setdefault(tenant, {})
            key = str(data[ic][i])
            if key not in sub:
                sub[key] = len(sub) + 1
        m = IdIndexerModel()
        m.set("input_col", ic)
        m.set("output_col", self.get_or_fail("output_col"))
        m.set("tenant_col", tc)
        m.set("mapping", mapping)
        return m


class IdIndexerModel(Model, HasInputCol, HasOutputCol):
    tenant_col = Param("tenant_col", "tenant column", "string", default="tenant")
    mapping = Param("mapping", "tenant -> value -> id", "object")

    def _transform(self, df):
        mapping = self.get_or_fail("mapping")
        tc, ic = self.get("tenant_col"), self.get_or_fail("input_col")

        def per_part(p):
            out = np.zeros(len(p[ic]), np.float64)
            for i in range(len(out)):
                tenant = str(p[tc][i]) if tc in p else "_"
                sub = mapping.get(tenant) or mapping.get("_", {})
                out[i] = sub.get(str(p[ic][i]), 0)
            return {**p, self.get_or_fail("output_col"): out}

        return df.map_partitions(per_part)


class StandardScalarScaler(Estimator, HasInputCol, HasOutputCol):
    """Per-tenant z-scaling (reference scalers.py StandardScalarScaler)."""
    tenant_col = Param("tenant_col", "tenant column", "string", default="tenant")
    coefficient_factor = Param("coefficient_factor", "std multiplier", "float", default=1.0)

    def _fit(self, df):
        data = df.collect()
        tc, ic = self.get("tenant_col"), self.get_or_fail("input_col")
        stats: Dict[str, tuple] = {}
        tenants = data[tc].astype(str) if tc in data else np.full(len(data[ic]), "_")
        vals = np.asarray(data[ic], np.float64)
        for t in set(tenants.tolist()):
            v = vals[tenants == t]
            stats[t] = (float(v.mean()), float(v.std()) or 1.0)
        m = StandardScalarScalerModel()
        m.set("input_col", ic)
        m.set("output_col", self.get_or_fail("output_col"))
        m.set("tenant_col", tc)
        m.set("stats", stats)
        m.set("coefficient_factor", self.get("coefficient_factor"))
        return m


class StandardScalarScalerModel(Model, HasInputCol, HasOutputCol):
    tenant_col = Param("tenant_col", "tenant column", "string", default="tenant")
    stats = Param("stats", "tenant -> (mean, std)", "object")
    coefficient_factor = Param("coefficient_factor", "std multiplier", "float", default=1.0)

    def _transform(self, df):
        stats = self.get_or_fail("stats")
        cf = self.get("coefficient_factor")
        tc, ic = self.get("tenant_col"), self.get_or_fail("input_col")

        def per_part(p):
            out = np.zeros(len(p[ic]), np.float64)
            for i in range(len(out)):
                t = str(p[tc][i]) if tc in p else "_"
                mu, sd = stats.get(t, (0.0, 1.0))
                out[i] = cf * (float(p[ic][i]) - mu) / sd
            return {**p, self.get_or_fail("output_col"): out}

        return df.map_partitions(per_part)


class LinearScalarScaler(Estimator, HasInputCol, HasOutputCol):
    """Per-tenant min-max scaling to [min_value, max_value]."""
    tenant_col = Param("tenant_col", "tenant column", "string", default="tenant")
    min_required_value = Param("min_required_value", "output min", "float", default=0.0)
    max_required_value = Param("max_required_value", "output max", "float", default=1.0)

    def _fit(self, df):
        data = df.collect()
        tc, ic = self.get("tenant_col"), self.get_or_fail("input_col")
        tenants = data[tc].astype(str) if tc in data else np.full(len(data[ic]), "_")
        vals = np.asarray(data[ic], np.float64)
        rng: Dict[str, tuple] = {}
        for t in set(tenants.tolist()):
            v = vals[tenants == t]
            rng[t] = (float(v.min()), float(v.max()))
        m = LinearScalarScalerModel()
        m.set("input_col", ic)
        m.set("output_col", self.get_or_fail("output_col"))
        m.set("tenant_col", tc)
        m.set("ranges", rng)
        m.set("min_required_value", self.get("min_required_value"))
        m.set("max_required_value", self.get("max_required_value"))
        return m


class LinearScalarScalerModel(Model, HasInputCol, HasOutputCol):
    tenant_col = Param("tenant_col", "tenant column", "string", default="tenant")
    ranges = Param("ranges", "tenant -> (min, max)", "object")
    min_required_value = Param("min_required_value", "output min", "float", default=0.0)
    max_required_value = Param("max_required_value", "output max", "float", default=1.0)

    def _transform(self, df):
        ranges = self.get_or_fail("ranges")
        lo, hi = self.get("min_required_value"), self.get("max_required_value")
        tc, ic = self.get("tenant_col"), self.get_or_fail("input_col")

        def per_part(p):
            out = np.zeros(len(p[ic]), np.float64)
            for i in range(len(out)):
                t = str(p[tc][i]) if tc in p else "_"
                vmin, vmax = ranges.get(t, (0.0, 1.0))
                span = (vmax - vmin) or 1.0
                out[i] = lo + (float(p[ic][i]) - vmin) / span * (hi - lo)
            return {**p, self.get_or_fail("output_col"): out}

        return df.map_partitions(per_part)
