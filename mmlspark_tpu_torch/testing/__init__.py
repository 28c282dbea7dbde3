from .fuzzing import TestObject, ExperimentFuzzing, SerializationFuzzing, \
    assert_frames_equal
from .benchmarks import Benchmarks, Benchmark
from .chaos import (ChaosInjector, ConnectionErrorInjector, FakeClock,
                    LatencyInjector, StatusStormInjector, WorkerKiller)

__all__ = ["TestObject", "ExperimentFuzzing", "SerializationFuzzing",
           "assert_frames_equal", "Benchmarks", "Benchmark",
           "ChaosInjector", "LatencyInjector", "ConnectionErrorInjector",
           "StatusStormInjector", "WorkerKiller", "FakeClock"]
